"""Explicit-allreduce data parallelism (counterpart of ``ray_lightning_tpu/strategies/allreduce.py``).

The reference's ``HorovodRayStrategy`` (``ray_lightning/ray_horovod.py:
32-183``) averages gradients explicitly, where Horovod's
``DistributedOptimizer`` all-reduces them, rather than through DDP's
backward hooks; the JAX package runs a per-rank step under ``shard_map``
and ``pmean``\\ s the gradients. Here there is no wrapper: after
``backward`` the gradients of each dtype are flattened into one buffer,
summed with one ``all_reduce`` and divided by the world size (gloo has
no average), and copied back. The same updates as :class:`RayStrategy`.
Each rank's step generator is drawn from the shared one with the rank
folded in (the JAX step's ``fold_in(rng, rank)``), so e.g. dropout masks
differ across ranks. Batch statistics are each rank's own (the JAX
step's per-rank ``model.apply``), and after every step the floating
buffers are averaged over ranks the same way, in one all-reduce (the
JAX step's ``pmean`` of ``model_state``).
"""
from __future__ import annotations

from collections import defaultdict
from typing import List

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ray_lightning_tpu_torch.strategies.base import Strategy


class HorovodRayStrategy(Strategy):
    """Data parallelism with an explicit, coalesced gradient all-reduce."""
    strategy_name = "horovod_ray"
    global_batch_stats = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.extra_kwargs:
            raise TypeError(f"{type(self).__name__} got unexpected keyword "
                            f"arguments {sorted(self.extra_kwargs)}")

    def sync_gradients(self, params: List[torch.Tensor]) -> None:
        if not self.in_world:
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._average([p.grad for p in params])

    def sync_buffers(self, buffers: List[torch.Tensor]) -> None:
        if self.in_world and buffers:
            self._average(buffers)

    def _average(self, tensors: List[torch.Tensor]) -> None:
        """Each tensor replaced by its mean over ranks: those of one
        dtype and device flattened into one buffer, one all-reduce."""
        groups = defaultdict(list)
        for t in tensors:
            groups[(t.dtype, t.device)].append(t)
        with torch.no_grad():
            for ts in groups.values():
                flat = _flatten_dense_tensors(ts)
                dist.all_reduce(flat)
                flat /= self.world_size
                for t, avg in zip(ts, _unflatten_dense_tensors(flat, ts)):
                    t.copy_(avg)

    def step_generator(self, generator: torch.Generator) -> torch.Generator:
        """One draw from the shared generator (the same on every rank, and
        what a checkpoint resumes), with this rank folded in."""
        if not self.in_world:
            return generator
        draw = int(torch.randint(0, 2**62, (1,), generator=generator))
        seed = np.random.SeedSequence([draw, self.global_rank]) \
            .generate_state(1, np.uint64)[0] >> np.uint64(1)
        return torch.Generator().manual_seed(int(seed))

    def join(self) -> None:
        """Wait for every rank (the reference's ``hvd.join()``,
        ``ray_horovod.py:143-151``)."""
        if self.in_world:
            dist.barrier()


AllReduceStrategy = HorovodRayStrategy
