"""The data-parallel strategy (counterpart of ``ray_lightning_tpu/strategies/ddp.py``).

The reference's flagship (``ray_lightning/ray_ddp.py:30-343``): each
worker process owns one device and its rows of the global batch, and the
model is wrapped in ``DistributedDataParallel``, whose backward hooks
average the gradients over ranks (NCCL on the cards, gloo on the CPU).
The JAX package reaches the same step with a replicated ``dp`` mesh in
one process. ``RayStrategy(num_workers=1)`` (with ``use_ray`` unset)
trains in this process with no wrapper.

Buffers: the port's BatchNorm computes the global batch's statistics
under this strategy (``Strategy.bind_batch_stats``), so every rank moves
its running statistics alike, as the JAX step does. DDP's default
``broadcast_buffers=True`` would overwrite every rank's buffers with rank
0's before each forward: with equal buffers a collective for nothing,
and under per-rank statistics a silent change of the result. The
wrapper is therefore built without that forward sync
(``broadcast_buffers=False``, or ``forward_sync_buffers=False`` where
the installed PyTorch has deprecated the first) unless the caller
passes either.
"""
from __future__ import annotations

import inspect

import torch

from ray_lightning_tpu_torch.core.train_state import bare_model
from ray_lightning_tpu_torch.strategies.base import Strategy


class RayStrategy(Strategy):
    """Drop-in data-parallel strategy: ``num_workers`` processes, one
    device each. Extra keyword arguments (e.g.
    ``find_unused_parameters``) go to ``DistributedDataParallel``."""
    strategy_name = "ddp_ray"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        allowed = inspect.signature(
            torch.nn.parallel.DistributedDataParallel.__init__).parameters
        bad = sorted(set(self.extra_kwargs) - set(allowed)
                     - {"self", "module", "device_ids"})
        if bad:
            raise TypeError(
                f"{type(self).__name__} got keyword arguments that "
                f"DistributedDataParallel does not take: {bad}")
        self._ddp_kwargs = dict(self.extra_kwargs)
        if not {"broadcast_buffers",
                "forward_sync_buffers"} & set(self._ddp_kwargs):
            self._ddp_kwargs["forward_sync_buffers"
                             if "forward_sync_buffers" in allowed
                             else "broadcast_buffers"] = False

    def wrap_model(self, model: torch.nn.Module) -> torch.nn.Module:
        if not self.in_world:
            return model
        device = self.root_device
        return torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None, **self._ddp_kwargs)

    def unwrap(self, model: torch.nn.Module) -> torch.nn.Module:
        return bare_model(model)


# the name that says what it does
DataParallelStrategy = RayStrategy
