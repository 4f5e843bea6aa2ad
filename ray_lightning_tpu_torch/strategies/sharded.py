"""ZeRO-1 data parallelism (counterpart of ``ray_lightning_tpu/strategies/sharded.py``).

The reference's ``RayShardedStrategy`` (``ray_lightning/ray_ddp_sharded.
py:12-13``) mixes FairScale's optimizer-state sharding into DDP; the JAX
package shards every optimizer-state array along its largest dimension
that the data-parallel size divides. Here: DDP as :class:`RayStrategy`
(the gradients all-reduced and averaged), then :class:`ZeroOptimizer`:
each rank updates its slice of every param along the JAX rule's
dimension (:func:`~ray_lightning_tpu_torch.strategies.sharding.shard_dim`)
with the optimizer the factory builds, keeping only that slice's
optimizer state, and the slices are all-gathered back into the params. A
param that no dimension splits is updated whole on every rank. So
``opt_state_bytes`` on each rank is the bytes of its shards by the JAX
rule. Every optimizer runs on the shards: ``torch.optim`` ones through
DTensor, the hand-written presets (``adamw_bf16m``, ``adafactor``) on
their local parts, with adafactor's means over a split dimension summed
over the group (``core/optim.py``). A checkpoint all-gathers the state
into the one-process layout, so it loads at any world size.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ray_lightning_tpu_torch.core.train_state import TrainState
from ray_lightning_tpu_torch.strategies.ddp import RayStrategy
from ray_lightning_tpu_torch.strategies.sharding import (full_state,
                                                         load_sharded_state,
                                                         shard_dim)


def _shard(t: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` as a DTensor (a view of
    ``t``'s storage: writing it writes ``t``); ``dim`` None: ``t`` whole,
    replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    t = t.detach()
    if dim is None:
        local, placement = t, Replicate()
    else:
        n = t.shape[dim] // mesh.size()
        local = t.narrow(dim, mesh.get_local_rank() * n, n)
        placement = Shard(dim)
    return DTensor.from_local(local, mesh, [placement], run_check=False,
                              shape=t.shape, stride=t.stride())


class ZeroOptimizer(torch.optim.Optimizer):
    """The optimizer ``factory`` builds, run on this rank's shards of the
    params (:attr:`shard_params`, DTensors on ``mesh``), behind the full
    params' param groups. :meth:`step` hands each shard its slice of the
    full (averaged) gradient, steps the inner optimizer, and all-gathers
    the updated slices into the full params, one collective per dtype.
    Hyperparameters written into :attr:`param_groups` (a schedule's
    learning rate) reach the inner optimizer at each step. With one rank
    (``mesh`` None) the inner optimizer runs on the params themselves.
    """

    def __init__(self, params, factory: Callable, mesh=None):
        params = list(params)
        self.mesh = mesh
        world = 1 if mesh is None else mesh.size()
        self._dims = [shard_dim(tuple(p.shape), world) for p in params]
        with torch.no_grad():
            self.shard_params: List[torch.Tensor] = params if mesh is None \
                else [torch.nn.Parameter(_shard(p, d, mesh))
                      for p, d in zip(params, self._dims)]
        self.optim = factory(self.shard_params)
        full = {id(s): p for s, p in zip(self.shard_params, params)}
        super().__init__([{**self._hyper(g),
                           "params": [full[id(s)] for s in g["params"]]}
                          for g in self.optim.param_groups], {})
        self._params = params
        self.state = self.optim.state   # opt_state_bytes reads the shards'

    @staticmethod
    def _hyper(group: Dict[str, Any]) -> Dict[str, Any]:
        return {k: v for k, v in group.items() if k != "params"}

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for outer, inner in zip(self.param_groups, self.optim.param_groups):
            inner.update(self._hyper(outer))
        if self.mesh is None:
            self.optim.step()
            return loss
        for p, s, d in zip(self._params, self.shard_params, self._dims):
            s.grad = None if p.grad is None else _shard(p.grad, d,
                                                        self.mesh)
        self.optim.step()
        for s in self.shard_params:
            s.grad = None
        self._gather()
        return loss

    def _gather(self) -> None:
        """Every split param's slices all-gathered into the full param:
        the slices of one dtype flattened into one buffer, one
        all-gather into the rows of another, then each param's
        rank-ordered slices joined along its dimension."""
        import torch.distributed as dist
        world = self.mesh.size()
        by_dtype: Dict[torch.dtype, list] = {}
        for p, s, d in zip(self._params, self.shard_params, self._dims):
            if d is not None:
                by_dtype.setdefault(p.dtype, []).append((p, s.to_local(), d))
        for items in by_dtype.values():
            flat = torch.cat([local.reshape(-1) for _, local, _ in items])
            out = flat.new_empty((world, flat.numel()))
            dist.all_gather(list(out.unbind(0)), flat,
                            group=self.mesh.get_group())
            offset = 0
            for p, local, d in items:
                n = local.numel()
                parts = out[:, offset:offset + n].reshape(world,
                                                          *local.shape)
                p.copy_(parts.movedim(0, d).reshape(p.shape))
                offset += n

    def state_dict(self) -> Dict[str, Any]:
        """The inner optimizer's (its tensors DTensors on ``mesh``;
        :func:`~ray_lightning_tpu_torch.strategies.sharding.full_state`
        makes them the one-process layout)."""
        return self.optim.state_dict()

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.optim.load_state_dict(state_dict)
        for outer, inner in zip(self.param_groups, self.optim.param_groups):
            outer.update(self._hyper(inner))


class ShardedState:
    """State dicts of a strategy whose state is sharded (ZeRO's
    optimizer state, FSDP2's params, gradients and optimizer state):
    full tensors on every rank (a collective) for the stream format and
    the driver, the shards themselves for the directory format; a full
    state loads by keeping this rank's part."""

    def state_dict(self, state: TrainState, full: bool = True
                   ) -> Optional[Dict[str, Any]]:
        sd = state.state_dict()
        return full_state(sd) if full and self.in_world else sd

    def load_state_dict(self, state: TrainState,
                        sd: Dict[str, Any]) -> None:
        if self.in_world:
            sd = load_sharded_state(state, sd)
        super().load_state_dict(state, sd)


class RayShardedStrategy(ShardedState, RayStrategy):
    """DDP with the optimizer state sharded over ranks (ZeRO-1) by the
    JAX package's rule."""
    strategy_name = "ddp_sharded_ray"

    def make_optimizer(self, factory: Callable, model: torch.nn.Module
                       ) -> torch.optim.Optimizer:
        if not self.in_world:
            return super().make_optimizer(factory, model)
        mesh = None
        if self.world_size > 1:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(self.root_device.type,
                                    (self.world_size,))
        return ZeroOptimizer(model.parameters(), factory, mesh)


ZeroOneStrategy = RayShardedStrategy
