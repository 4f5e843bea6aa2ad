"""ZeRO-1 data parallelism (counterpart of ``ray_lightning_tpu/strategies/sharded.py``).

The reference's ``RayShardedStrategy`` (``ray_lightning/ray_ddp_sharded.
py:12-13``) mixes FairScale's optimizer-state sharding into DDP. Here:
DDP as :class:`RayStrategy`, with the optimizer wrapped in
``torch.distributed.optim.ZeroRedundancyOptimizer``: each rank keeps the
state of, and updates, a share of the parameters (whole tensors, dealt
out largest first), then broadcasts them. The JAX package shards every
optimizer-state array along its largest divisible dimension instead; the
updates are the same, the per-rank share differs. ``opt_state_bytes``
reports this rank's share; a checkpoint consolidates the state on rank 0
(``consolidate_state_dict(to=0)``, a collective), so it holds the same
logical dict as a one-process run and loads at any world size.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ray_lightning_tpu_torch.core.optim import _OptaxLike
from ray_lightning_tpu_torch.core.train_state import TrainState
from ray_lightning_tpu_torch.strategies.ddp import RayStrategy

SHARDED_PRESETS_ITEM = "ROADMAP.md A1, the rest of T6"


class _FromFactory:
    """``ZeroRedundancyOptimizer`` builds its local optimizer as
    ``optimizer_class(params, **defaults)``; the port's optimizers come
    as factories from ``configure_optimizers``, which take the params
    alone."""

    def __init__(self, factory: Callable):
        self.factory = factory

    def __call__(self, params, **defaults):
        return self.factory(params)


def refuse_hand_written(factory: Callable, who: str) -> None:
    """The hand-written optax presets (``adamw_bf16m``, ``adafactor``)
    keep a count outside the per-parameter state and, for adafactor,
    factored moments over whole tensors: under a sharded optimizer they
    raise, naming their ``ROADMAP.md`` item."""
    probe = factory([torch.nn.Parameter(torch.zeros(2, 2))])
    if isinstance(probe, _OptaxLike):
        raise NotImplementedError(
            f"{who} with the {type(probe).__name__} preset "
            f"(adamw_bf16m / adafactor) is not ported yet "
            f"({SHARDED_PRESETS_ITEM}); use make_optimizer('adamw') or an "
            "optimizer from torch.optim")


class RayShardedStrategy(RayStrategy):
    """DDP with the optimizer state sharded over ranks (ZeRO-1)."""
    strategy_name = "ddp_sharded_ray"

    def make_optimizer(self, factory: Callable, model: torch.nn.Module
                       ) -> torch.optim.Optimizer:
        if not self.in_world:
            return super().make_optimizer(factory, model)
        refuse_hand_written(factory, type(self).__name__)
        from torch.distributed.optim import ZeroRedundancyOptimizer
        return ZeroRedundancyOptimizer(model.parameters(),
                                       optimizer_class=_FromFactory(factory))

    def state_dict(self, state: TrainState, full: bool = True
                   ) -> Optional[Dict[str, Any]]:
        """Collective: the optimizer state consolidated on rank 0; the
        other ranks' dicts hold no optimizer state."""
        opt = state.optimizer
        if not hasattr(opt, "consolidate_state_dict"):
            return super().state_dict(state, full)
        opt.consolidate_state_dict(to=0)
        return state.state_dict(optimizer=self.global_rank == 0)

    def load_state_dict(self, state: TrainState,
                        sd: Dict[str, Any]) -> None:
        opt = sd.get("opt_state")
        if opt is not None and hasattr(state.optimizer,
                                       "consolidate_state_dict"):
            # ZeroRedundancyOptimizer.load_state_dict clears the entries
            # of other ranks' params in the dict it is given
            sd = {**sd, "opt_state": {**opt, "state": dict(opt["state"])}}
        super().load_state_dict(state, sd)


ZeroOneStrategy = RayShardedStrategy
