"""Fully sharded data parallelism (counterpart of ``ray_lightning_tpu/strategies/fsdp.py``).

Params, gradients and optimizer state sharded over the ranks: FSDP2's
``fully_shard``, applied to each repeated layer (every module held in an
``nn.ModuleList``: a transformer's blocks) and then to the root, which
holds the rest -- for ``TransformerLM`` the tied embedding and head, the
position embedding and the final norm. Each layer's params are
all-gathered just before its forward and backward and its gradients
reduce-scattered after, where the JAX package lets XLA derive the same
schedule from an ``fsdp`` mesh axis. Extra keyword arguments go to
``fully_shard`` (e.g. ``reshard_after_forward``).

State dicts keep the one-process layout under the bare names: full
tensors (all-gathered, a collective) for the stream format and the
driver, the shards themselves (DTensors, each rank writing its own) for
the directory format. Loading takes full tensors and keeps this rank's
part, so a checkpoint of any world size loads. ``adamw`` and the
``torch.optim`` optimizers shard elementwise; the hand-written presets
(``adamw_bf16m``, ``adafactor``, whose factored moments reduce over a
dimension FSDP shards) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ray_lightning_tpu_torch.core.train_state import TrainState
from ray_lightning_tpu_torch.strategies.base import Strategy
from ray_lightning_tpu_torch.strategies.sharded import refuse_hand_written


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _full(tree: Any) -> Any:
    """Every DTensor in a nest all-gathered into a plain tensor (a
    collective: every rank walks the same nest in the same order)."""
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_full(v) for v in tree)
    return tree.full_tensor() if _is_dtensor(tree) else tree


def _shard_like(full: torch.Tensor, like) -> Any:
    """``full`` as a DTensor laid out as ``like`` (sharded on one
    dimension of a 1-D mesh): this rank's part of ``torch.chunk``'s
    split, as DTensor shards are, cut from this rank's own copy without
    communication."""
    from torch.distributed.tensor import DTensor
    (placement,) = like.placements
    mesh = like.device_mesh
    full = full.to(like.device, like.dtype)
    chunks = torch.chunk(full, mesh.size(), dim=placement.dim)
    rank = mesh.get_local_rank()
    local = chunks[rank] if rank < len(chunks) \
        else full.narrow(placement.dim, 0, 0)
    return DTensor.from_local(local.contiguous(), mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


class FSDPStrategy(Strategy):
    """Data parallelism with params, gradients and optimizer state
    sharded over the ranks (FSDP2)."""
    strategy_name = "fsdp"

    def wrap_model(self, model: torch.nn.Module) -> torch.nn.Module:
        if not self.in_world:
            return model
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard
        mesh = init_device_mesh(self.root_device.type, (self.world_size,))
        layers = [m for lst in model.modules()
                  if isinstance(lst, torch.nn.ModuleList) for m in lst]
        for layer in layers:
            fully_shard(layer, mesh=mesh, **self.extra_kwargs)
        fully_shard(model, mesh=mesh, **self.extra_kwargs)
        return model

    def make_optimizer(self, factory: Callable, model: torch.nn.Module
                       ) -> torch.optim.Optimizer:
        if self.in_world:
            refuse_hand_written(factory, type(self).__name__)
        return factory(model.parameters())

    def state_dict(self, state: TrainState, full: bool = True
                   ) -> Optional[Dict[str, Any]]:
        sd = state.state_dict()
        return _full(sd) if full and self.in_world else sd

    def load_state_dict(self, state: TrainState,
                        sd: Dict[str, Any]) -> None:
        """A full (one-process layout) state into the sharded one: every
        tensor laid out as the live param it belongs to keeps this rank's
        part, then the one-process load copies it in."""
        if not self.in_world:
            return super().load_state_dict(state, sd)
        sd = _full(sd)
        live = state.model.state_dict()
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]

        def like(t, p):
            return _shard_like(t, p) if _is_dtensor(p) else t

        opt = sd["opt_state"]
        sd = {**sd,
              "params": {k: like(v, live[k]) if k in live else v
                         for k, v in sd["params"].items()},
              "opt_state": {**opt, "state": {
                  i: {k: like(v, params[i])
                      if isinstance(v, torch.Tensor)
                      and v.shape == params[i].shape else v
                      for k, v in st.items()}
                  for i, st in opt["state"].items()}},
              "acc": None if sd.get("acc") is None else [
                  like(a, p) for a, p in zip(sd["acc"], params,
                                             strict=True)]}
        super().load_state_dict(state, sd)
