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

State dicts keep the one-process layout under the bare names
(``sharded.ShardedState``): full tensors (all-gathered, a collective) for
the stream format and the driver, the shards themselves (DTensors, each
rank writing its own) for the directory format. Loading takes full
tensors and keeps this rank's part, so a checkpoint of any world size
loads. ``adamw`` and the ``torch.optim`` optimizers update the shards
elementwise through DTensor; the hand-written presets (``adamw_bf16m``,
``adafactor``) update their local parts, adafactor summing its means
over a sharded dimension over the group (``core/optim.py``).
"""
from __future__ import annotations

import torch

from ray_lightning_tpu_torch.strategies.base import Strategy
from ray_lightning_tpu_torch.strategies.sharded import ShardedState


class FSDPStrategy(ShardedState, Strategy):
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
