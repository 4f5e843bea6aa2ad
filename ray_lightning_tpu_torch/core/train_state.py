"""The training state (counterpart of ``ray_lightning_tpu/core/train_state.py``).

JAX keeps params and optimizer state in one immutable pytree that the
compiled step returns anew. Here the model and the optimizer hold their
tensors and are updated in place; the state names them together with the
step count and the generator the steps draw from.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    """``step``: training batches taken; ``model``: the ``nn.Module``;
    ``optimizer``: its ``torch.optim.Optimizer``; ``generator``: the CPU
    ``torch.Generator`` handed to ``training_step``."""
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
