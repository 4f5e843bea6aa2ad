"""The training state (counterpart of ``ray_lightning_tpu/core/train_state.py``).

JAX keeps params and optimizer state in one immutable pytree that the
compiled step returns anew. Here the model and the optimizer hold their
tensors and are updated in place; the state names them together with
everything else a resumed run needs to continue bit for bit: the step
count, the generator the steps draw from, and the strategy step's
gradient-accumulation position, running mean and update count (what
optax's ``MultiSteps`` keeps inside its state). Under data parallelism
``model`` is what the step calls (e.g. the ``DistributedDataParallel``
wrapper); the state dict keeps the bare module's names, so checkpoints
move between world sizes.

JAX's ``TrainState.model_state`` (flax's mutable collections, e.g.
BatchNorm's ``batch_stats``) is the module's buffers here: the forward
moves them in place, and the module's ``state_dict`` -- the state's
``params`` entry -- holds them beside the parameters, so every
checkpoint format, the in-memory tier and a reshard carry them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch


def bare_model(model: torch.nn.Module) -> torch.nn.Module:
    """The user's module inside a ``DistributedDataParallel`` wrapper."""
    if isinstance(model, torch.nn.parallel.DistributedDataParallel):
        return model.module
    return model


@dataclasses.dataclass
class TrainState:
    """``step``: training batches taken; ``model``: the ``nn.Module``;
    ``optimizer``: its ``torch.optim.Optimizer``; ``generator``: the CPU
    ``torch.Generator`` handed to ``training_step``; ``mini_step``:
    batches already averaged into ``acc`` (the running mean of the
    gradients of an accumulation, None between updates); ``updates``:
    optimizer updates taken (the learning-rate schedule's argument)."""
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    mini_step: int = 0
    updates: int = 0
    acc: Optional[List[torch.Tensor]] = None

    def state_dict(self, optimizer: bool = True) -> Dict[str, Any]:
        """The checkpoint's ``state``, under the JAX TrainState's field
        names where one exists; ``params`` is the module's state dict,
        buffers (JAX's ``model_state``) included. Tensors alias the live
        ones: a writer copies them out before training goes on.
        ``optimizer=False`` leaves ``opt_state`` None (a rank that does
        not hold it)."""
        return {"step": self.step,
                "params": bare_model(self.model).state_dict(),
                "opt_state": (self.optimizer.state_dict() if optimizer
                              else None),
                "rng": self.generator.get_state(),
                "mini_step": self.mini_step,
                "updates": self.updates,
                "acc": self.acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a checkpoint's ``state`` in: params and buffers into the
        live ones (their device and dtype), optimizer state onto each
        param's device, the generator's state, and the counters."""
        bare_model(self.model).load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.generator.set_state(state["rng"].to("cpu", torch.uint8))
        self.step = int(state["step"])
        self.mini_step = int(state.get("mini_step", 0))
        self.updates = int(state.get("updates", 0))
        acc = state.get("acc")
        if acc is None:
            self.acc = None
        else:
            params = [p for g in self.optimizer.param_groups
                      for p in g["params"]]
            self.acc = [a.to(p.device, p.dtype)
                        for a, p in zip(acc, params, strict=True)]
