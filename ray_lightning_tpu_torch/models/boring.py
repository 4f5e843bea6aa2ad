"""Tiny fixture models (counterpart of ``ray_lightning_tpu/models/boring.py``).

:class:`BoringModel` is the JAX package's: one ``Linear(32 -> 2)``, loss
``mean(out**2)``, SGD at 0.1, the same deterministic numpy data for
every loader, a hook ledger and checkpointable extra state -- so the
port's trainer tests mirror the JAX package's case for case.
:class:`XORModel` (with :class:`XORDataModule`) logs constant metrics,
which pin a metric's exact round trip through the trainer and launcher.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ray_lightning_tpu_torch.core.module import TpuDataModule, TpuModule
from ray_lightning_tpu_torch.data.loader import ArrayDataset, DataLoader


class Linear(nn.Linear):
    """``nn.Linear`` initialised as flax's ``nn.Dense``: LeCun-normal
    (truncated) weights and zero bias, from an explicit generator."""

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        if self.weight.is_meta:
            return      # nothing to fill yet: the trainer places it first
        with torch.no_grad():
            # flax's lecun_normal: variance 1/fan_in, truncated at 2
            # sigma, rescaled by the truncation's std (0.8796)
            std = math.sqrt(1.0 / self.in_features) / .87962566103423978
            w = torch.empty(self.weight.shape, device="cpu")
            torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                        generator=generator)
            self.weight.copy_(w)
            self.bias.zero_()


class BoringModel(TpuModule):
    """Linear(32, 2) with deterministic data and checkpointable extra
    state."""

    def __init__(self, batch_size: int = 8, num_samples: int = 64):
        super().__init__()
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.extra_state = {"my_counter": 0}
        # hook-call ledger, probe-style
        self.hook_calls: Dict[str, int] = {}

    def _mark(self, name: str) -> None:
        self.hook_calls[name] = self.hook_calls.get(name, 0) + 1

    def configure_model(self):
        return Linear(32, 2, device="meta")

    def configure_optimizers(self):
        return lambda params: torch.optim.SGD(params, lr=0.1)

    def _data(self):
        rng = np.random.default_rng(0)
        return rng.standard_normal((self.num_samples, 32)).astype(np.float32)

    def _loader(self):
        return DataLoader(ArrayDataset(self._data()),
                          batch_size=self.batch_size)

    def train_dataloader(self):
        return self._loader()

    def val_dataloader(self):
        return self._loader()

    def test_dataloader(self):
        return self._loader()

    def predict_dataloader(self):
        return self._loader()

    def training_step(self, model, batch, generator):
        loss = torch.mean(model(batch) ** 2)
        self.log("loss", loss)
        return loss

    def validation_step(self, model, batch, generator):
        return {"x": torch.mean(model(batch) ** 2)}

    def test_step(self, model, batch, generator):
        return {"y": torch.mean(model(batch) ** 2)}

    def on_train_start(self):
        self._mark("on_train_start")

    def on_train_epoch_end(self):
        self._mark("on_train_epoch_end")
        self.extra_state["my_counter"] += 1

    def on_save_checkpoint(self, checkpoint: Dict[str, Any]) -> None:
        checkpoint["my_counter"] = self.extra_state["my_counter"]

    def on_load_checkpoint(self, checkpoint: Dict[str, Any]) -> None:
        if "my_counter" in checkpoint:
            self.extra_state["my_counter"] = int(checkpoint["my_counter"])


class _XORNet(nn.Module):
    """flax's ``Dense(4)``, tanh, ``Dense(2)``, under flax's names."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = Linear(2, 4, device="meta")
        self.Dense_1 = Linear(4, 2, device="meta")

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        for layer in (self.Dense_0, self.Dense_1):
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(torch.tanh(self.Dense_0(x)))


class XORModel(TpuModule):
    """Logs constant metrics to pin exact metric round-trip values.
    ``optax.adam(0.02)`` is the port's AdamW without weight decay."""

    TRAIN_CONSTANT = 1.234
    VAL_CONSTANT = 5.678

    def configure_model(self):
        return _XORNet()

    def configure_optimizers(self):
        from ray_lightning_tpu_torch.core.optim import make_optimizer
        return make_optimizer("adamw", 0.02, weight_decay=0.0)

    def training_step(self, model, batch, generator):
        x, y = batch
        loss = torch.nn.functional.cross_entropy(model(x), y.long())
        self.log("avg_train_loss", torch.tensor(self.TRAIN_CONSTANT))
        return loss

    def validation_step(self, model, batch, generator):
        return {"avg_val_loss": torch.tensor(self.VAL_CONSTANT)}


def _xor_arrays():
    # the 4-point XOR truth table replicated to a shardable size
    x = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=np.float32)
    y = np.array([0, 1, 1, 0], dtype=np.int32)
    reps = 8
    return np.tile(x, (reps, 1)), np.tile(y, reps)


class XORDataModule(TpuDataModule):
    def __init__(self, batch_size: int = 8):
        self.batch_size = batch_size

    def train_dataloader(self):
        x, y = _xor_arrays()
        return DataLoader(ArrayDataset((x, y)), batch_size=self.batch_size)

    def val_dataloader(self):
        x, y = _xor_arrays()
        return DataLoader(ArrayDataset((x, y)), batch_size=self.batch_size)
