"""MNIST classifier module (counterpart of ``ray_lightning_tpu/models/mnist.py``).

The reference's ``LightningMNISTClassifier``: a 3-layer MLP (28² → 128 →
256 → 10) with accuracy tracking, on the synthetic learnable MNIST
stand-in (:func:`~ray_lightning_tpu_torch.data.synthetic.synthetic_mnist`,
the same numpy batches the JAX package trains on).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.core.optim import make_optimizer
from ray_lightning_tpu_torch.data.loader import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.data.synthetic import synthetic_mnist
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.bert import classification_metrics
from ray_lightning_tpu_torch.models.boring import Linear


class MNISTNet(nn.Module):
    """Three f32 ``Linear`` layers with ReLUs, named as flax names them
    (``Dense_0`` .. ``Dense_2``), each initialised as flax's ``nn.Dense``
    (LeCun-normal weights, zero biases). ``device=None`` builds on the
    card."""

    def __init__(self, hidden1: int = 128, hidden2: int = 256,
                 num_classes: int = 10, in_features: int = 28 * 28,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        # built on "meta" (no draws), then placed and drawn from one
        # generator
        self.Dense_0 = Linear(in_features, hidden1, device="meta")
        self.Dense_1 = Linear(hidden1, hidden2, device="meta")
        self.Dense_2 = Linear(hidden2, num_classes, device="meta")
        if dev.type != "meta":
            self.to_empty(device=dev)
            self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Each layer's LeCun-normal draw from ``generator`` (None = a
        fresh one seeded 0), in layer order."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for layer in (self.Dense_0, self.Dense_1, self.Dense_2):
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class LightningMNISTClassifier(TpuModule):
    """The MLP on synthetic MNIST. ``optax.adam(lr)`` is AdamW without
    weight decay (``make_optimizer("adamw", lr, weight_decay=0.0)``
    computes the same update)."""

    def __init__(self,
                 config: Optional[dict] = None,
                 data_dir: Optional[str] = None,
                 num_samples: int = 2048):
        super().__init__()
        config = config or {}
        self.lr = config.get("lr", 1e-3)
        self.batch_size = int(config.get("batch_size", 32))
        self.data_dir = data_dir
        self.num_samples = num_samples

    def configure_model(self):
        # built on "meta": the trainer places and initialises it
        return MNISTNet(device="meta")

    def configure_optimizers(self):
        return make_optimizer("adamw", self.lr, weight_decay=0.0)

    def _dataset(self, seed: int):
        x, y = synthetic_mnist(self.num_samples, seed=seed)
        return ArrayDataset((x, y))

    def train_dataloader(self):
        return DataLoader(self._dataset(0), batch_size=self.batch_size,
                          shuffle=True)

    def val_dataloader(self):
        return DataLoader(self._dataset(1), batch_size=self.batch_size)

    def test_dataloader(self):
        return DataLoader(self._dataset(2), batch_size=self.batch_size)

    def predict_dataloader(self):
        return DataLoader(self._dataset(3), batch_size=self.batch_size)

    def training_step(self, model, batch, generator):
        x, y = batch
        loss, acc = classification_metrics(model(x), y)
        self.log("ptl/train_loss", loss)
        self.log("ptl/train_accuracy", acc)
        return loss

    def validation_step(self, model, batch, generator):
        x, y = batch
        loss, acc = classification_metrics(model(x), y)
        return {"ptl/val_loss": loss, "ptl/val_accuracy": acc}

    def test_step(self, model, batch, generator):
        x, y = batch
        return {"acc": classification_metrics(model(x), y)[1]}

    def predict_step(self, model, batch, generator):
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        return model(x).argmax(-1)


MNISTClassifier = LightningMNISTClassifier
