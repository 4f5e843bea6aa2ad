"""BERT fine-tuning (counterpart of ``ray_lightning_tpu/models/bert.py``).

A sequence-classification head over the port's bidirectional encoder
(:class:`~ray_lightning_tpu_torch.models.transformer.TransformerEncoder`),
trained on synthetic tokens whose distribution depends on the class (the
same numpy batches the JAX package trains on), so fine-tuning is
learnable in tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.core.optim import make_optimizer
from ray_lightning_tpu_torch.data.loader import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.transformer import (Dense,
                                                        TransformerConfig,
                                                        TransformerEncoder,
                                                        init_params)

BERT_SIZES = {
    # name: (n_layers, d_model, n_heads)
    "tiny": (2, 128, 2),
    "base": (12, 768, 12),    # 110M
    "large": (24, 1024, 16),  # 340M
}


def bert_config(size: str = "base", vocab_size: int = 30522,
                max_seq_len: int = 512, **overrides) -> TransformerConfig:
    n_layers, d_model, n_heads = BERT_SIZES[size]
    base = dict(vocab_size=vocab_size, max_seq_len=max_seq_len,
                d_model=d_model, n_heads=n_heads, n_layers=n_layers,
                d_ff=4 * d_model, causal=False, num_segments=2)
    base.update(overrides)
    return TransformerConfig(**base)


def f32_head(cfg: TransformerConfig) -> TransformerConfig:
    """``cfg`` computing in f32: the config of a classifier head the JAX
    package builds with ``dtype=jnp.float32``."""
    return dataclasses.replace(cfg, dtype=torch.float32)


class BertClassifier(nn.Module):
    """The encoder, a pooler (``Dense`` in the compute dtype, then tanh)
    on the first position, and an f32 classifier. The encoder has no
    segment table: the JAX classifier never passes ``segment_ids``, so
    flax never creates one. ``forward`` returns f32 logits (B,
    num_classes). ``device=None`` builds on the card."""

    def __init__(self, cfg: TransformerConfig, num_classes: int = 2,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.num_classes = num_classes
        self.encoder = TransformerEncoder(cfg, dev)
        self.pooler = Dense(cfg.d_model, cfg.d_model, cfg, dev)
        self.classifier = Dense(cfg.d_model, num_classes, f32_head(cfg), dev)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """:func:`~ray_lightning_tpu_torch.models.transformer.init_params`
        from ``generator``."""
        init_params(self, generator)

    def forward(self, tokens: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        x = self.encoder(tokens, attention_mask=attention_mask,
                         deterministic=deterministic,
                         dropout_seed=dropout_seed)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.classifier(pooled)


def _synthetic_classification_tokens(num_samples: int, seq_len: int,
                                     vocab_size: int, num_classes: int,
                                     seed: int):
    """Class c draws tokens from a class-specific slice of the vocab."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_samples)
    span = vocab_size // (num_classes + 1)
    toks = np.empty((num_samples, seq_len), dtype=np.int32)
    for i, c in enumerate(labels):
        lo = (c + 1) * span
        toks[i] = rng.integers(lo, lo + span, size=seq_len)
    # mix in class-agnostic noise tokens
    noise = rng.integers(0, span, size=(num_samples, seq_len))
    noise_mask = rng.random((num_samples, seq_len)) < 0.5
    toks = np.where(noise_mask, noise, toks)
    return toks, labels.astype(np.int32)


def classification_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """(mean cross-entropy, accuracy) of f32 logits against integer
    labels: ``optax.softmax_cross_entropy_with_integer_labels(...).mean()``
    and the argmax hit rate."""
    labels = labels.long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


class BertModule(TpuModule):
    """Sequence classification on synthetic class-dependent tokens.
    AdamW with weight decay 0.01 on every parameter (optax's ``adamw``).
    A training step is deterministic iff ``config.dropout == 0``; with
    dropout it draws its masks' seed from the step's generator."""

    def __init__(self,
                 config: Optional[TransformerConfig] = None,
                 size: str = "tiny",
                 num_classes: int = 2,
                 batch_size: int = 8,
                 seq_len: Optional[int] = None,
                 num_samples: int = 256,
                 lr: float = 5e-5,
                 vocab_size: int = 1024):
        super().__init__()
        if config is None:
            seq_len = 128 if seq_len is None else seq_len
            config = bert_config(size, vocab_size=vocab_size,
                                 max_seq_len=seq_len)
        self.cfg = config
        seq_len = config.max_seq_len if seq_len is None else seq_len
        if seq_len > config.max_seq_len:
            raise ValueError(
                f"seq_len={seq_len} exceeds config.max_seq_len="
                f"{config.max_seq_len}; positions would silently clamp")
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.num_samples = num_samples
        self.lr = lr

    def configure_model(self):
        # built on "meta": the trainer places and initialises it
        return BertClassifier(self.cfg, self.num_classes, device="meta")

    def configure_optimizers(self):
        return make_optimizer("adamw", self.lr, weight_decay=0.01)

    def _loader(self, seed: int, shuffle: bool = False):
        x, y = _synthetic_classification_tokens(
            self.num_samples, self.seq_len, self.cfg.vocab_size,
            self.num_classes, seed)
        return DataLoader(ArrayDataset((x, y)), batch_size=self.batch_size,
                          shuffle=shuffle)

    def train_dataloader(self):
        return self._loader(0, shuffle=True)

    def val_dataloader(self):
        return self._loader(1)

    def test_dataloader(self):
        return self._loader(2)

    def training_step(self, model, batch, generator):
        tokens, labels = batch
        deterministic = self.cfg.dropout == 0.0
        seed = None if deterministic else int(
            torch.randint(0, 2**62, (1,), generator=generator))
        loss, acc = classification_metrics(
            model(tokens, deterministic=deterministic, dropout_seed=seed),
            labels)
        self.log("train_acc", acc)
        return loss

    def validation_step(self, model, batch, generator):
        tokens, labels = batch
        loss, acc = classification_metrics(model(tokens), labels)
        return {"val_loss": loss, "val_acc": acc}
