"""GPT-2 family sizes and the training module (counterpart of ``ray_lightning_tpu/models/gpt.py``).

Causal LM on the port's transformer core, trained on the synthetic Markov
token stream (the same numpy tokens the JAX package trains on).
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F

from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.core.optim import make_optimizer
from ray_lightning_tpu_torch.data.loader import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.data.synthetic import synthetic_tokens
from ray_lightning_tpu_torch.models.transformer import (TransformerConfig,
                                                        TransformerLM,
                                                        jax_leaves)

GPT2_SIZES = {
    # name: (n_layers, d_model, n_heads)
    "nano": (2, 128, 4),          # test size
    "small": (12, 768, 12),       # 124M
    "medium": (24, 1024, 16),     # 350M
    "large": (36, 1280, 20),      # 774M
    "xl": (48, 1600, 25),         # 1.5B
}


def gpt2_config(size: str = "small",
                vocab_size: int = 50257,
                max_seq_len: int = 1024,
                **overrides) -> TransformerConfig:
    n_layers, d_model, n_heads = GPT2_SIZES[size]
    base = dict(
        vocab_size=vocab_size, max_seq_len=max_seq_len, d_model=d_model,
        n_heads=n_heads, n_layers=n_layers, d_ff=4 * d_model, causal=True)
    base.update(overrides)
    return TransformerConfig(**base)


class GPTModule(TpuModule):
    """Next-token LM training module over synthetic token streams.

    The loss is ``F.cross_entropy`` of the f32 logits against the next
    tokens, the mean over every token -- the counterpart of
    ``optax.softmax_cross_entropy_with_integer_labels(...).mean()``.
    A training step is deterministic iff ``config.dropout == 0``; with
    dropout it draws one integer from the step's generator, the seed of
    its masks (so a resumed run, whose generator state the checkpoint
    carries, replays them). Validation and predict are deterministic.
    """

    def __init__(self,
                 config: Optional[TransformerConfig] = None,
                 size: str = "nano",
                 batch_size: int = 8,
                 seq_len: Optional[int] = None,
                 num_samples: int = 256,
                 lr: float = 3e-4,
                 weight_decay: float = 0.1,
                 vocab_size: int = 1024,
                 optimizer: str = "adamw"):
        super().__init__()
        if config is None:
            seq_len = 128 if seq_len is None else seq_len
            config = gpt2_config(size, vocab_size=vocab_size,
                                 max_seq_len=seq_len)
        self.cfg = config
        seq_len = config.max_seq_len if seq_len is None else seq_len
        if seq_len > config.max_seq_len:
            raise ValueError(
                f"seq_len={seq_len} exceeds config.max_seq_len="
                f"{config.max_seq_len}; positions would silently clamp")
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.num_samples = num_samples
        self.lr = lr
        self.weight_decay = weight_decay
        self.optimizer = optimizer

    def configure_model(self):
        # built on "meta": the trainer places it on its device and
        # initialises it from its generator
        return TransformerLM(self.cfg, device="meta")

    def configure_optimizers(self):
        # b2=0.95 applies to the adam presets only
        kwargs = {} if self.optimizer == "adafactor" else {"b2": 0.95}
        # the JAX model's leaves: adafactor factors and clips by them
        return make_optimizer(self.optimizer, self.lr,
                              weight_decay=self.weight_decay,
                              leaves=jax_leaves(self.cfg), **kwargs)

    def _loader(self, seed: int, shuffle: bool = False):
        toks = synthetic_tokens(self.num_samples, self.seq_len + 1,
                                self.cfg.vocab_size, seed=seed)
        # pre-split (inputs, targets): every batch leaf is (B, seq_len)
        return DataLoader(ArrayDataset((toks[:, :-1], toks[:, 1:])),
                          batch_size=self.batch_size, shuffle=shuffle)

    def train_dataloader(self):
        return self._loader(0, shuffle=True)

    def val_dataloader(self):
        return self._loader(1)

    def _loss(self, model, batch, deterministic: bool = True,
              dropout_seed: Optional[int] = None):
        inputs, targets = batch
        logits = model(inputs, deterministic=deterministic,
                       dropout_seed=dropout_seed)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1).long())
        return loss, logits

    def training_step(self, model, batch, generator):
        deterministic = self.cfg.dropout == 0.0
        seed = None if deterministic else int(
            torch.randint(0, 2**62, (1,), generator=generator))
        loss, _ = self._loss(model, batch, deterministic, seed)
        self.log("train_ppl", torch.exp(loss.detach()))
        return loss

    def validation_step(self, model, batch, generator):
        loss, _ = self._loss(model, batch)
        return {"val_loss": loss, "val_ppl": torch.exp(loss)}


def count_params(params: Any) -> int:
    """Elements of a model's parameters (an ``nn.Module``: each shared
    tensor once, buffers not counted, as JAX counts its ``params``
    collection) or of every tensor or array in a state dict or nest."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, Mapping):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(math.prod(params.shape))
