"""Vision Transformer family (counterpart of ``ray_lightning_tpu/models/vit.py``).

A ViT classifier built on the port's layer stack (the one BERT and GPT
run on): a patch embedding, a CLS token and learned positions, the
bidirectional stack, ``head_ln`` and an f32 head on the CLS row. The
patch embedding is the JAX package's stride-``p`` convolution over NHWC
images, computed as one product over the flattened patches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.core.optim import make_optimizer
from ray_lightning_tpu_torch.data.loader import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.bert import (classification_metrics,
                                                 f32_head)
from ray_lightning_tpu_torch.models.transformer import (Dense, LayerNorm,
                                                        TransformerConfig,
                                                        TransformerStack,
                                                        check_dropout_seed,
                                                        check_seq_len,
                                                        init_params)

VIT_SIZES = {
    # name: (n_layers, d_model, n_heads)
    "tiny": (4, 192, 3),
    "small": (12, 384, 6),
    "base": (12, 768, 12),   # ViT-B
}


def vit_config(size: str = "tiny", image_size: int = 32,
               patch_size: int = 4, **overrides) -> TransformerConfig:
    if size not in VIT_SIZES:
        raise ValueError(f"Unknown ViT size {size!r}; choose from "
                         f"{sorted(VIT_SIZES)}")
    n_layers, d_model, n_heads = VIT_SIZES[size]
    if image_size % patch_size != 0:
        raise ValueError(
            f"image_size={image_size} must be divisible by "
            f"patch_size={patch_size} (non-overlapping square patches)")
    n_patches = (image_size // patch_size) ** 2
    base = dict(vocab_size=1,  # unused: inputs are pixels, not tokens
                max_seq_len=n_patches + 1,  # +1 CLS
                d_model=d_model, n_heads=n_heads, n_layers=n_layers,
                d_ff=4 * d_model, causal=False,
                # the JAX package's default: remat with the attention
                # output kept (models/remat.py)
                remat=True,
                remat_policy="dots_with_no_batch_dims_save_attn")
    base.update(overrides)
    if not base["remat"] and "remat_policy" not in overrides:
        # remat=False must not trip the config's policy-without-remat
        # check on the default policy
        base["remat_policy"] = None
    return TransformerConfig(**base)


class PatchEmbed(nn.Module):
    """flax ``nn.Conv(D, kernel_size=(p, p), strides=(p, p),
    padding="VALID")`` over NHWC images, in the compute dtype: ``weight``
    (D, C, p, p) (torch's convolution layout; flax's kernel is (p, p, C,
    D)) and ``bias`` (D). Returns (B, n_patches, D), the patches in
    row-major (h, w) order, as flax's output reshaped."""

    def __init__(self, channels: int, features: int, patch: int,
                 cfg: TransformerConfig, device):
        super().__init__()
        self.patch = patch
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(
            features, channels, patch, patch, dtype=cfg.param_dtype,
            device=device))
        self.bias = nn.Parameter(torch.empty(
            features, dtype=cfg.param_dtype, device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, C = images.shape
        p = self.patch
        if H % p or W % p or C != self.weight.shape[1]:
            raise ValueError(f"images of {H}x{W}x{C} do not split into "
                             f"{p}x{p}x{self.weight.shape[1]} patches")
        # (B, H/p, p, W/p, p, C) -> (B, H/p, W/p, p, p, C): each patch's
        # (row, column, channel) values in the kernel's order
        x = images.to(self.dtype).reshape(B, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, -1, p * p * C)
        w = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        return F.linear(x, w.to(self.dtype), self.bias.to(self.dtype))


class ViTClassifier(nn.Module):
    """ViT: patch embedding + CLS token + bidirectional stack. ``cls_token``
    (1, 1, D) starts at zero, ``pos_embed`` (1, max_seq_len, D) at N(0,
    0.02). ``forward(images)`` takes (B, H, W, 3) images (the RGB images
    the JAX module trains on; flax sizes its kernel from the first batch)
    and returns f32 logits (B, num_classes). ``device=None`` builds on the
    card."""

    def __init__(self, cfg: TransformerConfig, num_classes: int = 10,
                 patch_size: int = 4, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.num_classes = num_classes
        self.patch_size = patch_size
        self.patch_embed = PatchEmbed(3, cfg.d_model, patch_size, cfg, dev)
        self.cls_token = nn.Parameter(torch.empty(
            1, 1, cfg.d_model, dtype=cfg.param_dtype, device=dev))
        self.pos_embed = nn.Parameter(torch.empty(
            1, cfg.max_seq_len, cfg.d_model, dtype=cfg.param_dtype,
            device=dev))
        self.stack = TransformerStack(cfg, dev)
        self.head_ln = LayerNorm(cfg.d_model, cfg, dev)
        self.head = Dense(cfg.d_model, num_classes, f32_head(cfg), dev)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """:func:`~ray_lightning_tpu_torch.models.transformer.init_params`
        from ``generator``, ``cls_token`` at zero."""
        init_params(self, generator, zeros=("cls_token",))

    def forward(self, images: torch.Tensor, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        check_dropout_seed(cfg, deterministic, dropout_seed)
        x = self.patch_embed(images)                  # (B, n_patches, D)
        B, D = x.shape[0], cfg.d_model
        cls = self.cls_token.to(cfg.dtype).expand(B, 1, D)
        x = torch.cat([cls, x], dim=1)
        T = x.shape[1]
        check_seq_len(cfg, T)
        x = x + self.pos_embed[:, :T].to(cfg.dtype)
        x = self.stack(x, deterministic=deterministic,
                       dropout_seed=dropout_seed)
        return self.head(self.head_ln(x)[:, 0])


def _synthetic_images(num_samples: int, image_size: int, num_classes: int,
                      seed: int = 0):
    """Class-conditioned noisy images so accuracy is learnable quickly.

    The class prototypes are drawn from a FIXED seed so train/val/test
    splits (different ``seed``) share one distribution and only differ in
    sampling noise — otherwise validation measures a different task.
    """
    protos = np.random.default_rng(1234).standard_normal(
        (num_classes, image_size, image_size, 3))
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=(num_samples,)).astype(np.int32)
    x = protos[y] + 0.3 * rng.standard_normal(
        (num_samples, image_size, image_size, 3))
    return x.astype(np.float32), y


class ViTModule(TpuModule):
    """Image classification on synthetic class-prototype data; AdamW with
    weight decay 0.05 on every parameter (optax's ``adamw``)."""

    def __init__(self,
                 size: str = "tiny",
                 image_size: int = 32,
                 patch_size: int = 4,
                 num_classes: int = 10,
                 batch_size: int = 32,
                 num_samples: int = 512,
                 lr: float = 1e-3,
                 config: Optional[TransformerConfig] = None):
        super().__init__()
        self.cfg = config or vit_config(size, image_size, patch_size)
        if image_size % patch_size != 0:
            raise ValueError(f"image_size={image_size} not divisible by "
                             f"patch_size={patch_size}")
        seq = (image_size // patch_size) ** 2 + 1  # patches + CLS
        if seq > self.cfg.max_seq_len:
            raise ValueError(
                f"config.max_seq_len={self.cfg.max_seq_len} is too small "
                f"for image_size={image_size}/patch_size={patch_size} "
                f"({seq} tokens incl. CLS) — build the config with "
                "vit_config(image_size=..., patch_size=...) matching the "
                "module arguments")
        self.image_size = image_size
        self.patch_size = patch_size
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.lr = lr

    def configure_model(self):
        # built on "meta": the trainer places and initialises it
        return ViTClassifier(self.cfg, self.num_classes, self.patch_size,
                             device="meta")

    def configure_optimizers(self):
        return make_optimizer("adamw", self.lr, weight_decay=0.05)

    def _loader(self, seed: int, shuffle: bool = False):
        x, y = _synthetic_images(self.num_samples, self.image_size,
                                 self.num_classes, seed)
        return DataLoader(ArrayDataset(x, y), batch_size=self.batch_size,
                          shuffle=shuffle)

    def train_dataloader(self):
        return self._loader(seed=0, shuffle=True)

    def val_dataloader(self):
        return self._loader(seed=1)

    def test_dataloader(self):
        return self._loader(seed=2)

    def training_step(self, model, batch, generator):
        images, labels = batch
        deterministic = self.cfg.dropout == 0.0
        seed = None if deterministic else int(
            torch.randint(0, 2**62, (1,), generator=generator))
        loss, acc = classification_metrics(
            model(images, deterministic=deterministic, dropout_seed=seed),
            labels)
        self.log("train_acc", acc)
        return loss

    def validation_step(self, model, batch, generator):
        images, labels = batch
        loss, acc = classification_metrics(model(images), labels)
        return {"val_loss": loss, "val_acc": acc}

    def test_step(self, model, batch, generator):
        logs = self.validation_step(model, batch, generator)
        return {"test_loss": logs["val_loss"], "test_acc": logs["val_acc"]}
