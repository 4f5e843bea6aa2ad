"""Encoder-decoder transformer (counterpart of ``ray_lightning_tpu/models/seq2seq.py``).

A bidirectional encoder over the source and a causal decoder that also
attends the encoder's output (T5/BART shape), trained on sequence
reversal: the decoder must emit the source backwards, which its
self-attention over the shifted target cannot do alone, so learning it
shows that cross-attention works.

- The encoder is the port's :class:`~.transformer.TransformerStack`
  under the config with ``causal=False``: its remat, its dropout sites
  and ``attention_impl`` apply as they do in the LM. A ``src_mask``
  (B, S), 1 = attend, 0 = padding, becomes the additive (B, 1, 1, S)
  mask of its self-attention (``"flash"`` then takes the dense
  attention, as in JAX) and of every decoder block's cross-attention. A
  source row that is all padding gives exactly 0 from both.
- A decoder block (:class:`DecoderBlock`) is pre-LN: causal
  self-attention (the port's :class:`~.transformer.MultiHeadAttention`,
  with its ``attn_out`` seat), cross-attention (:class:`CrossAttention`,
  no seat: JAX names none), then the MLP (its ``mlp_act`` seat). The
  cross-attention always runs the plain
  :func:`~ray_lightning_tpu_torch.ops.attention.dot_product_attention`,
  whatever ``attention_impl`` says, as the JAX module does: it never
  reaches the flash kernels. Under ``cfg.remat`` each block runs through
  :func:`~.remat.checkpoint_block` with the memory and the mask as
  inputs of the rematerialized region.
- The head is tied to the target embedding; the logits are f32.

Dropout draws each site's mask from ``(seed, layer, site)``
(:mod:`~ray_lightning_tpu_torch.ops.dropout`): the encoder's blocks are
layers ``0..n_layers-1``, the decoder's ``n_layers..2·n_layers-1``, and
the cross-attention is a site of its own, so no two sites of the model
draw the same mask.

The weights start from flax's default initializers, as the JAX
module's do (``init_params(flax_defaults=True)``). The flax tree
(``src_embed``, ``src_pos``, ``encoder`` scanned or
unrolled, ``enc_ln_f``, ``tgt_embed``, ``tgt_pos``, ``dec_i``,
``dec_ln_f``) loads through :func:`~ray_lightning_tpu_torch.interop.load_flax_params`.
The JAX module has no decoder cache and no generation loop, and neither
has this one.
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
from ray_lightning_tpu_torch.models import remat as _remat
from ray_lightning_tpu_torch.models.transformer import (Dense, Embed,
                                                        LayerNorm,
                                                        MlpBlock,
                                                        MultiHeadAttention,
                                                        TransformerConfig,
                                                        TransformerStack,
                                                        check_dropout_seed,
                                                        check_seq_len,
                                                        init_params,
                                                        padding_mask)
from ray_lightning_tpu_torch.ops import dropout as _dropout
from ray_lightning_tpu_torch.ops.attention import dot_product_attention


class CrossAttention(nn.Module):
    """Decoder-side attention over the encoder's output (bidirectional):
    queries from the decoder stream through ``q`` (flax kernel (d, H,
    D)), keys and values from the memory through ``kv`` (flax kernel
    (d, 2, H, D), rows ordered (2, H, D)), then ``out``."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        hd = cfg.n_heads * cfg.head_dim
        self.q = Dense(cfg.d_model, hd, cfg, device)
        self.kv = Dense(cfg.d_model, 2 * hd, cfg, device)
        self.out = Dense(hd, cfg.d_model, cfg, device)

    def forward(self, x, memory, mask: Optional[torch.Tensor] = None,
                dropout_rng: Optional[int] = None):
        """``mask``: the additive f32 mask over (B, H, T, S);
        ``dropout_rng``: the integer seed of this site's dropout (None:
        deterministic)."""
        cfg = self.cfg
        B, T, _ = x.shape
        S = memory.shape[1]
        H, D = cfg.n_heads, cfg.head_dim
        q = self.q(x).view(B, T, H, D)
        k, v = self.kv(memory).view(B, S, 2, H, D).unbind(dim=2)
        # the self-attention's precision and dropout rules, on the plain
        # attention whatever attention_impl says (as in JAX)
        out = dot_product_attention(
            q, k, v, causal=False, mask=mask,
            dropout_rate=cfg.dropout if dropout_rng is not None else 0.0,
            dropout_rng=dropout_rng,
            softmax_dtype=cfg.attention_softmax_dtype)
        return self.out(out.reshape(B, T, H * D))


class DecoderBlock(nn.Module):
    """Pre-LN decoder block: causal self-attention, cross-attention over
    ``memory``, MLP. ``layer`` numbers its dropout sites (the model gives
    the decoder's blocks the indices after the encoder's)."""

    def __init__(self, cfg: TransformerConfig, device, layer: int = 0):
        super().__init__()
        self.cfg = cfg
        self.layer = layer
        self.ln1 = LayerNorm(cfg.d_model, cfg, device)
        self.self_attn = MultiHeadAttention(cfg, device)
        self.ln_cross = LayerNorm(cfg.d_model, cfg, device)
        self.cross_attn = CrossAttention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, cfg, device)
        self.mlp = MlpBlock(cfg, device)

    def forward(self, x, memory, memory_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        if self.cfg.remat and torch.is_grad_enabled():
            return _remat.checkpoint_block(
                self._remat_forward, x, memory, memory_mask, deterministic,
                dropout_seed, policy=self.cfg.remat_policy)
        return self._forward(x, memory, memory_mask, deterministic,
                             dropout_seed)

    def _remat_forward(self, x, memory, memory_mask, deterministic,
                       dropout_seed):
        return self._forward(x, memory, memory_mask, deterministic,
                             dropout_seed, seats=True)

    def _forward(self, x, memory, memory_mask, deterministic, dropout_seed,
                 seats: bool = False):
        attn_rng = cross_rng = mlp_rng = None
        if self.cfg.dropout > 0.0 and not deterministic:
            # derived inside the rematerialized region: the replay
            # redraws the same masks from the same integers
            attn_rng, cross_rng, mlp_rng = (
                _dropout.site_seed(dropout_seed, self.layer, site)
                for site in (_dropout.ATTENTION, _dropout.CROSS,
                             _dropout.MLP))
        x = x + self.self_attn(self.ln1(x), dropout_rng=attn_rng,
                               seats=seats)
        x = x + self.cross_attn(self.ln_cross(x), memory, mask=memory_mask,
                                dropout_rng=cross_rng)
        return x + self.mlp(self.ln2(x), dropout_rng=mlp_rng, seats=seats)


class Seq2SeqTransformer(nn.Module):
    """Encoder-decoder LM: bidirectional encoder, causal decoder with
    cross-attention, the target embedding as the output head.

    ``cfg.causal`` must be True (the decoder's self-attention); the
    encoder runs bidirectional regardless. ``forward(src_tokens,
    tgt_tokens, src_mask=None, deterministic=True, dropout_seed=None)``
    returns f32 logits (B, T, vocab); ``src_mask`` (B, S), nonzero where
    a source token is real. ``deterministic=False`` with ``dropout > 0``
    needs ``dropout_seed``. ``device=None`` builds on the card.
    """

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        if not cfg.causal:
            raise ValueError(
                "Seq2SeqTransformer needs cfg.causal=True (the decoder's "
                "self-attention); a non-causal decoder would read future "
                "target tokens and train on the answer")
        dev = resolve_device(device)
        self.cfg = cfg
        self.src_embed = Embed(cfg.vocab_size, cfg.d_model, cfg, dev)
        self.src_pos = Embed(cfg.max_seq_len, cfg.d_model, cfg, dev)
        self.encoder = TransformerStack(
            dataclasses.replace(cfg, causal=False), dev)
        self.enc_ln_f = LayerNorm(cfg.d_model, cfg, dev)
        self.tgt_embed = Embed(cfg.vocab_size, cfg.d_model, cfg, dev)
        self.tgt_pos = Embed(cfg.max_seq_len, cfg.d_model, cfg, dev)
        # the flax names dec_i; dropout layers after the encoder's
        for i in range(cfg.n_layers):
            self.add_module(f"dec_{i}", DecoderBlock(
                cfg, dev, layer=cfg.n_layers + i))
        self.dec_ln_f = LayerNorm(cfg.d_model, cfg, dev)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """:func:`~.transformer.init_params` from ``generator`` with flax's
        default initializers, which the JAX module draws (it names none):
        the reversal task learns from them in the JAX test's 64 steps,
        and not from GPT-2's N(0, 0.02)."""
        init_params(self, generator, flax_defaults=True)

    def decoder_blocks(self):
        return [getattr(self, f"dec_{i}") for i in range(self.cfg.n_layers)]

    def forward(self, src_tokens: torch.Tensor, tgt_tokens: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        S, T = src_tokens.shape[1], tgt_tokens.shape[1]
        check_seq_len(cfg, S, what="source")
        check_seq_len(cfg, T, what="target")
        check_dropout_seed(cfg, deterministic, dropout_seed)
        mask = None if src_mask is None else padding_mask(src_mask)
        dev = src_tokens.device
        h = self.src_embed(src_tokens) + self.src_pos(
            torch.arange(S, device=dev)[None])
        h = self.encoder(h, deterministic=deterministic,
                         dropout_seed=dropout_seed, mask=mask)
        memory = self.enc_ln_f(h)
        x = self.tgt_embed(tgt_tokens) + self.tgt_pos(
            torch.arange(T, device=dev)[None])
        for block in self.decoder_blocks():
            x = block(x, memory, mask, deterministic, dropout_seed)
        x = self.dec_ln_f(x)
        return self.tgt_embed.attend(x).float()


def _reversal_pairs(num_samples: int, seq_len: int, vocab_size: int,
                    seed: int):
    """Source sequences and their reversals (teacher-forced targets),
    int32, the JAX package's draws. Token 0 is reserved as BOS for the
    shifted decoder input."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, vocab_size, size=(num_samples, seq_len))
    tgt = src[:, ::-1].copy()
    return src.astype(np.int32), tgt.astype(np.int32)


class Seq2SeqModule(TpuModule):
    """Sequence reversal: cross-attention's behavioral gate. AdamW with
    weight decay 0.01 on every parameter (optax's ``adamw``). A training
    step is deterministic iff ``config.dropout == 0``; with dropout it
    draws its masks' seed from the step's generator."""

    def __init__(self, config: Optional[TransformerConfig] = None,
                 batch_size: int = 16, seq_len: int = 16,
                 num_samples: int = 512, vocab_size: int = 64,
                 lr: float = 3e-3):
        super().__init__()
        if config is None:
            config = TransformerConfig(
                vocab_size=vocab_size, max_seq_len=seq_len, d_model=128,
                n_heads=4, n_layers=2, d_ff=256, causal=True)
        if seq_len > config.max_seq_len:
            raise ValueError(
                f"seq_len={seq_len} exceeds config.max_seq_len="
                f"{config.max_seq_len}; positions would silently clamp")
        self.cfg = config
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.num_samples = num_samples
        self.lr = lr

    def configure_model(self):
        # built on "meta": the trainer places and initialises it
        return Seq2SeqTransformer(self.cfg, device="meta")

    def configure_optimizers(self):
        return make_optimizer("adamw", self.lr, weight_decay=0.01)

    def _loader(self, seed: int):
        src, tgt = _reversal_pairs(self.num_samples, self.seq_len,
                                   self.cfg.vocab_size, seed)
        return DataLoader(ArrayDataset((src, tgt)),
                          batch_size=self.batch_size)

    def train_dataloader(self):
        return self._loader(0)

    def val_dataloader(self):
        return self._loader(1)

    @staticmethod
    def _shift_right(tgt: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.zeros_like(tgt[:, :1]), tgt[:, :-1]], dim=1)

    def _loss_acc(self, model, batch, generator=None):
        """(mean cross-entropy, token accuracy) of the f32 logits against
        the target; with a generator and dropout > 0 the step draws its
        masks' seed from it."""
        src, tgt = batch
        deterministic = generator is None or self.cfg.dropout == 0.0
        seed = None if deterministic else int(
            torch.randint(0, 2**62, (1,), generator=generator))
        logits = model(src, self._shift_right(tgt),
                       deterministic=deterministic, dropout_seed=seed)
        tgt = tgt.long()
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tgt.reshape(-1))
        acc = (logits.argmax(-1) == tgt).float().mean()
        return loss, acc

    def training_step(self, model, batch, generator):
        loss, acc = self._loss_acc(model, batch, generator)
        self.log("train_loss", loss)
        self.log("train_acc", acc)
        return loss

    def validation_step(self, model, batch, generator):
        loss, acc = self._loss_acc(model, batch)
        return {"val_loss": loss, "val_acc": acc}
