"""Transformer core of the port (counterpart of ``ray_lightning_tpu/models/transformer.py``).

GPT-style causal LM with f32 master weights and compute in
``cfg.dtype`` (bf16 by default), in three modes chosen by the arguments
of :meth:`TransformerLM.forward`:

- plain forward (``cache=None``): causal attention over the block;
- **shared-index cache** (``cache`` = a list of :class:`DenseKV`): the
  block of T tokens is written at the cache's index and attends the
  whole ``max_seq_len`` cache under an intra-block causal mask -- the
  serving prefill;
- **page-native** (``cache`` = a list of :class:`PagedKV` plus
  ``page_table`` and ``kv_positions``): each row writes its T tokens'
  K/V straight into its arena pages and reads them back through the
  page table -- the serving decode step. The read side is
  ``attention_kernel="cuda"`` (the hand-written kernel,
  :func:`~ray_lightning_tpu_torch.models.paged_attention.paged_attention`)
  or ``"torch"`` (its plain version; the counterpart of the JAX
  package's ``"xla"``).

The plain forward is the training path. Its attention is
``attention_impl="dot"`` (:func:`~ray_lightning_tpu_torch.ops.attention.dot_product_attention`)
or ``"flash"`` (:func:`~ray_lightning_tpu_torch.ops.flash_attention.flash_attention`:
the CUDA flash kernels, forward and backward, on the card; their plain
versions on the CPU). The layers run in a Python loop: the JAX package's
``scan_layers`` has no counterpart, and :mod:`..interop` takes either
weight layout.

Caches and arenas are updated IN PLACE (JAX returns new ones): a
serving arena is the one large allocation of the engine and is never
copied. Not yet ported (they raise ``NotImplementedError``): remat,
dropout, the ring/ulysses attention impls; nor are LoRA and quantized
weights.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.paged_attention import (
    paged_attention, paged_attention_reference)
from ray_lightning_tpu_torch.models.quant import (kv_dequantize, kv_quantize,
                                                  kv_scales)
from ray_lightning_tpu_torch.ops.attention import dot_product_attention
from ray_lightning_tpu_torch.ops.flash_attention import flash_attention

ATTENTION_KERNELS = ("torch", "cuda")
ATTENTION_IMPLS = ("dot", "flash")
_BIG_NEG = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    max_seq_len: int = 1024
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16        # compute dtype
    param_dtype: torch.dtype = torch.float32   # master weights
    causal: bool = True
    dropout: float = 0.0
    remat: bool = False
    # attention of the plain (training) forward: "dot" | "flash"
    attention_impl: str = "dot"
    # page-native read side: "torch" = the plain PyTorch version,
    # "cuda" = the hand-written paged-attention kernel
    attention_kernel: str = "torch"

    def __post_init__(self):
        if self.attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r} (sequence "
                "parallelism) is not ported yet (ROADMAP.md A, after the "
                "slices: ring_attention, ulysses)")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {ATTENTION_IMPLS}, got "
                f"{self.attention_impl!r}")
        if self.dropout > 0.0:
            raise NotImplementedError(
                "dropout > 0 is not ported yet (ROADMAP.md T3)")
        if self.remat:
            raise NotImplementedError(
                "remat=True is not ported yet (ROADMAP.md T3)")
        if self.attention_kernel not in ATTENTION_KERNELS:
            raise ValueError(
                f"attention_kernel must be one of {ATTENTION_KERNELS}, got "
                f"{self.attention_kernel!r}")
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model ({self.d_model}) must be a multiple of n_heads "
                f"({self.n_heads})")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ------------------------------------------------------------ KV storage
@dataclasses.dataclass
class DenseKV:
    """One layer's shared-index decode cache: ``key``/``value``
    (B, max_seq_len, H, D) in the compute dtype, written at ``index``."""
    key: torch.Tensor
    value: torch.Tensor
    index: int = 0


@dataclasses.dataclass
class PagedKV:
    """One layer's paged KV arena.

    ``k``/``v`` are (num_pages + 1, page_size, H, D): the compute dtype,
    or int8 codes with ``k_scale``/``v_scale`` (num_pages + 1, 1, H, 1)
    f32 per-page-per-head absmax scales. The last page is a **sink**:
    PyTorch has no drop-mode scatter (JAX's ``.at[].set(mode="drop")``),
    so a write whose row has no page (page-table entry −1) lands there
    instead; reads never see it (:meth:`pages` and the clamps stop at
    page ``num_pages - 1``).
    """
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_pages(self) -> int:
        return self.k.shape[0] - 1

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def pages(self):
        """The readable arena, without the sink: (k, v, k_scale, v_scale)
        views (scales None on full-precision arenas)."""
        P = self.num_pages
        if not self.quantized:
            return self.k[:P], self.v[:P], None, None
        return self.k[:P], self.v[:P], self.k_scale[:P], self.v_scale[:P]


def new_cache(cfg: TransformerConfig, batch: int,
              device: torch.device) -> List[DenseKV]:
    """Zeroed shared-index caches, one per layer."""
    shape = (batch, cfg.max_seq_len, cfg.n_heads, cfg.head_dim)
    return [DenseKV(torch.zeros(shape, dtype=cfg.dtype, device=device),
                    torch.zeros(shape, dtype=cfg.dtype, device=device))
            for _ in range(cfg.n_layers)]


def new_arena(cfg: TransformerConfig, num_pages: int, page_size: int,
              quantized: bool, device: torch.device) -> List[PagedKV]:
    """Zeroed paged arenas, one per layer (int8: zero codes, unit
    scales), each with its sink page."""
    shape = (num_pages + 1, page_size, cfg.n_heads, cfg.head_dim)
    dtype = torch.int8 if quantized else cfg.dtype

    def scales():
        if not quantized:
            return None
        return torch.ones((num_pages + 1, 1, cfg.n_heads, 1),
                          dtype=torch.float32, device=device)

    return [PagedKV(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device),
                    scales(), scales())
            for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------- layers
class Dense(nn.Module):
    """``nn.Dense``/``nn.DenseGeneral`` of the JAX package: f32 master
    weight (out, in), computed in the compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: TransformerConfig, device):
        super().__init__()
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            out_features, dtype=cfg.param_dtype, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: epsilon 1e-6 (torch's default is 1e-5),
    statistics in f32 with the one-pass variance ``E[x²] − E[x]²``
    clipped at 0, output in the compute dtype."""

    def __init__(self, features: int, cfg: TransformerConfig, device,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = cfg.dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(
            features, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            features, dtype=cfg.param_dtype, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        hd = cfg.n_heads * cfg.head_dim
        # qkv weight rows are ordered (3, H, head_dim), like the flax
        # DenseGeneral kernel's (d, 3, H, head_dim) feature axes
        self.qkv = Dense(cfg.d_model, 3 * hd, cfg, device)
        self.out = Dense(hd, cfg.d_model, cfg, device)

    def forward(self, x, kv_positions=None, page_table=None,
                kv: Union[DenseKV, PagedKV, None] = None):
        cfg = self.cfg
        B, T, _ = x.shape
        qkv = self.qkv(x).view(B, T, 3, cfg.n_heads, cfg.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if page_table is not None:
            out = self._page_native_attention(q, k, v, kv_positions,
                                              page_table, kv)
        elif kv is not None:
            k, v, mask = self._decode_cache(k, v, kv)
            out = dot_product_attention(q, k, v, mask=mask)
        elif cfg.attention_impl == "flash":
            out = flash_attention(q, k, v, causal=cfg.causal)
        else:
            out = dot_product_attention(q, k, v, causal=cfg.causal)
        return self.out(out.reshape(B, T, cfg.n_heads * cfg.head_dim))

    def _decode_cache(self, k, v, cache: DenseKV):
        """Shared-index block write (the prefill path): the T tokens land
        at ``cache.index`` and query ``i`` of the block attends every
        cache position ``<= index + i``."""
        if not isinstance(cache, DenseKV):
            raise ValueError(
                "a cached forward without page_table needs DenseKV caches "
                "(models.transformer.new_cache)")
        T = k.shape[1]
        idx = cache.index
        if idx + T > cache.key.shape[1]:
            raise ValueError(
                f"cache write of {T} tokens at index {idx} overruns "
                f"max_seq_len {cache.key.shape[1]}")
        cache.key[:, idx:idx + T] = k
        cache.value[:, idx:idx + T] = v
        cache.index = idx + T
        key_pos = torch.arange(cache.key.shape[1], device=k.device)
        q_pos = idx + torch.arange(T, device=k.device)
        mask = torch.where(key_pos[None, :] <= q_pos[:, None], 0.0, _BIG_NEG)
        return cache.key, cache.value, mask[None, None]

    def _page_native_attention(self, q, k, v, kv_positions, page_table,
                               kv: PagedKV):
        """Cached attention straight through a page arena.

        Write half first (the block attends its own just-written K/V):
        token ``t`` of row ``b`` lands at page
        ``page_table[b, pos // page_size]``, offset ``pos % page_size``;
        rows whose entry is −1 write into the sink page. int8 pages are
        read-modify-requantized one page per token, as in the JAX
        package. Then the read side: the kernel or its plain version.
        """
        if kv_positions is None:
            raise ValueError(
                "page-native attention is a serving-engine mode and needs "
                "per-row kv_positions (each row's absolute positions)")
        if not isinstance(kv, PagedKV):
            raise ValueError(
                "page-native attention needs the layer's PagedKV arena "
                "(models.transformer.new_arena) as its cache")
        B, T = k.shape[:2]
        P, ps = kv.num_pages, kv.k.shape[1]
        pos = kv_positions.to(torch.int32)
        rows = torch.arange(B, device=k.device)
        for t in range(T):
            col = (pos[:, t] // ps).long()
            off = (pos[:, t] % ps).long()
            pidx = page_table.gather(1, col[:, None])[:, 0].long()
            widx = torch.where(pidx >= 0, pidx, P)      # −1 -> sink page
            if not kv.quantized:
                kv.k[widx, off] = k[:, t].to(kv.k.dtype)
                kv.v[widx, off] = v[:, t].to(kv.v.dtype)
                continue
            g = pidx.clamp(0, P - 1)
            for store, scales, new in ((kv.k, kv.k_scale, k),
                                       (kv.v, kv.v_scale, v)):
                page = kv_dequantize(store[g], scales[g], new.dtype)
                page[rows, off] = new[:, t]
                ns = kv_scales(page, (1, 3))
                store[widx] = kv_quantize(page, ns)
                scales[widx] = ns

        read = (paged_attention if self.cfg.attention_kernel == "cuda"
                else paged_attention_reference)
        k_pages, v_pages, k_scales, v_scales = kv.pages()
        return read(q.contiguous(), k_pages, v_pages, k_scales, v_scales,
                    pos.contiguous(), page_table)


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.up = Dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.down = Dense(cfg.d_ff, cfg.d_model, cfg, device)

    def forward(self, x):
        # flax nn.gelu is the tanh approximation
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg, device)
        self.attn = MultiHeadAttention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, cfg, device)
        self.mlp = MlpBlock(cfg, device)

    def forward(self, x, kv_positions=None, page_table=None, kv=None):
        x = x + self.attn(self.ln1(x), kv_positions=kv_positions,
                          page_table=page_table, kv=kv)
        return x + self.mlp(self.ln2(x))


class TransformerStack(nn.Module):
    """The unrolled layer stack (the JAX package's ``scan_layers=False``
    layout; scanned weights convert in :mod:`..interop`)."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg, device) for _ in range(cfg.n_layers))

    def forward(self, x, kv_positions=None, page_table=None,
                cache: Optional[Sequence] = None):
        for i, block in enumerate(self.blocks):
            x = block(x, kv_positions=kv_positions, page_table=page_table,
                      kv=None if cache is None else cache[i])
        return x


def latch_eos(next_tokens: torch.Tensor, done: torch.Tensor,
              eos_id: torch.Tensor):
    """Per-row eos latching: rows already ``done`` keep emitting their eos
    id, rows that just sampled it latch ``done``. ``eos_id`` (B,) int;
    negative entries disable eos for that row. Returns ``(tokens,
    done)``."""
    has_eos = eos_id >= 0
    out = torch.where(done & has_eos, eos_id, next_tokens)
    done = done | (has_eos & (out == eos_id))
    return out, done


def check_seq_len(cfg: TransformerConfig, length: int,
                  what: str = "sequence") -> None:
    if length > cfg.max_seq_len:
        raise ValueError(
            f"{what} length {length} exceeds max_seq_len={cfg.max_seq_len}")


class TransformerLM(nn.Module):
    """GPT-style causal LM: token + learned position embeddings, the
    layer stack, final LayerNorm, LM head tied to the token embedding.

    ``forward(tokens)`` returns f32 logits (B, T, vocab). ``positions``
    (B|1, T) overrides the default 0..T-1 position ids (the cached modes
    pass each token's absolute position); ``cache``, ``kv_positions`` and
    ``page_table`` select the cached modes of the module docstring.
    ``device=None`` builds on the card.
    """

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, device=dev,
                                dtype=cfg.param_dtype)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model, device=dev,
                                dtype=cfg.param_dtype)
        self.stack = TransformerStack(cfg, dev)
        self.ln_f = LayerNorm(cfg.d_model, cfg, dev)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """GPT-2-style init: N(0, 0.02) embeddings and projections, zero
        biases, unit LayerNorm scales. Every draw comes from ``generator``
        (a CPU ``torch.Generator``; None = a fresh one seeded 0), made on
        the CPU and copied to the parameter's device, so a seed gives the
        same weights on any device; torch's global generator is never
        used."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, p in self.named_parameters():
            if p.device.type == "meta":
                continue
            if name.endswith("bias"):
                p.zero_()
            elif ".ln" in name or name.startswith("ln_f"):
                p.fill_(1.0)
            else:
                p.copy_(torch.empty(p.shape, dtype=p.dtype).normal_(
                    0.0, 0.02, generator=generator))

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def forward(self, tokens: torch.Tensor, positions=None,
                kv_positions=None, page_table=None,
                cache=None) -> torch.Tensor:
        cfg = self.cfg
        T = tokens.shape[1]
        if positions is None:
            check_seq_len(cfg, T)
            positions = torch.arange(T, device=tokens.device)[None]
        if page_table is not None and kv_positions is None:
            raise ValueError("page_table needs kv_positions")
        # gather the f32 rows, then round them: the lookup of a
        # compute-dtype table, without casting the whole table
        x = (self.wte.weight[tokens.long()].to(cfg.dtype)
             + self.wpe.weight[positions.long()].to(cfg.dtype))
        x = self.stack(x, kv_positions=kv_positions, page_table=page_table,
                       cache=cache)
        x = self.ln_f(x)
        # the LM head is tied to the token embedding (wte.attend in flax)
        logits = F.linear(x, self.wte.weight.to(cfg.dtype))
        return logits.float()
