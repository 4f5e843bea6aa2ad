"""Transformer core of the port (counterpart of ``ray_lightning_tpu/models/transformer.py``).

GPT-style causal LM with f32 master weights and compute in
``cfg.dtype`` (bf16 by default), in three modes chosen by the arguments
of :meth:`TransformerLM.forward`:

- plain forward (``cache=None``): causal attention over the block;
- **shared-index cache** (``cache`` = a list of :class:`DenseKV`): the
  block of T tokens is written at the cache's index and attends the
  whole ``max_seq_len`` cache under an intra-block causal mask -- the
  serving prefill;
- **per-row cache** (``cache`` = a list of :class:`DenseKV` plus
  ``kv_positions`` (B, T)): each row block-writes its T tokens at its
  own positions and query ``q`` of row ``b`` attends keys
  ``<= kv_positions[b, q]`` -- a speculative draft's decode step;
- **page-native** (``cache`` = a list of :class:`PagedKV` plus
  ``page_table`` and ``kv_positions``): each row writes its T tokens'
  K/V straight into its arena pages and reads them back through the
  page table -- the serving decode step. The read side is
  ``attention_kernel="cuda"`` (the hand-written kernel,
  :func:`~ray_lightning_tpu_torch.models.paged_attention.paged_attention`)
  or ``"torch"`` (its plain version; the counterpart of the JAX
  package's ``"xla"``);
- **chunk** (``cache`` = a list of :class:`ChunkKV`): one chunk of one
  prompt at a page-aligned offset writes its pages and attends the
  row's earlier pages plus itself, causal and end-aligned -- the serving
  engine's chunked prefill, through the flash forward under
  ``attention_kernel="cuda"``.

**Quantized weights** (the JAX package's ``QuantDense``/``QuantEmbed``):
:meth:`TransformerLM.quantize_weights` (or
:meth:`TransformerLM.load_quantized`) swaps the f32 matrices -- every
Dense weight and both embedding tables -- for int8/int4
:class:`~ray_lightning_tpu_torch.models.quant.QTensor` codes in the flax
layout and drops the f32 copies. A quantized Dense and the tied LM head
then run ``matmul_kernel="cuda"`` (the fused dequant-matmul kernel,
:func:`~ray_lightning_tpu_torch.models.quantized_matmul.quantized_matmul`)
or ``"torch"`` (its plain version; JAX's ``"xla"``); the embedding
lookups gather code rows and dequantize only those. A model with no
quantized weights computes what it always did.

**LoRA** (``cfg.lora``, a :class:`~ray_lightning_tpu_torch.models.lora.LoraConfig`):
each targeted projection (``qkv``, ``out``, ``up``, ``down``) carries a
zero-initialized adapter bank, and ``forward(adapter_ids=)`` (B,) picks
each row's bank slot (−1 = the base model; None = slot 0, the training
path); the low-rank delta is added after the base projection, in plain
PyTorch (:func:`~ray_lightning_tpu_torch.models.lora.lora_delta`). A
JAX ``LoraConfig`` is taken by its fields. Quantization skips the banks:
they stay in the parameter dtype beside int8 or int4 codes.

The plain forward is the training path. Its attention is
``attention_impl="dot"`` (:func:`~ray_lightning_tpu_torch.ops.attention.dot_product_attention`,
its softmax in ``attention_softmax_dtype``)
or ``"flash"`` (:func:`~ray_lightning_tpu_torch.ops.flash_attention.flash_attention`:
the CUDA flash kernels, forward and backward, on the card; their plain
versions on the CPU). ``forward(deterministic=False, dropout_seed=s)``
with ``dropout > 0`` drops the attention weights and the MLP output, as
the JAX package does, each site's mask drawn by
:func:`~ray_lightning_tpu_torch.ops.dropout.dropout_keep` from ``(s,
layer, site)`` (a flash config then takes the dense attention on that
step, as JAX's ``flash_attention`` does). ``remat=True`` rematerializes
each block under ``remat_policy`` (:mod:`.remat`). The LM head is the
token embedding (``tie_embeddings=True``) or a Dense ``lm_head`` without
bias; ``return_hidden=True`` returns ``ln_f``'s output instead, for
:mod:`~ray_lightning_tpu_torch.ops.lm_head_loss`. The layers run in a
Python loop: the JAX package's ``scan_layers`` has no counterpart, and
:mod:`..interop` takes either weight layout.

**The encoder** (:class:`TransformerEncoder`, BERT's and the stack
ViT's models run on): token, position and optional segment embeddings,
a LayerNorm, then the stack under ``cfg.causal`` (False for the
encoder family) with a caller's padding mask. An additive ``mask``
(B, 1, 1|T, S) reaches every block's attention as the JAX package's
``mask=`` does: it sends ``attention_impl="flash"`` to the dense
attention (the kernels take no mask), and a row whose every key is
masked outputs exactly 0.

Caches and arenas are updated IN PLACE (JAX returns new ones): a
serving arena is the one large allocation of the engine and is never
copied. :class:`TransformerConfig` takes every field of the JAX config.
``scan_layers``, ``scan_unroll`` and ``decode`` have no counterpart and
change nothing (every module carries its caches). Not yet ported (they
raise ``NotImplementedError`` naming their ``ROADMAP.md`` item): the
ring/ulysses attention impls.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models import remat as _remat
from ray_lightning_tpu_torch.models.lora import (LoraConfig, as_lora_config,
                                                 lora_delta)
from ray_lightning_tpu_torch.models.paged_attention import (
    paged_attention, paged_attention_reference)
from ray_lightning_tpu_torch.models.quant import (QTensor, kv_dequantize,
                                                  kv_quantize, kv_scales,
                                                  quantize_params)
from ray_lightning_tpu_torch.models.quantized_matmul import (
    quantized_matmul, quantized_matmul_reference)
from ray_lightning_tpu_torch.ops import dropout as _dropout
from ray_lightning_tpu_torch.ops.attention import dot_product_attention
from ray_lightning_tpu_torch.ops.cuda_flash import flash_fwd_reference
from ray_lightning_tpu_torch.ops.flash_attention import flash_attention

ATTENTION_KERNELS = ("torch", "cuda")
MATMUL_KERNELS = ("torch", "cuda")
ATTENTION_IMPLS = ("dot", "flash")
REMAT_POLICIES = tuple(p for p in _remat.POLICIES if p is not None)
_BIG_NEG = torch.finfo(torch.float32).min


def _as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or scalar type, a
    name (``"float32"``), or anything ``np.dtype`` reads (JAX's
    ``jnp.float32``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        name = np.dtype(dtype).name
    except TypeError as exc:
        raise ValueError(f"not a dtype: {dtype!r}") from exc
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"no torch dtype for {dtype!r}")
    return out


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
    # matmuls of quantized weights: "torch" = the plain PyTorch version,
    # "cuda" = the fused dequant-matmul kernel (inert on plain weights)
    matmul_kernel: str = "torch"
    # -- the rest of the JAX config's fields, with its defaults --
    # layout knobs with no counterpart here: the layers always run in a
    # Python loop (interop takes either weight layout), and every module
    # carries its caches whatever ``decode`` says, so a JAX config's
    # values pass through and change nothing
    scan_layers: bool = True
    scan_unroll: int = 1
    decode: bool = False
    # None = rematerialize everything; the others keep matmul outputs
    # and named seats (models/remat.py)
    remat_policy: Optional[str] = None
    attention_softmax_dtype: object = torch.float32
    tie_embeddings: bool = True
    # rows of the encoder's segment table, built when the encoder is
    # asked for one (TransformerEncoder(segments=True))
    num_segments: int = 0
    lora: object = None

    def __post_init__(self):
        # the JAX config's own checks first, with its errors
        if self.scan_unroll < 1:
            raise ValueError(
                f"scan_unroll must be >= 1, got {self.scan_unroll}")
        if self.scan_unroll > 1 and not self.scan_layers:
            raise ValueError(
                "scan_unroll is set but scan_layers=False -- the unroll "
                "factor would be silently ignored; drop it or use "
                "scan_layers=True")
        if self.remat_policy is not None:
            if not self.remat:
                raise ValueError(
                    "remat_policy is set but remat=False -- the policy "
                    "would be silently ignored; pass remat=True (or drop "
                    "the policy)")
            if self.remat_policy not in REMAT_POLICIES:
                raise ValueError(
                    f"remat_policy must be one of {REMAT_POLICIES} or "
                    f"None, got {self.remat_policy!r}")
        # dtypes as torch dtypes, from a torch dtype or the numpy/str
        # spelling a JAX config's jnp.float32 stands for
        for name in ("dtype", "param_dtype", "attention_softmax_dtype"):
            object.__setattr__(self, name,
                               _as_torch_dtype(getattr(self, name)))
        # a JAX LoraConfig comes across by its fields
        object.__setattr__(self, "lora", as_lora_config(self.lora))
        if self.attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r} (sequence "
                "parallelism) is not ported yet (ROADMAP.md A, item 9: "
                "multi-axis meshes)")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {ATTENTION_IMPLS}, got "
                f"{self.attention_impl!r}")
        if self.attention_kernel not in ATTENTION_KERNELS:
            raise ValueError(
                f"attention_kernel must be one of {ATTENTION_KERNELS}, got "
                f"{self.attention_kernel!r}")
        if self.matmul_kernel not in MATMUL_KERNELS:
            raise ValueError(
                f"matmul_kernel must be one of {MATMUL_KERNELS}, got "
                f"{self.matmul_kernel!r}")
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


@dataclasses.dataclass
class ChunkKV:
    """One layer's view for a chunk of one prompt: the arena, the row's
    page-table entries ``row_pages`` (pages_per_slot,) on the arena's
    device (−1 = unmapped), and the chunk's absolute ``offset``, a
    multiple of the page size."""
    arena: PagedKV
    row_pages: torch.Tensor
    offset: int


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
def _lora_for(cfg: TransformerConfig, name: str) -> Optional[LoraConfig]:
    """The config's LoRA arming if it targets projection ``name``."""
    if cfg.lora is not None and name in cfg.lora.targets:
        return cfg.lora
    return None


def _quant_matmul(x: torch.Tensor, qt: QTensor, matmul_kernel: str,
                  transpose: bool = False) -> torch.Tensor:
    """One quantized-leaf contraction in the compute dtype: the fused
    kernel under "cuda", its plain version under "torch". Returns the
    flattened ``(..., N)``."""
    fn = (quantized_matmul if matmul_kernel == "cuda"
          else quantized_matmul_reference)
    return fn(x.contiguous(), qt, transpose)


class Dense(nn.Module):
    """``nn.Dense``/``nn.DenseGeneral`` of the JAX package: f32 master
    weight (out, in), computed in the compute dtype; or, once quantized,
    ``qweight`` (codes of the flax kernel ``(in, *features)``) and no f32
    weight (``QuantDense``/``QuantDenseGeneral``). ``bias=False`` is
    ``use_bias=False`` (the untied LM head). ``lora=`` (a
    :class:`LoraConfig`) arms an adapter bank, ``lora_A`` (N, in, r) and
    ``lora_B`` (N, r, out), zero-initialized (``LoraDense``)."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: TransformerConfig, device, bias: bool = True,
                 lora: Optional[LoraConfig] = None):
        super().__init__()
        self.dtype = cfg.dtype
        self.matmul_kernel = cfg.matmul_kernel
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            out_features, dtype=cfg.param_dtype, device=device)) \
            if bias else None
        self.qweight: Optional[QTensor] = None
        self.in_features, self.out_features = in_features, out_features
        self.lora_A: Optional[nn.Parameter] = None
        self.lora_B: Optional[nn.Parameter] = None
        self.lora_scale = 1.0
        if lora is not None:
            self.arm_lora(lora, cfg.param_dtype, device)

    def arm_lora(self, lora: LoraConfig, dtype: torch.dtype,
                 device=None) -> None:
        """Give this projection a zero adapter bank of ``lora``'s shape
        (replacing any it had)."""
        if device is None:
            device = (self.qweight.device if self.qweight is not None
                      else self.weight.device)
        n, r = lora.num_adapters, lora.rank
        self.lora_A = nn.Parameter(torch.zeros(
            n, self.in_features, r, dtype=dtype, device=device))
        self.lora_B = nn.Parameter(torch.zeros(
            n, r, self.out_features, dtype=dtype, device=device))
        self.lora_scale = lora.scale

    def forward(self, x, adapter_ids: Optional[torch.Tensor] = None):
        x_in = x
        x = x.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        if self.qweight is None:
            y = F.linear(x, self.weight.to(self.dtype), bias)
        else:
            y = _quant_matmul(x, self.qweight, self.matmul_kernel)
            y = y if bias is None else y + bias
        if self.lora_A is None:
            return y
        return lora_delta(x_in, y, self.lora_A, self.lora_B, adapter_ids,
                          self.lora_scale)


class Embed(nn.Embedding):
    """``nn.Embed`` of the JAX package: an f32 table (rows, d) looked up
    and rounded to the compute dtype; or, once quantized, ``qweight`` and
    no f32 table (``QuantEmbed``). :meth:`attend` is the tied LM head."""

    def __init__(self, rows: int, features: int, cfg: TransformerConfig,
                 device):
        # the table comes uninitialized: TransformerLM.reset_parameters
        # draws every row from its own generator. nn.Embedding's own
        # init would draw from torch's global generator (which the port
        # never uses) and, on a process's first call, import
        # torch.distributed.tensor and torch._dynamo (seconds a spawned
        # worker pays for nothing, on the meta device too)
        super().__init__(rows, features, _weight=torch.empty(
            (rows, features), device=device, dtype=cfg.param_dtype))
        self.dtype = cfg.dtype
        self.matmul_kernel = cfg.matmul_kernel
        self.qweight: Optional[QTensor] = None

    def forward(self, ids):
        if self.qweight is None:
            # gather the f32 rows, then round them: the lookup of a
            # compute-dtype table, without casting the whole table
            return self.weight[ids.long()].to(self.dtype)
        return self.qweight.take_rows(ids).to(self.dtype)

    def attend(self, x):
        """``x @ table.T`` in the compute dtype (flax ``Embed.attend``)."""
        if self.qweight is None:
            return F.linear(x, self.weight.to(self.dtype))
        return _quant_matmul(x.to(self.dtype), self.qweight,
                             self.matmul_kernel, transpose=True)


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
        self.qkv = Dense(cfg.d_model, 3 * hd, cfg, device,
                         lora=_lora_for(cfg, "qkv"))
        self.out = Dense(hd, cfg.d_model, cfg, device,
                         lora=_lora_for(cfg, "out"))

    def forward(self, x, kv_positions=None, page_table=None,
                kv: Union[DenseKV, PagedKV, None] = None,
                dropout_rng: Optional[int] = None, seats: bool = False,
                adapter_ids: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None):
        """``dropout_rng``: the integer seed of this layer's attention
        dropout (None: deterministic); ``seats``: inside a rematerialized
        block, the output goes through the ``attn_out`` seat;
        ``adapter_ids``: each row's LoRA bank slot; ``mask``: an additive
        f32 mask broadcast over (B, H, T, S) (the plain forward and the
        dense cache, as in the JAX package; the paged modes refuse
        one)."""
        cfg = self.cfg
        B, T, _ = x.shape
        if mask is not None and (page_table is not None
                                 or isinstance(kv, ChunkKV)):
            raise ValueError("the paged attention modes take no caller "
                             "mask")
        qkv = self.qkv(x, adapter_ids).view(B, T, 3, cfg.n_heads,
                                            cfg.head_dim)
        q, k, v = qkv.unbind(dim=2)
        # the softmax dtype reaches the dot impl only (flash keeps f32)
        softmax_dtype = (cfg.attention_softmax_dtype
                         if cfg.attention_impl == "dot" else torch.float32)
        if isinstance(kv, ChunkKV):
            out = self._chunk_attention(q, k, v, kv)
        elif page_table is not None:
            out = self._page_native_attention(q, k, v, kv_positions,
                                              page_table, kv)
        elif kv is not None:
            k, v, cache_mask = self._decode_cache(k, v, kv, kv_positions)
            # both are additive 0 / finfo.min biases
            mask = cache_mask if mask is None else mask + cache_mask
            out = dot_product_attention(q, k, v, mask=mask,
                                        softmax_dtype=softmax_dtype)
        else:
            rate = cfg.dropout if dropout_rng is not None else 0.0
            # a mask sends flash to the dense attention, as in JAX
            if cfg.attention_impl == "flash":
                out = flash_attention(q, k, v, causal=cfg.causal, mask=mask,
                                      dropout_rate=rate,
                                      dropout_rng=dropout_rng)
            else:
                out = dot_product_attention(q, k, v, causal=cfg.causal,
                                            mask=mask, dropout_rate=rate,
                                            dropout_rng=dropout_rng,
                                            softmax_dtype=softmax_dtype)
            out = _remat.checkpoint_name(out, "attn_out", seats)
        return self.out(out.reshape(B, T, cfg.n_heads * cfg.head_dim),
                        adapter_ids)

    def _decode_cache(self, k, v, cache: DenseKV, kv_positions=None):
        """Dense cache write, then the mask over the whole cache.

        Shared index (``kv_positions=None``, the prefill path): the T
        tokens land at ``cache.index`` and query ``i`` of the block
        attends every cache position ``<= index + i``.

        Per row (``kv_positions`` (B, T), the contiguous run
        ``kv_positions[b, 0] + 0..T-1``): row ``b`` writes its T tokens
        from that start (clamped so the block fits, as
        ``lax.dynamic_update_slice`` clamps) and its query ``q`` attends
        keys ``<= kv_positions[b, q]``. ``cache.index`` advances by T as
        bookkeeping only."""
        if not isinstance(cache, DenseKV):
            raise ValueError(
                "a cached forward without page_table needs DenseKV caches "
                "(models.transformer.new_cache)")
        B, T = k.shape[:2]
        S = cache.key.shape[1]
        key_pos = torch.arange(S, device=k.device)
        if kv_positions is not None:
            pos = kv_positions.long()
            start = pos[:, 0].clamp(0, S - T)
            cols = start[:, None] + torch.arange(T, device=k.device)
            rows = torch.arange(B, device=k.device)[:, None]
            cache.key[rows, cols] = k
            cache.value[rows, cols] = v
            cache.index += T
            mask = torch.where(key_pos[None, None, :] <= pos[:, :, None],
                               0.0, _BIG_NEG)               # (B, T, S)
            return cache.key, cache.value, mask[:, None]
        idx = cache.index
        if idx + T > cache.key.shape[1]:
            raise ValueError(
                f"cache write of {T} tokens at index {idx} overruns "
                f"max_seq_len {cache.key.shape[1]}")
        cache.key[:, idx:idx + T] = k
        cache.value[:, idx:idx + T] = v
        cache.index = idx + T
        q_pos = idx + torch.arange(T, device=k.device)
        mask = torch.where(key_pos[None, :] <= q_pos[:, None], 0.0, _BIG_NEG)
        return cache.key, cache.value, mask[None, None]

    def _chunk_attention(self, q, k, v, chunk: ChunkKV):
        """A chunk of one prompt (batch 1, C tokens at ``chunk.offset``)
        through the row's pages.

        Write: the chunk covers C / page_size whole pages, each written
        once from the chunk's K/V (int8 arenas quantize each page once,
        with its own per-head scales); an unmapped column goes to the
        sink. Read: the row's earlier pages, gathered (and dequantized),
        then the chunk's own K/V as computed, so query ``i`` attends
        keys ``<= offset + i``: causal attention over a suffix,
        end-aligned -- the flash forward (K2) under
        ``attention_kernel="cuda"``, its plain version under
        ``"torch"``."""
        kv = chunk.arena
        B, C = k.shape[:2]
        P, ps = kv.num_pages, kv.k.shape[1]
        off = chunk.offset
        if B != 1 or off % ps or C % ps:
            raise ValueError(
                f"a chunk is one row of whole pages at a page-aligned "
                f"offset: got batch {B}, {C} tokens at offset {off}, "
                f"page_size {ps}")
        cols = chunk.row_pages[off // ps:(off + C) // ps].long()
        widx = torch.where(cols >= 0, cols, P)          # −1 -> sink page
        prev = chunk.row_pages[:off // ps].long().clamp(0, P - 1)
        keys = []
        for store, scales, new in ((kv.k, kv.k_scale, k),
                                   (kv.v, kv.v_scale, v)):
            pages = new[0].reshape(C // ps, ps, *new.shape[2:])
            if scales is None:
                store[widx] = pages.to(store.dtype)
                old = store[prev]
            else:
                ns = kv_scales(pages, (1, 3))
                store[widx] = kv_quantize(pages, ns)
                scales[widx] = ns
                old = kv_dequantize(store[prev], scales[prev], new.dtype)
            keys.append(torch.cat([old.reshape(1, off, *new.shape[2:]),
                                   new], dim=1))
        if self.cfg.attention_kernel == "cuda":
            return flash_attention(q, keys[0], keys[1], causal=True)
        return flash_fwd_reference(q, keys[0], keys[1], True)[0]

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
        self.rate = cfg.dropout
        self.up = Dense(cfg.d_model, cfg.d_ff, cfg, device,
                        lora=_lora_for(cfg, "up"))
        self.down = Dense(cfg.d_ff, cfg.d_model, cfg, device,
                          lora=_lora_for(cfg, "down"))

    def forward(self, x, dropout_rng: Optional[int] = None,
                seats: bool = False,
                adapter_ids: Optional[torch.Tensor] = None):
        # flax nn.gelu is the tanh approximation
        h = F.gelu(self.up(x, adapter_ids), approximate="tanh")
        h = self.down(_remat.checkpoint_name(h, "mlp_act", seats),
                      adapter_ids)
        if dropout_rng is not None:
            h = _dropout.apply_dropout(h, self.rate, dropout_rng)
        return h


class TransformerBlock(nn.Module):
    """One pre-LN block, layer ``layer`` of the stack (its dropout sites'
    seeds are drawn from it)."""

    def __init__(self, cfg: TransformerConfig, device, layer: int = 0):
        super().__init__()
        self.cfg = cfg
        self.layer = layer
        self.ln1 = LayerNorm(cfg.d_model, cfg, device)
        self.attn = MultiHeadAttention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, cfg, device)
        self.mlp = MlpBlock(cfg, device)

    def forward(self, x, kv_positions=None, page_table=None, kv=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None, adapter_ids=None,
                mask: Optional[torch.Tensor] = None):
        if (self.cfg.remat and kv is None and page_table is None
                and torch.is_grad_enabled()):
            return _remat.checkpoint_block(
                self._remat_forward, x, deterministic, dropout_seed,
                adapter_ids, mask, policy=self.cfg.remat_policy)
        return self._forward(x, kv_positions, page_table, kv, deterministic,
                             dropout_seed, adapter_ids=adapter_ids,
                             mask=mask)

    def _remat_forward(self, x, deterministic, dropout_seed, adapter_ids,
                       mask):
        return self._forward(x, None, None, None, deterministic,
                             dropout_seed, seats=True,
                             adapter_ids=adapter_ids, mask=mask)

    def _forward(self, x, kv_positions, page_table, kv, deterministic,
                 dropout_seed, seats: bool = False, adapter_ids=None,
                 mask=None):
        attn_rng = mlp_rng = None
        if self.cfg.dropout > 0.0 and not deterministic:
            # derived here, inside a rematerialized region: the replay
            # redraws the same masks from the same integers
            attn_rng = _dropout.site_seed(dropout_seed, self.layer,
                                          _dropout.ATTENTION)
            mlp_rng = _dropout.site_seed(dropout_seed, self.layer,
                                         _dropout.MLP)
        x = x + self.attn(self.ln1(x), kv_positions=kv_positions,
                          page_table=page_table, kv=kv, dropout_rng=attn_rng,
                          seats=seats, adapter_ids=adapter_ids, mask=mask)
        return x + self.mlp(self.ln2(x), dropout_rng=mlp_rng, seats=seats,
                            adapter_ids=adapter_ids)


class TransformerStack(nn.Module):
    """The unrolled layer stack (the JAX package's ``scan_layers=False``
    layout; scanned weights convert in :mod:`..interop`)."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg, device, layer=i)
            for i in range(cfg.n_layers))

    def forward(self, x, kv_positions=None, page_table=None,
                cache: Optional[Sequence] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None, adapter_ids=None,
                mask: Optional[torch.Tensor] = None):
        for i, block in enumerate(self.blocks):
            x = block(x, kv_positions=kv_positions, page_table=page_table,
                      kv=None if cache is None else cache[i],
                      deterministic=deterministic, dropout_seed=dropout_seed,
                      adapter_ids=adapter_ids, mask=mask)
        return x


@functools.lru_cache(maxsize=16)
def jax_leaves(cfg: TransformerConfig
               ) -> Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]:
    """The JAX LM's parameter leaves over the port's parameters:
    ``(leaf shape, positions in TransformerLM.parameters())`` pairs, for
    :func:`~ray_lightning_tpu_torch.core.optim.make_optimizer`'s
    ``leaves=``. The JAX LM trains with its layers scanned
    (``scan_layers=True``), so every block parameter is one layer of a
    leaf stacked over ``n_layers``, in the flax layout (the qkv kernel
    ``(L, d, 3, H, D)``, its bias ``(L, 3, H, D)``); the embeddings and
    the final LayerNorm are leaves of their own."""
    from ray_lightning_tpu_torch.interop import flax_layout
    leaves: Dict[str, Tuple[Tuple[int, ...], List[int]]] = {}
    for i, (name, p) in enumerate(
            TransformerLM(cfg, device="meta").named_parameters()):
        shape = tuple(flax_layout(name, p, cfg.n_heads).shape)
        if name.endswith("attn.qkv.bias"):
            shape = (3, cfg.n_heads, cfg.head_dim)
        parts = name.split(".")
        if parts[:2] == ["stack", "blocks"]:
            name = ".".join(parts[3:])
            shape = (cfg.n_layers,) + shape
        leaves.setdefault(name, (shape, []))[1].append(i)
    return tuple((shape, tuple(idx)) for shape, idx in leaves.values())


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


#: flax's ``lecun_normal``: a normal truncated at two standard
#: deviations, rescaled to the variance 1 / fan_in
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_params(module: nn.Module,
                generator: Optional[torch.Generator] = None,
                zeros: Sequence[str] = (),
                flax_defaults: bool = False) -> None:
    """GPT-2- and BERT-style init in place: N(0, 0.02) for every matrix,
    embedding and learned position table, zero biases, adapter banks (a
    fresh slot is the null adapter, as the JAX ``LoraDense`` inits it)
    and parameters named in ``zeros``, unit LayerNorm scales.
    ``flax_defaults``: flax's own initializers for the matrices instead,
    as a flax module that names none draws them -- each ``Dense`` weight
    ``lecun_normal`` over its input width (variance 1 / in, truncated at
    two standard deviations), each ``Embed`` table N(0, 1 / features).
    Every draw comes from ``generator`` (a CPU ``torch.Generator``; None =
    a fresh one seeded 0), in ``named_parameters()`` order, made on the
    CPU and copied to the parameter's device; meta parameters are
    skipped. torch's global generator is never used."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    scales = {id(m.weight) for m in module.modules()
              if isinstance(m, LayerNorm)}
    # flax's standard deviations by parameter: Dense weights truncated,
    # Embed tables not
    dense, embed = {}, {}
    if flax_defaults:
        for m in module.modules():
            if isinstance(m, Dense) and m.qweight is None:
                dense[id(m.weight)] = m.in_features ** -0.5
            elif isinstance(m, Embed) and m.qweight is None:
                embed[id(m.weight)] = m.embedding_dim ** -0.5
    for name, p in module.named_parameters():
        if p.device.type == "meta":
            continue
        if id(p) in scales:
            p.fill_(1.0)
        elif name.endswith("bias") or ".lora_" in name or name in zeros:
            p.zero_()
        elif id(p) in dense:
            p.copy_(nn.init.trunc_normal_(
                torch.empty(p.shape, dtype=p.dtype), 0.0, 1.0, -2.0, 2.0,
                generator=generator) * (dense[id(p)] / _TRUNCATED_STD))
        else:
            p.copy_(torch.empty(p.shape, dtype=p.dtype).normal_(
                0.0, embed.get(id(p), 0.02), generator=generator))


def check_dropout_seed(cfg: TransformerConfig, deterministic: bool,
                       dropout_seed: Optional[int]) -> None:
    """A training forward with dropout needs the integer its masks
    derive from."""
    if cfg.dropout > 0.0 and not deterministic and dropout_seed is None:
        raise ValueError("deterministic=False with dropout > 0 needs "
                         "dropout_seed (the integer the masks derive "
                         "from)")


class TransformerLM(nn.Module):
    """GPT-style causal LM: token + learned position embeddings, the
    layer stack, final LayerNorm, and the LM head: tied to the token
    embedding, or (``tie_embeddings=False``) a Dense ``lm_head`` without
    bias, the flax kernel (d_model, vocab).

    ``forward(tokens)`` returns f32 logits (B, T, vocab);
    ``return_hidden=True`` returns ``ln_f``'s output (B, T, d_model) in
    the compute dtype instead. ``positions`` (B|1, T) overrides the
    default 0..T-1 position ids (the cached modes pass each token's
    absolute position); ``cache``, ``kv_positions`` and ``page_table``
    select the cached modes of the module docstring. ``deterministic=
    False`` with ``dropout > 0`` needs ``dropout_seed``, an integer the
    step's masks derive from. ``adapter_ids`` (B,) picks each row's
    LoRA bank slot on a model with banks (−1 = base; None = slot 0).
    ``device=None`` builds on the card.
    """

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.d_model, cfg, dev)
        self.wpe = Embed(cfg.max_seq_len, cfg.d_model, cfg, dev)
        self.stack = TransformerStack(cfg, dev)
        self.ln_f = LayerNorm(cfg.d_model, cfg, dev)
        self.lm_head = None if cfg.tie_embeddings else Dense(
            cfg.d_model, cfg.vocab_size, cfg, dev, bias=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """GPT-2-style init: N(0, 0.02) embeddings and projections, zero
        biases, unit LayerNorm scales. Every draw comes from ``generator``
        (a CPU ``torch.Generator``; None = a fresh one seeded 0), made on
        the CPU and copied to the parameter's device, so a seed gives the
        same weights on any device; torch's global generator is never
        used."""
        init_params(self, generator)

    @property
    def device(self) -> torch.device:
        return self.ln_f.weight.device

    # ----------------------------------------------------- quantization
    def quantize_weights(self, weight_dtype: str,
                         group_size: Optional[int] = None) -> "TransformerLM":
        """Quantize every matrix in place (JAX ``quantize_params`` on the
        flax-layout views, so the codes and scales are JAX's) and drop
        the f32 copies. Returns the model."""
        from ray_lightning_tpu_torch.interop import flax_weights
        with torch.no_grad():
            self.load_quantized(quantize_params(flax_weights(self),
                                                weight_dtype, group_size))
        return self

    def load_quantized(self, weights: Mapping[str, QTensor]) -> None:
        """Install quantized matrices, keyed by the state-dict names of
        the f32 weights they replace (``"wte.weight"``,
        ``"stack.blocks.0.attn.qkv.weight"``, ...), each a
        :class:`QTensor` of the flax-layout leaf; the f32 weights go."""
        from ray_lightning_tpu_torch.interop import flax_layout
        for name, qt in weights.items():
            path, leaf = name.rsplit(".", 1)
            mod = self.get_submodule(path)
            if leaf != "weight" or not isinstance(mod, (Dense, Embed)):
                raise ValueError(f"{name} is not a quantizable weight")
            if mod.qweight is not None:
                raise ValueError(f"{name} is already quantized")
            want = tuple(flax_layout(name, mod.weight,
                                     self.cfg.n_heads).shape)
            if not isinstance(qt, QTensor) or qt.shape != want:
                raise ValueError(f"{name} needs a QTensor of the flax-layout "
                                 f"shape {want}, got {qt!r}")
            qt = qt.to(mod.weight.device)
            del mod.weight
            mod.qweight = qt

    def named_weights(self) -> Dict[str, Union[torch.Tensor, QTensor]]:
        """Every parameter by its state-dict name, quantized matrices as
        their :class:`QTensor` (``quant.param_bytes`` of this is the
        model's at-rest bytes)."""
        out: Dict[str, Union[torch.Tensor, QTensor]] = dict(
            self.named_parameters())
        for name, mod in self.named_modules():
            if isinstance(mod, (Dense, Embed)) and mod.qweight is not None:
                out[f"{name}.weight"] = mod.qweight
        return out

    def forward(self, tokens: torch.Tensor, positions=None,
                kv_positions=None, page_table=None,
                cache=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None,
                return_hidden: bool = False,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        T = tokens.shape[1]
        if positions is None:
            check_seq_len(cfg, T)
            positions = torch.arange(T, device=tokens.device)[None]
        if page_table is not None and kv_positions is None:
            raise ValueError("page_table needs kv_positions")
        check_dropout_seed(cfg, deterministic, dropout_seed)
        x = self.wte(tokens) + self.wpe(positions)
        x = self.stack(x, kv_positions=kv_positions, page_table=page_table,
                       cache=cache, deterministic=deterministic,
                       dropout_seed=dropout_seed, adapter_ids=adapter_ids)
        x = self.ln_f(x)
        if return_hidden:
            return x
        # the LM head: tied to the token embedding (wte.attend in flax),
        # or the untied lm_head
        logits = (self.wte.attend(x) if self.lm_head is None
                  else self.lm_head(x))
        return logits.float()


def padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """The additive (B, 1, 1, S) f32 mask of a (B, S) padding mask: 0
    where ``attention_mask > 0``, ``finfo(f32).min`` elsewhere."""
    return torch.where(attention_mask[:, None, None, :] > 0, 0.0, _BIG_NEG)


class TransformerEncoder(nn.Module):
    """BERT-style encoder (counterpart of the JAX ``TransformerEncoder``):
    token and learned position embeddings, a segment embedding when
    built with ``segments=True``, ``embed_ln``, then the stack (causal as
    ``cfg.causal`` says: False in ``bert_config``).

    ``segments``: flax creates ``seg_embed`` only in a call that passes
    ``segment_ids`` (and ``cfg.num_segments > 0``), so a model that never
    passes them -- ``BertClassifier`` -- has no such table; here the
    table is built when asked for, and ``segment_ids`` without it raise.
    ``forward(tokens, attention_mask=None, segment_ids=None)`` returns
    the stack's output (B, T, d_model) in the compute dtype;
    ``attention_mask`` (B, T), nonzero where a key is real, masks the
    padding keys of every query. ``device=None`` builds on the card.
    """

    def __init__(self, cfg: TransformerConfig, device=None,
                 segments: bool = False):
        super().__init__()
        if segments and cfg.num_segments <= 0:
            raise ValueError("segments=True needs cfg.num_segments > 0")
        dev = resolve_device(device)
        self.cfg = cfg
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, cfg, dev)
        self.pos_embed = Embed(cfg.max_seq_len, cfg.d_model, cfg, dev)
        self.seg_embed = (Embed(cfg.num_segments, cfg.d_model, cfg, dev)
                          if segments else None)
        self.embed_ln = LayerNorm(cfg.d_model, cfg, dev)
        self.stack = TransformerStack(cfg, dev)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """:func:`init_params` from ``generator``."""
        init_params(self, generator)

    def forward(self, tokens: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        T = tokens.shape[1]
        check_seq_len(cfg, T)
        check_dropout_seed(cfg, deterministic, dropout_seed)
        x = self.tok_embed(tokens) + self.pos_embed(
            torch.arange(T, device=tokens.device)[None])
        if segment_ids is not None:
            if self.seg_embed is None:
                raise ValueError(
                    "segment_ids given to an encoder built without a "
                    "segment table (TransformerEncoder(segments=True))")
            x = x + self.seg_embed(segment_ids)
        x = self.embed_ln(x)
        mask = None if attention_mask is None else padding_mask(
            attention_mask)
        return self.stack(x, deterministic=deterministic,
                          dropout_seed=dropout_seed, mask=mask)
