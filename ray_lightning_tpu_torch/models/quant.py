"""Absmax quantization (counterpart of ``ray_lightning_tpu/models/quant.py``).

Two halves:

- **KV helpers** (:func:`kv_scales`, :func:`kv_quantize`,
  :func:`kv_dequantize`), shared by the page-native write half
  (``models/transformer.py``), the prefill page scatter
  (``serve/pages.py``) and the plain paged-attention read side.
- **Weight-only quantization**: :class:`QTensor` (int8 or int4 codes plus
  f32 scales), :func:`quantize_params`, :func:`dequantize_params`,
  :func:`is_quantized`, :func:`param_bytes` and :func:`matmul_view`, the
  kernel-input views the fused dequant-matmul
  (:mod:`~ray_lightning_tpu_torch.models.quantized_matmul`) reads.

The weight functions follow the JAX package leaf for leaf: a leaf here is
a tensor in the **flax layout** (``(in, *features)`` Dense kernels, the
``(d, 3, H, head_dim)`` qkv kernel, ``(rows, d)`` embeddings;
:func:`~ray_lightning_tpu_torch.interop.flax_weights` gives those views of
a port model), and scales run per slice of the leaf's last axis, so the
codes and scales are byte-equal to JAX ``quantize_params``:

- ``"int8"`` -- one f32 scale per slice along the leaf's LAST axis
  (all other axes reduced): ``|deq - w| <= amax / 254``. The qkv kernel's
  last axis is head_dim, so its 64 scales are shared by all 3·H heads.
- ``"int4"`` -- groups of ``group_size`` along the last axis, one f32
  scale each, codes in [-7, 7] packed two per int8, low nibble first.

The arithmetic matches JAX's exactly: the true division ``w / scale``
(not a multiply by the reciprocal), ``amax / 127.0`` and ``amax / 7.0``
in f32, and ``torch.round``'s half-to-even, as ``jnp.round``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch

__all__ = ["QTensor", "DEFAULT_GROUP_SIZE", "check_weight_dtype",
           "pack_int4", "unpack_int4", "quantize_params",
           "dequantize_params", "is_quantized", "param_bytes",
           "matmul_view", "kv_scales", "kv_quantize", "kv_dequantize"]

#: default int4 group length along the last axis (divides every feature
#: dimension of the GPT-2 family: head_dim, d_model, d_ff)
DEFAULT_GROUP_SIZE = 64


def check_weight_dtype(weight_dtype) -> bool:
    """Normalize/validate a ``weight_dtype`` option; returns True for the
    quantized paths."""
    if weight_dtype is None:
        return False
    if weight_dtype in ("int8", "int4"):
        return True
    raise ValueError(
        f"weight_dtype must be None, 'int8' or 'int4', got "
        f"{weight_dtype!r}")


# ------------------------------------------------------------ kv helpers
def kv_scales(values: torch.Tensor,
              reduce_axes: Tuple[int, ...]) -> torch.Tensor:
    """Absmax scales over ``reduce_axes`` (keepdim), guarded so an
    all-zero group dequantizes to exact zeros instead of NaN."""
    amax = values.float().abs().amax(dim=reduce_axes, keepdim=True)
    return torch.where(amax > 0, amax / 127.0, 1.0)


def kv_quantize(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    # torch.round is round-half-to-even, like jnp.round
    return torch.clamp(torch.round(values.float() / scales),
                       -127, 127).to(torch.int8)


def kv_dequantize(q: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scales).to(dtype)


# ---------------------------------------------------------- int4 packing
def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (int8 values in [-8, 7], even-length last axis)
    two nibbles per int8, low nibble first: ``packed[..., i]`` holds
    ``codes[..., 2i]`` (low) and ``codes[..., 2i+1]`` (high)."""
    lo = codes[..., 0::2].to(torch.int32) & 0x0F
    hi = codes[..., 1::2].to(torch.int32) & 0x0F
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: sign-extend both nibbles (arithmetic
    shifts) and re-interleave to the doubled last axis."""
    p = packed.to(torch.int32)              # sign-extended byte
    lo = (p << 28) >> 28
    hi = p >> 4
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(*packed.shape[:-1], 2 * packed.shape[-1])


# ---------------------------------------------------------------- QTensor
class QTensor:
    """One quantized weight leaf: integer codes + f32 scales.

    ``bits == 8``: ``q`` has the leaf's (flax-layout) shape, int8 codes;
    ``scale`` reduces every axis but the last (keepdim). ``bits == 4``:
    ``q`` is nibble-packed (last axis halved) and ``scale`` is ``(...,
    last / group_size, 1)`` over the grouped view. ``shape`` and
    ``dtype`` record the original leaf. ``q`` and ``scale`` are always
    contiguous: the kernel reads them as they are.
    """

    __slots__ = ("q", "scale", "bits", "group_size", "shape", "dtype")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int,
                 group_size: Optional[int], shape: Tuple[int, ...],
                 dtype: torch.dtype):
        self.q = q.contiguous()
        self.scale = scale.contiguous()
        self.bits = bits
        self.group_size = group_size
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        """At-rest bytes: codes + scales."""
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device), self.bits,
                       self.group_size, self.shape, self.dtype)

    def dequantize(self) -> torch.Tensor:
        """Codes x scales in f32 -> the original-dtype leaf."""
        if self.bits == 8:
            return (self.q.float() * self.scale).to(self.dtype)
        codes = unpack_int4(self.q).float()
        grouped = codes.reshape(*self.shape[:-1], -1, self.group_size)
        return (grouped * self.scale).reshape(self.shape).to(self.dtype)

    def take_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Embedding lookup of a 2-D (rows, d) table: gather the code
        rows (and int4 group scales) of ``ids`` and dequantize only those
        rows; returns ``(*ids.shape, d)`` in the leaf's dtype."""
        ids = ids.long()
        if self.bits == 8:
            return (self.q[ids].float() * self.scale[0]).to(self.dtype)
        codes = unpack_int4(self.q[ids]).float()
        grouped = codes.reshape(*codes.shape[:-1], -1, self.group_size)
        return (grouped * self.scale[ids]).reshape(codes.shape).to(
            self.dtype)

    def __repr__(self):
        return (f"QTensor(int{self.bits}, shape={self.shape}, "
                f"group_size={self.group_size})")


Params = Mapping[str, Union[torch.Tensor, QTensor]]


def _quantize_leaf_int8(w: torch.Tensor) -> QTensor:
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(wf.ndim - 1)), keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale, 8, None, w.shape, w.dtype)


def _quantize_leaf_int4(w: torch.Tensor, group_size: int) -> QTensor:
    last = w.shape[-1]
    if last % group_size:
        raise ValueError(
            f"group_size ({group_size}) must divide every quantized "
            f"leaf's last axis -- got a {tuple(w.shape)} leaf "
            f"({last} % {group_size} != 0); pick a group_size that "
            "divides the model's feature dims")
    wf = w.float()
    grouped = wf.reshape(*w.shape[:-1], last // group_size, group_size)
    amax = grouped.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 7.0, 1.0)
    codes = torch.clamp(torch.round(grouped / scale), -7, 7).to(torch.int8)
    return QTensor(pack_int4(codes.reshape(w.shape)), scale, 4, group_size,
                   w.shape, w.dtype)


def quantize_params(params: Params, weight_dtype: str = "int8",
                    group_size: Optional[int] = None
                    ) -> Dict[str, Union[torch.Tensor, QTensor]]:
    """Quantize every eligible leaf of ``params`` (a name -> flax-layout
    tensor mapping): floating leaves with ndim >= 2 whose name does not
    end in ``bias`` nor in a LoRA bank (``lora_A``, ``lora_B``: rank-r
    slices that hot loads write in place stay full precision, as JAX
    keeps them). ``group_size`` sizes the int4 groups (default
    :data:`DEFAULT_GROUP_SIZE`); int8 refuses one. Deterministic: the
    same leaves give the same codes and scales."""
    if not check_weight_dtype(weight_dtype):
        raise ValueError(
            "quantize_params needs weight_dtype='int8' or 'int4' "
            "(None means no quantization -- don't call it)")
    if weight_dtype == "int8":
        if group_size is not None:
            raise ValueError(
                "group_size is an int4 option (int8 scales are "
                "per-output-channel); drop it or use weight_dtype='int4'")
    else:
        group_size = (DEFAULT_GROUP_SIZE if group_size is None
                      else group_size)
        if group_size < 2 or group_size % 2:
            raise ValueError(
                f"int4 group_size must be an even integer >= 2 (two "
                f"codes pack per byte inside each group), got "
                f"{group_size}")
    if is_quantized(params):
        raise ValueError(
            "params are already quantized -- quantizing codes would "
            "silently destroy the weights; pass the original params")
    out: Dict[str, Union[torch.Tensor, QTensor]] = {}
    for name, leaf in params.items():
        leaf_name = name.split(".")[-1]
        if (leaf_name == "bias" or leaf_name.startswith("lora_")
                or leaf.ndim < 2
                or not leaf.is_floating_point()):
            out[name] = leaf
        elif weight_dtype == "int8":
            out[name] = _quantize_leaf_int8(leaf)
        else:
            out[name] = _quantize_leaf_int4(leaf, group_size)
    return out


def is_quantized(params: Params) -> bool:
    """True when any leaf of ``params`` is a :class:`QTensor`."""
    return any(isinstance(v, QTensor) for v in params.values())


def dequantize_params(params: Params) -> Dict[str, torch.Tensor]:
    """Original-dtype leaves from a quantized mapping; the identity on
    plain leaves."""
    return {k: v.dequantize() if isinstance(v, QTensor) else v
            for k, v in params.items()}


def param_bytes(params: Params) -> int:
    """Exact at-rest bytes of a plain or quantized mapping (codes +
    scales for :class:`QTensor` leaves)."""
    return int(sum(v.nbytes if isinstance(v, QTensor)
                   else v.numel() * v.element_size()
                   for v in params.values()))


def matmul_view(qt: QTensor, transpose: bool = False):
    """Kernel-input views of one quantized leaf, reshapes of the stored
    codes and scales (no copy, no dequantized weight). Returns
    ``(codes2d, scales2d, K, N)``.

    - ``transpose=False`` (Dense kernels, stored ``(K, *features)``):
      codes ``(K, N)`` int8 or ``(K, N/2)`` packed int4. int8 scales are
      the stored per-channel vector as ``(1, last)``: column ``n`` reads
      ``scales2d[0, n % last]`` (JAX tiles the vector to ``(1, N)``; the
      values are the same, the kernel indexes instead of copying). int4
      scales ``(K, N/group_size)``, column ``n`` in group
      ``n // group_size``.
    - ``transpose=True`` (the tied LM head's ``x @ E.T``, contracting the
      stored LAST axis): codes ``(N, K)`` or ``(N, K/2)``; int8 scales
      ``(1, K)`` ride the contraction axis; int4 scales
      ``(N, K/group_size)``.
    """
    shape = qt.shape
    if transpose:
        K = shape[-1]
        N = qt.q.numel() * (2 if qt.bits == 4 else 1) // K
        if qt.bits == 8:
            return qt.q.reshape(N, K), qt.scale.reshape(1, K), K, N
        return (qt.q.reshape(N, K // 2),
                qt.scale.reshape(N, K // qt.group_size), K, N)
    K = shape[0]
    N = qt.q.numel() * (2 if qt.bits == 4 else 1) // K
    if qt.bits == 8:
        return qt.q.reshape(K, N), qt.scale.reshape(1, shape[-1]), K, N
    return (qt.q.reshape(K, N // 2),
            qt.scale.reshape(K, N // qt.group_size), K, N)
