"""Paged attention: the read side of one layer's cached decode/verify step.

Counterpart of ``ray_lightning_tpu/models/pallas_attention.py``. Three
pieces, in the layout and argument order of the JAX ``paged_attention``:

- :func:`paged_attention_reference` -- the plain PyTorch version. It
  repeats the XLA read side of
  ``MultiHeadAttention._page_native_attention`` (JAX
  ``models/transformer.py:634-674``) term for term: gather each row's
  pages through the page table (−1 clamps to page 0), dequantize int8
  codes, f32 scores scaled by ``D**-0.5``, the block-causal mask
  ``key_pos <= kv_positions[b, t]`` as an additive ``finfo(f32).min``,
  ONE exact softmax, all-masked rows -> 0, weights rounded to the
  compute dtype, V accumulated in f32. (The XLA path sums V page column
  by page column; here one einsum sums every key: only the rounding
  order of that sum differs.) The CPU path, ``attention_kernel="torch"``
  and the kernel's oracle in ``chip_smoke.py`` all run it.
- ``csrc/paged_attention.cu`` -- the hand-written CUDA kernel for
  ``sm_90a``, built by :mod:`ray_lightning_tpu_torch._build`.
- :func:`paged_attention` -- the wrapper: CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise. It counts its
  launches (:func:`kernel_launches`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ray_lightning_tpu_torch.models.quant import kv_dequantize

__all__ = ["paged_attention", "paged_attention_reference",
           "kernel_launches", "launches_by_t", "reset_kernel_launches",
           "cluster_size", "smem_bytes", "launch_geometry"]

_BIG_NEG = torch.finfo(torch.float32).min
KERNEL = "paged_attention"
HEAD_DIMS = (32, 64, 128)
MAX_T = 8
# shared memory one thread block may use on Hopper (dynamic, opted in)
_MAX_SMEM = 232448
_WARPS = 4          # warps per thread block (kWarps in the .cu)
MAX_CLUSTER = 8     # blocks per (row, head): the portable cluster size
_KEYS_PER_BLOCK = 64   # a full row gives each block at least this many keys
_CHUNK_BYTES = 16384   # most bytes of K (or of V) a block stages at once

_launches = 0
_launches_by_t: Dict[int, int] = {}
_lib: Optional[ctypes.CDLL] = None


def kernel_launches() -> int:
    """Kernel launches since the last :func:`reset_kernel_launches`
    (CPU calls of the plain version are not launches)."""
    return _launches


def launches_by_t() -> Dict[int, int]:
    """:func:`kernel_launches` split by the query tokens a row T (1 for a
    decode step, k+1 for a speculative verify)."""
    return dict(_launches_by_t)


def reset_kernel_launches() -> None:
    global _launches
    _launches = 0
    _launches_by_t.clear()


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              k_scales: Optional[torch.Tensor],
                              v_scales: Optional[torch.Tensor],
                              kv_positions: torch.Tensor,
                              page_table: torch.Tensor) -> torch.Tensor:
    """The plain version; shapes as :func:`paged_attention`."""
    B, T, H, D = q.shape
    P, ps = k_pages.shape[0], k_pages.shape[1]
    pp = page_table.shape[1]
    S = pp * ps
    pidx = page_table.long().clamp(0, P - 1)            # (B, pp)

    def read(store, scales):
        blk = store[pidx]                               # (B, pp, ps, H, D)
        if scales is not None:
            blk = kv_dequantize(blk, scales[pidx], q.dtype)
        # page-major key order IS absolute position order
        return blk.reshape(B, S, H, D)

    # products of compute-dtype values are exact in f32: the f32 einsum
    # is JAX's preferred_element_type=f32 dot
    k = read(k_pages, k_scales).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * D ** -0.5
    key_pos = torch.arange(S, device=q.device)
    pos = kv_positions.long()
    logits = logits + torch.where(
        key_pos[None, None, None, :] <= pos[:, None, :, None], 0.0,
        _BIG_NEG)
    weights = torch.softmax(logits, dim=-1)
    all_masked = torch.all(logits <= _BIG_NEG * 0.5, dim=-1, keepdim=True)
    weights = torch.where(all_masked, 0.0, weights).to(q.dtype)
    v = read(v_pages, v_scales).float()
    out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v)
    return out.to(q.dtype)


def _check(q, k_pages, v_pages, k_scales, v_scales, kv_positions,
           page_table) -> bool:
    """Validate what the kernel takes; returns whether the arena is
    int8. Raises ValueError on anything else."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, D), got {tuple(q.shape)}")
    B, T, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if not 1 <= T <= MAX_T:
        raise ValueError(f"T={T} outside 1..{MAX_T}")
    if k_pages.dim() != 4 or k_pages.shape[2:] != (H, D) \
            or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"pages must both be (P, page_size, {H}, {D}), got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages differ in dtype")
    quantized = k_pages.dtype == torch.int8
    if not quantized and k_pages.dtype != q.dtype:
        raise ValueError(
            f"pages must be int8 or q's dtype {q.dtype}, got "
            f"{k_pages.dtype}")
    P, ps = k_pages.shape[0], k_pages.shape[1]
    if quantized:
        for s in (k_scales, v_scales):
            if s is None or s.dtype != torch.float32 \
                    or tuple(s.shape) != (P, 1, H, 1):
                raise ValueError(
                    f"int8 pages need float32 scales of shape "
                    f"({P}, 1, {H}, 1)")
    elif k_scales is not None or v_scales is not None:
        raise ValueError("scales are only taken with int8 pages")
    if kv_positions.dtype != torch.int32 \
            or tuple(kv_positions.shape) != (B, T):
        raise ValueError(f"kv_positions must be int32 ({B}, {T})")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != B:
        raise ValueError(f"page_table must be int32 ({B}, pages_per_slot)")
    pp = page_table.shape[1]
    cluster = cluster_size(pp * ps)
    smem = smem_bytes(T, D, pp * ps, pp, cluster, k_pages.element_size(),
                      quantized)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"T * ceil(pages_per_slot * page_size / {cluster}) = "
            f"{T * -(-pp * ps // cluster)} scores a block need {smem} bytes "
            f"of shared memory, over the {_MAX_SMEM} a block may use")
    return quantized


def cluster_size(S: int) -> int:
    """Blocks of the thread-block cluster that shares one (row, head): the
    largest power of two up to :data:`MAX_CLUSTER` that leaves each block
    at least 64 of the S = pages_per_slot * page_size keys (1 below 128
    keys). The kernel splits each row's admitted keys, not S, into that
    many equal shares."""
    cs = 1
    while cs < MAX_CLUSTER and 2 * cs * _KEYS_PER_BLOCK <= S:
        cs *= 2
    return cs


def smem_bytes(T: int, D: int, S: int, pp: int, cluster: int,
               page_bytes: int = 2, quantized: bool = False) -> int:
    """Dynamic shared memory of one block (``smem_words`` in the .cu): a
    chunk of its keys' K (then V) rows (all of its ceil(S / cluster) keys,
    or 16 KB; ``page_bytes`` a page element) and their int8 page scales,
    its scores (T, ceil(S / cluster)) f32, the warps' partial outputs
    (warps, T, D) and every block's (MAX_CLUSTER, T, D) f32 (rank 0 adds
    them), every block's (max, sum) pair and the reduction scratch of up
    to 8 queries, positions and the row's page ids."""
    kb_max = -(-S // cluster)
    row_bytes = D * page_bytes
    chunk = min(kb_max, _CHUNK_BYTES // row_bytes)
    words = (chunk * (row_bytes // 4 + (1 if quantized else 0))
             + T * kb_max + (_WARPS + MAX_CLUSTER) * T * D
             + 2 * MAX_CLUSTER * MAX_T + 2 * _WARPS * MAX_T + MAX_T + pp)
    return 4 * words


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ray_lightning_tpu_torch._build import load
        lib = load(KERNEL)
        lib.paged_attention_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_void_p])
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_geometry.argtypes = (
            [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_int)])
        lib.paged_attention_geometry.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor,
                    k_scales: Optional[torch.Tensor],
                    v_scales: Optional[torch.Tensor],
                    kv_positions: torch.Tensor,
                    page_table: torch.Tensor) -> torch.Tensor:
    """Cached paged attention for one layer's decode/verify read side.

    - ``q`` (B, T, H, D) float32 or bfloat16 -- T = 1 (decode) or k+1
      (verify), up to 8; D in 32/64/128.
    - ``k_pages``/``v_pages`` (num_pages, page_size, H, D) -- q's dtype,
      or int8 codes (the block's own T tokens already written).
    - ``k_scales``/``v_scales`` (num_pages, 1, H, 1) float32 per-page
      absmax scales for int8 pages, else None.
    - ``kv_positions`` (B, T) int32 -- the mask admits
      ``key <= kv_positions[b, t]``; a row of -1 admits nothing and
      emits 0.
    - ``page_table`` (B, pages_per_slot) int32, −1 = unmapped (reads
      clamp to page 0).

    Returns (B, T, H, D) in q's dtype. CPU tensors run the plain version;
    CUDA tensors (all contiguous, on one device) launch the kernel on the
    current stream or raise -- nothing falls back.
    """
    tensors = [q, k_pages, v_pages, kv_positions, page_table]
    tensors += [s for s in (k_scales, v_scales) if s is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"paged_attention inputs span devices {devices}")
    device = q.device
    if device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, k_scales,
                                         v_scales, kv_positions, page_table)
    if device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, got {device}")
    quantized = _check(q, k_pages, v_pages, k_scales, v_scales,
                       kv_positions, page_table)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention needs contiguous tensors")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention reads pages in 16-byte vectors: "
                         "k_pages and v_pages must be 16-byte aligned")
    B, T, H, D = q.shape
    P, ps = k_pages.shape[0], k_pages.shape[1]
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            kv_positions.data_ptr(), page_table.data_ptr(), out.data_ptr(),
            B, T, H, D, P, ps, page_table.shape[1],
            0 if q.dtype == torch.float32 else 1, int(quantized),
            cluster_size(ps * page_table.shape[1]), D ** -0.5, stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg}")
    global _launches
    _launches += 1
    _launches_by_t[T] = _launches_by_t.get(T, 0) + 1
    return out


def launch_geometry(q: torch.Tensor, k_pages: torch.Tensor,
                    page_table: torch.Tensor) -> dict:
    """The launch :func:`paged_attention` makes for these shapes and
    dtypes: grid, cluster size, threads and dynamic shared memory a block,
    and how many such clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``). Needs the card; launches
    nothing."""
    B, T, H, D = q.shape
    P, ps = k_pages.shape[0], k_pages.shape[1]
    pp = page_table.shape[1]
    out = (ctypes.c_int * 5)()
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.paged_attention_geometry(
            B, T, H, D, P, ps, pp, 0 if q.dtype == torch.float32 else 1,
            int(k_pages.dtype == torch.int8), cluster_size(ps * pp), out)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention geometry query failed: {msg}")
    return dict(zip(("grid", "cluster", "threads", "smem_bytes",
                     "max_active_clusters"), list(out)))
