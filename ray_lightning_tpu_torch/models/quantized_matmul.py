"""Fused dequant-matmul: ``x @ dequant(W)`` straight from int8/int4 codes.

Counterpart of ``ray_lightning_tpu/models/pallas_matmul.py``. Three
pieces:

- :func:`quantized_matmul_reference` -- the plain PyTorch version, JAX's
  ``_quant_matmul`` non-Pallas branch (``models/transformer.py:232-237``):
  ``qt.dequantize()`` (f32 ``code * scale``, rounded to the leaf's
  dtype), a cast to x's (the compute) dtype, then one f32 matmul of the
  rounded operands rounded once to x's dtype. Products of compute-dtype
  values are exact in f32, as in ``paged_attention_reference``. The CPU
  path, ``matmul_kernel="torch"`` and the kernel's oracle in
  ``chip_smoke.py`` all run it.
- ``csrc/quantized_matmul.cu`` -- the hand-written CUDA kernel for
  ``sm_90a``, built by :mod:`ray_lightning_tpu_torch._build`. It keeps the
  same rounding points and sums every product in f32 over all of K; the
  JAX kernel's ``tile_k`` (f32-accumulated partial dots, a TPU occupancy
  knob) has no counterpart, and its ``tile_m``/``tile_n`` are the
  kernel's own block shapes.
- :func:`quantized_matmul` -- the wrapper: CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise. :func:`_route` picks
  which of the source's four kernels runs -- the decode GEMVs
  (``"gemv_dense"``, ``"gemv_attend"``) where they take the shape, else
  the tensor-core kernel (``"tc"``) for bf16 x and the CUDA-core tiled
  kernel (``"tiled_f32"``) for f32 x -- and the C side launches that one
  or refuses. It counts its launches in total (:func:`kernel_launches`)
  and per route (:func:`route_launches`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ray_lightning_tpu_torch.models.quant import QTensor, matmul_view

__all__ = ["quantized_matmul", "quantized_matmul_reference",
           "kernel_launches", "route_launches", "reset_kernel_launches",
           "launch_geometry", "KERNEL", "ROUTES"]

KERNEL = "quantized_matmul"
#: the source's kernels, in the C side's route numbering
ROUTES = ("gemv_dense", "gemv_attend", "tc", "tiled_f32")
_PARAM_DTYPES = (torch.float32, torch.bfloat16)
_GEMV_ROWS = 16              # the decode GEMVs take M <= 16

_launches: Dict[str, int] = dict.fromkeys(ROUTES, 0)
_launches_by_n: Dict[Tuple[str, int], int] = {}
_lib: Optional[ctypes.CDLL] = None


def kernel_launches() -> int:
    """Kernel launches since the last :func:`reset_kernel_launches`
    (CPU calls of the plain version are not launches)."""
    return sum(_launches.values())


def route_launches(n: Optional[int] = None) -> Dict[str, int]:
    """Launches of each route (:data:`ROUTES`) since the last
    :func:`reset_kernel_launches`; they sum to :func:`kernel_launches`.
    ``n``: only the calls whose output has ``n`` columns (the untied
    head's vocab, say)."""
    if n is None:
        return dict(_launches)
    return {route: _launches_by_n.get((route, n), 0) for route in ROUTES}


def reset_kernel_launches() -> None:
    for route in _launches:
        _launches[route] = 0
    _launches_by_n.clear()


def _route(M: int, N: int, K: int, bits: int, transpose: bool,
           x_dtype: torch.dtype) -> str:
    """Which kernel takes ``x (M, K) @ W (K, N)``: a decode GEMV where M
    is small and its 32-bit code loads align (``"gemv_dense"``: N % 4 ==
    0; ``"gemv_attend"``, the transposed head: K % 4 == 0 for int8, K % 8
    for int4), else the tensor cores for bf16 x (``"tc"``, any shape) and
    the CUDA cores for f32 x (``"tiled_f32"``: tensor-core TF32 would not
    hold f32's 1e-5)."""
    if M <= _GEMV_ROWS:
        if not transpose and N % 4 == 0:
            return "gemv_dense"
        if transpose and K % (4 if bits == 8 else 8) == 0:
            return "gemv_attend"
    return "tc" if x_dtype == torch.bfloat16 else "tiled_f32"


def _weight_2d(qt: QTensor, transpose: bool) -> torch.Tensor:
    """The dequantized leaf as the (K, N) right operand."""
    w = qt.dequantize()
    if transpose:
        return w.reshape(-1, qt.shape[-1]).T
    return w.reshape(qt.shape[0], -1)


def quantized_matmul_reference(x: torch.Tensor, qt: QTensor,
                               transpose: bool = False) -> torch.Tensor:
    """The plain version; arguments as :func:`quantized_matmul`."""
    w = _weight_2d(qt, transpose).to(x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ray_lightning_tpu_torch._build import check_routes, load
        lib = load(KERNEL)
        check_routes(lib, "quantized_matmul_route_names", ROUTES)
        lib.quantized_matmul_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        lib.quantized_matmul_launch.restype = ctypes.c_int
        lib.quantized_matmul_geometry.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 8
            + [ctypes.POINTER(ctypes.c_int)])
        lib.quantized_matmul_geometry.restype = ctypes.c_int
        lib.quantized_matmul_error_string.argtypes = [ctypes.c_int]
        lib.quantized_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def quantized_matmul(x: torch.Tensor, qt: QTensor,
                     transpose: bool = False) -> torch.Tensor:
    """``x (..., K) @ dequantize(qt) -> (..., N)``, the dequant fused
    into the matmul: no dense weight is materialized.

    ``transpose=False`` contracts the leaf's stored axis 0 and flattens
    its other axes to ``N`` (a Dense kernel ``(K, *features)``; the
    caller reshapes to its features); ``transpose=True`` contracts the
    stored LAST axis (the tied LM head's ``x @ E.T``). ``x`` is float32
    or bfloat16 -- callers cast to the compute dtype first, as flax's
    Dense does -- and the output has x's dtype. CPU tensors run the plain
    version; CUDA tensors (x contiguous, on the leaf's device) launch the
    kernel on the current stream or raise -- nothing falls back.
    """
    codes, scales, K, N = matmul_view(qt, transpose)
    if x.shape[-1] != K:
        raise ValueError(
            f"quantized_matmul contraction mismatch: x has {x.shape[-1]} "
            f"features, the quantized leaf contracts over {K}")
    if x.device != qt.device:
        raise ValueError(f"quantized_matmul inputs span devices "
                         f"{x.device} and {qt.device}")
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, qt, transpose)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul runs on cpu or cuda, got "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if qt.dtype not in _PARAM_DTYPES:
        raise ValueError(f"the quantized leaf's dtype must be float32 or "
                         f"bfloat16, got {qt.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantized_matmul needs a contiguous x")
    if codes.data_ptr() % 4 or scales.data_ptr() % 4:
        raise ValueError("quantized_matmul reads codes in 32-bit words: "
                         "codes and scales must be 4-byte aligned")
    lead = x.shape[:-1]
    M = x.numel() // K
    if M < 1:
        raise ValueError("quantized_matmul needs at least one row of x")
    route = _route(M, N, K, qt.bits, transpose, x.dtype)
    out = torch.empty((*lead, N), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantized_matmul_launch(
            x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            out.data_ptr(), M, N, K, qt.bits, int(transpose),
            qt.group_size or 0, scales.shape[1],
            0 if x.dtype == torch.float32 else 1,
            int(qt.dtype == torch.bfloat16), ROUTES.index(route), stream)
    if err != 0:
        msg = lib.quantized_matmul_error_string(err).decode()
        raise RuntimeError(f"quantized_matmul kernel launch failed ({route}): "
                           f"{msg}")
    _launches[route] += 1
    _launches_by_n[route, N] = _launches_by_n.get((route, N), 0) + 1
    return out


def launch_geometry(x: torch.Tensor, qt: QTensor,
                    transpose: bool = False) -> Dict[str, int]:
    """How the decode GEMV that :func:`quantized_matmul` routes this call
    to is launched: grid, cluster size (gemv_dense splits K over the
    blocks of a cluster), threads a block, output columns a block (dense:
    a cluster), bytes per code load (dense: per asynchronous copy), K rows
    a block, how many such clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``), and whether the products run on
    the tensor cores (gemv_dense with bf16 x).
    Needs the card; launches nothing; raises for a call no GEMV takes."""
    codes, _, K, N = matmul_view(qt, transpose)
    M = x.numel() // K
    route = _route(M, N, K, qt.bits, transpose, x.dtype)
    if route not in ("gemv_dense", "gemv_attend"):
        raise ValueError(f"({M}, {K}) x ({K}, {N}) takes route {route}, "
                         "not a GEMV")
    out = (ctypes.c_int * 9)()
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.quantized_matmul_geometry(
            codes.data_ptr(), M, N, K, qt.bits, int(transpose),
            qt.group_size or 0, 0 if x.dtype == torch.float32 else 1,
            ROUTES.index(route), out)
    if err != 0:
        msg = lib.quantized_matmul_error_string(err).decode()
        raise RuntimeError(f"quantized_matmul geometry query failed "
                           f"({route}): {msg}")
    geometry = dict(zip(
        ("grid_x", "grid_y", "cluster", "threads", "cols", "load_bytes",
         "k_rows", "max_active_clusters", "tensor_cores"), list(out)))
    geometry["tensor_cores"] = bool(geometry["tensor_cores"])
    return dict(route=route, **geometry)
