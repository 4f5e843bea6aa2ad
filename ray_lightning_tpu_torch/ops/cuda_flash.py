"""Flash attention for training: CUDA kernels, plain versions, autograd.

Counterpart of ``ray_lightning_tpu/ops/pallas_flash.py``. Shapes are the
JAX package's: q (B, T, H, D), k and v (B, S, H, D); lse and delta
(B, H, T) float32.

- ``csrc/flash_attention.cu`` -- three hand-written CUDA kernels for
  ``sm_90a`` (built by :mod:`ray_lightning_tpu_torch._build`): the forward
  (K2, ``_flash_kernel``), dK/dV (K3, ``_flash_dkv_kernel``) and dQ (K4,
  ``_flash_dq_kernel``). The source says how each is bound on the H100.
- The plain versions, :func:`flash_fwd_reference`,
  :func:`flash_bwd_dkv_reference` and :func:`flash_bwd_dq_reference`
  (with :func:`flash_bwd_reference` for all three gradients): dense
  PyTorch with ONE exact softmax, keeping the kernels' conventions --
  f32 scores scaled after the dot, the ``-0.7 * finfo(f32).max`` mask,
  end-aligned causal masking for ``T != S``, out = 0 and lse = 1e30 for a
  row that admits no key, and the rounding points of the Pallas kernels
  (p to v's dtype before P.V; p to dO's, ds to q's and k's dtype in the
  backward). CPU tensors, the tests and ``chip_smoke.py`` use them;
  nothing on the CUDA path does.
- The wrappers :func:`flash_fwd`, :func:`flash_bwd_dkv` and
  :func:`flash_bwd_dq`: CPU tensors take the plain version; CUDA tensors
  launch the kernel on the current stream or raise -- nothing falls back.
  Each counts its launches (:func:`kernel_launches`).
- :class:`_Flash`, the counterpart of the ``custom_vjp`` ``_flash``: the
  forward saves q, k, v, out and lse; the backward computes
  ``delta = rowsum(dO * out)`` in plain PyTorch (as ``_flash_bwd_impl``
  does outside its kernels), then dK/dV and dQ.

The kernels take q/k/v/dO with any batch, sequence and head strides as
long as the last axis is contiguous, so the q, k and v views of one fused
qkv projection are read in place. Their tiles (64 rows) are chosen for
the H100, not carried over from the TPU's block sizes.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

__all__ = ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd",
           "flash_fwd_reference", "flash_bwd_dkv_reference",
           "flash_bwd_dq_reference", "flash_bwd_reference", "flash_delta",
           "kernel_launches", "reset_kernel_launches", "KERNELS"]

SOURCE = "flash_attention"
#: kernel names, in path order: forward, dK/dV, dQ
KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BIG_NEG = -0.7 * float(torch.finfo(torch.float32).max)
_PAD_LSE = 1e30

_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_lib: Optional[ctypes.CDLL] = None


def kernel_launches() -> Dict[str, int]:
    """Launches of each kernel since :func:`reset_kernel_launches` (CPU
    calls of the plain versions are not launches)."""
    return dict(_launches)


def reset_kernel_launches() -> None:
    for name in _launches:
        _launches[name] = 0


# ------------------------------------------------------ plain versions
def _allowed(T: int, S: int, causal: bool, device) -> torch.Tensor:
    """(T, S) admission mask: end-aligned causal when T != S."""
    if not causal:
        return torch.ones((T, S), dtype=torch.bool, device=device)
    qpos = torch.arange(T, device=device)[:, None] + (S - T)
    return torch.arange(S, device=device)[None, :] <= qpos


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 scores (B, H, T, S), scaled after the dot."""
    return (torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            * q.shape[-1] ** -0.5)


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's plain version: ``(out (B, T, H, D) in q's dtype,
    lse (B, H, T) f32)``."""
    allow = _allowed(q.shape[1], k.shape[1], causal, q.device)
    s = torch.where(allow, _scores(q, k), _BIG_NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allow, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)                       # (B, H, T, 1)
    safe_l = l.clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l_t, safe_t = l.transpose(1, 2), safe_l.transpose(1, 2)  # (B, T, H, 1)
    out = torch.where(l_t > 0, acc / safe_t, 0.0).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(safe_l), _PAD_LSE)[..., 0]
    return out, lse


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * out)`` from f32 upcasts: (B, H, T) f32,
    contiguous."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()


def _recomputed_p_ds(q, k, v, do, lse, delta, causal):
    """p = exp(s - lse) and ds = p * (dO.V^T - delta) as f32 (B, H, T, S);
    masked entries are exactly 0 in both."""
    allow = _allowed(q.shape[1], k.shape[1], causal, q.device)
    p = torch.where(allow, torch.exp(_scores(q, k) - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK/dV's plain version: ``(dk, dv)`` in k's and v's dtypes."""
    p, ds = _recomputed_p_ds(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * q.shape[-1] ** -0.5
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta,
                           causal: bool) -> torch.Tensor:
    """dQ's plain version, in q's dtype."""
    _, ds = _recomputed_p_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k.float()) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def flash_bwd_reference(q, k, v, out, lse, do, causal: bool):
    """All three gradients from the plain versions: ``(dq, dk, dv)``."""
    delta = flash_delta(out, do)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal), dk, dv


# ------------------------------------------------------------ wrappers
def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ray_lightning_tpu_torch._build import load
        lib = load(SOURCE)
        tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        ptr, strides = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
        lib.flash_fwd_launch.argtypes = [ptr] * 5 + [strides] + tail
        lib.flash_bwd_dkv_launch.argtypes = [ptr] * 8 + [strides] + tail
        lib.flash_bwd_dq_launch.argtypes = [ptr] * 7 + [strides] + tail
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dkv_launch,
                   lib.flash_bwd_dq_launch):
            fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _device(*tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"flash attention inputs span devices {devices}")
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, got {device}")
    return device


def _check(q, k, v, *more) -> Tuple[int, int, int, int, int]:
    """Validate what the kernels take; returns (B, H, T, S, D). Raises
    ValueError on anything else."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B, T|S, H, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, T, H, D = q.shape
    S = k.shape[1]
    if tuple(k.shape) != (B, S, H, D) or v.shape != k.shape:
        raise ValueError(f"k and v must both be ({B}, S, {H}, {D}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if T < 1 or S < 1:
        raise ValueError(f"empty sequence: T={T}, S={S}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t in (k, v, *more):
        if t.dtype != q.dtype:
            raise ValueError(f"flash attention operands must share q's "
                             f"dtype {q.dtype}, got {t.dtype}")
    for t in (q, k, v, *more):
        if t.stride(-1) != 1:
            raise ValueError("flash attention reads (B, L, H, D) operands "
                             "through their strides, but the last axis "
                             "must be contiguous")
    return B, H, T, S, D


def _rows(*tensors: torch.Tensor):
    """(batch, sequence, head) strides of each operand, as the int64
    array the kernels take."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_rows(x: torch.Tensor, B: int, H: int, T: int, what: str):
    if x.dtype != torch.float32 or tuple(x.shape) != (B, H, T) \
            or not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous float32 ({B}, {H}, {T})")


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        msg = _library().flash_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")
    _launches[name] += 1


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward (K2): ``(out (B, T, H, D) in q's dtype, lse (B, H, T)
    f32)``. q, k, v float32 or bfloat16 alike, head_dim 32/64/128, any T
    and S; causal masking is end-aligned when T != S."""
    if _device(q, k, v).type == "cpu":
        return flash_fwd_reference(q, k, v, causal)
    B, H, T, S, D = _check(q, k, v)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_fwd", lib.flash_fwd_launch, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                _rows(q, k, v, out), B, H, T, S, D, DTYPES[q.dtype],
                int(causal), D ** -0.5, stream)
    return out, lse


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash backward dK/dV (K3): ``(dk, dv)`` (B, S, H, D) in k's and
    v's dtype. ``do`` (B, T, H, D) shares q's dtype; ``lse`` and
    ``delta`` are contiguous (B, H, T) f32."""
    if _device(q, k, v, do, lse, delta).type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    B, H, T, S, D = _check(q, k, v, do)
    _check_rows(lse, B, H, T, "lse")
    _check_rows(delta, B, H, T, "delta")
    dk = torch.empty((B, S, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, S, H, D), dtype=v.dtype, device=v.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_bwd_dkv", lib.flash_bwd_dkv_launch, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _rows(q, k, v, do, dk, dv), B, H, T, S, D, DTYPES[q.dtype],
                int(causal), D ** -0.5, stream)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """Flash backward dQ (K4): dq (B, T, H, D) in q's dtype; arguments as
    :func:`flash_bwd_dkv`."""
    if _device(q, k, v, do, lse, delta).type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    B, H, T, S, D = _check(q, k, v, do)
    _check_rows(lse, B, H, T, "lse")
    _check_rows(delta, B, H, T, "delta")
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_bwd_dq", lib.flash_bwd_dq_launch, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), _rows(q, k, v, do, dq), B,
                H, T, S, D, DTYPES[q.dtype], int(causal), D ** -0.5, stream)
    return dq


def flash_bwd(q, k, v, out, lse, do, causal: bool):
    """All three gradients through the wrappers: ``(dq, dk, dv)``."""
    delta = flash_delta(out, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal), dk, dv


class _Flash(torch.autograd.Function):
    """Differentiable flash attention (the ``custom_vjp`` ``_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # the kernels need a contiguous last axis; an incoming gradient
        # without one is copied
        do = do if do.stride(-1) == 1 else do.contiguous()
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do, ctx.causal)
        return dq, dk, dv, None
