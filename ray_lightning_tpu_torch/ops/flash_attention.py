"""Blockwise (flash) attention (counterpart of ``ray_lightning_tpu/ops/flash_attention.py``).

:func:`flash_attention` takes two routes, as the JAX function does:

- ``use_kernel=None`` (the default): :class:`~.cuda_flash._Flash`, the
  differentiable route through the hand-written CUDA kernels on CUDA
  tensors and through their plain versions on CPU tensors -- the
  counterpart of ``use_pallas=True``;
- ``use_kernel=False``: the blockwise online-softmax loop in plain
  PyTorch, differentiated by autograd -- the counterpart of the JAX
  package's XLA path (``_block_update``, ``_finalize``, the end-aligned
  ``pos_shift`` and the causal skip of KV blocks above the diagonal).

An additive ``mask``, or attention dropout (``dropout_rate > 0`` with a
``dropout_rng`` seed), takes :func:`dot_product_attention`, as the JAX
function does (``ray_lightning_tpu/ops/flash_attention.py:78-81``): the
kernels never see dropout, so a training step with dropout on launches
none of them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ray_lightning_tpu_torch.ops.attention import dot_product_attention
from ray_lightning_tpu_torch.ops.cuda_flash import _Flash

_BIG_NEG = -0.7 * float(torch.finfo(torch.float32).max)


def _block_update(carry: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                  qi: torch.Tensor, kj: torch.Tensor, vj: torch.Tensor,
                  qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                  kv_len: int, scale: float):
    """One online-softmax accumulation step. ``carry``: m (B, H, bq)
    running max, l (B, H, bq) running denominator, acc (B, bq, H, D) f32
    running numerator; qi (B, bq, H, D), kj/vj (B, bk, H, D); qpos (bq,),
    kpos (bk,) global positions (kpos past kv_len is padding)."""
    m, l, acc = carry
    s = torch.einsum("bqhd,bkhd->bhqk", qi.float(), kj.float()) * scale
    allow = (kpos < kv_len)[None, :]
    if causal:
        allow = allow & (kpos[None, :] <= qpos[:, None])
    s = torch.where(allow, s, _BIG_NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(allow, torch.exp(s - m_new[..., None]), 0.0)
    alpha = torch.exp(m - m_new)                        # (B, H, bq)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(vj.dtype).float(), vj.float())
    return m_new, l_new, acc * alpha.transpose(1, 2)[..., None] + pv


def _finalize(l: torch.Tensor, acc: torch.Tensor, dtype) -> torch.Tensor:
    l_t = l.transpose(1, 2)[..., None]                  # (B, bq, H, 1)
    return torch.where(l_t > 0, acc / l_t.clamp_min(1e-30), 0.0).to(dtype)


def _blockwise(q, k, v, causal: bool, block_q: int, block_k: int):
    B, T, H, D = q.shape
    S = k.shape[1]
    bq, bk = min(block_q, T), min(block_k, S)
    n_q, n_k = -(-T // bq), -(-S // bk)
    scale = D ** -0.5
    qp = F.pad(q, (0, 0, 0, 0, 0, n_q * bq - T))
    kp = F.pad(k, (0, 0, 0, 0, 0, n_k * bk - S))
    vp = F.pad(v, (0, 0, 0, 0, 0, n_k * bk - S))
    # causal offset aligns the *ends* of q and kv (S != T)
    pos_shift = S - T
    out_blocks = []
    for ib in range(n_q):
        off = ib * bq
        qi = qp[:, off:off + bq]
        qpos = off + torch.arange(bq, device=q.device) + pos_shift
        # the last key this q block may attend is off + bq - 1 + pos_shift
        n_needed = (max(0, min(n_k, (off + bq + pos_shift + bk - 1) // bk))
                    if causal else n_k)
        carry = (torch.full((B, H, bq), _BIG_NEG, device=q.device),
                 torch.zeros((B, H, bq), device=q.device),
                 torch.zeros((B, bq, H, D), device=q.device))
        for jb in range(n_needed):
            sl = slice(jb * bk, (jb + 1) * bk)
            kpos = jb * bk + torch.arange(bk, device=q.device)
            carry = _block_update(carry, qi, kp[:, sl], vp[:, sl], qpos,
                                  kpos, causal, S, scale)
        out_blocks.append(_finalize(carry[1], carry[2], q.dtype))
    return torch.cat(out_blocks, dim=1)[:, :T]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    mask: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0,
                    dropout_rng: Optional[int] = None,
                    block_q: int = 512, block_k: int = 1024,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Blockwise attention on (B, T, H, D) q and (B, S, H, D) k/v;
    signature-compatible with :func:`dot_product_attention`.

    ``use_kernel``: None takes the kernels on CUDA tensors and their plain
    versions on CPU tensors; True demands the kernels (CUDA tensors);
    False runs the blockwise PyTorch loop with ``block_q`` x ``block_k``
    blocks (the kernels use their own 64-row tiles)."""
    if mask is not None or (dropout_rate > 0.0 and dropout_rng is not None):
        return dot_product_attention(q, k, v, causal=causal, mask=mask,
                                     dropout_rate=dropout_rate,
                                     dropout_rng=dropout_rng)
    if use_kernel is False:
        return _blockwise(q, k, v, causal, block_q, block_k)
    if use_kernel and q.device.type != "cuda":
        raise ValueError("use_kernel=True runs the CUDA kernels and needs "
                         f"CUDA tensors, got {q.device}")
    return _Flash.apply(q, k, v, causal)
