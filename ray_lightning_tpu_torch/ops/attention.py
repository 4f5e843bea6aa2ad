"""Plain attention math (counterpart of ``ray_lightning_tpu/ops/attention.py``).

:func:`dot_product_attention` is the reference formulation the serving
prefill runs, and the training path's ``attention_impl="dot"``; the
decode read side has its own kernel
(:mod:`ray_lightning_tpu_torch.models.paged_attention`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ray_lightning_tpu_torch.ops import dropout as _dropout

_BIG_NEG = torch.finfo(torch.float32).min


def causal_mask(q_len: int, kv_len: int, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Additive causal mask of shape (1, 1, q_len, kv_len) in ``dtype``,
    end-aligned when ``kv_len != q_len``."""
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(kv_len, device=device)[None, :]
    allow = j <= i + (kv_len - q_len)
    mask = torch.where(allow, 0.0, torch.finfo(dtype).min).to(dtype)
    return mask[None, None]


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          dropout_rate: float = 0.0,
                          dropout_rng: Optional[int] = None,
                          softmax_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Multi-head attention core on (B, T, H, D) q/k/v.

    Scores, mask and softmax run in ``softmax_dtype`` (f32 by default)
    whatever the input dtype: the scores are the f32 products of the
    inputs (exact for bf16 inputs, as with JAX's
    ``preferred_element_type``) rounded once to ``softmax_dtype``. The
    weights are rounded to q's dtype before the V product, which returns
    q's dtype. A row that admits no key (a user mask, or end-aligned
    causal with ``q_len > kv_len``) emits exactly 0 instead of a uniform
    average over masked keys.

    ``dropout_rate > 0`` with an integer ``dropout_rng`` (the seed of
    :func:`~ray_lightning_tpu_torch.ops.dropout.dropout_keep`) drops
    attention weights after that rounding: ``where(keep, w / (1 - rate),
    0)``, as the JAX function does with its key.
    """
    T, S = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    if q.dtype == k.dtype == softmax_dtype:
        # the matmul sums in f32 and rounds once to the inputs' dtype
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()).to(softmax_dtype)
    logits = logits * scale
    if causal:
        logits = logits + causal_mask(T, S, device=q.device,
                                      dtype=softmax_dtype)
    if mask is not None:
        logits = logits + mask.to(softmax_dtype)
    weights = torch.softmax(logits, dim=-1)
    if (causal and T > S) or mask is not None:
        all_masked = torch.all(
            logits <= torch.finfo(softmax_dtype).min * 0.5, dim=-1,
            keepdim=True)
        weights = torch.where(all_masked, 0.0, weights)
    weights = weights.to(q.dtype)
    if dropout_rate > 0.0 and dropout_rng is not None:
        weights = _dropout.apply_dropout(weights, dropout_rate, dropout_rng)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.to(q.dtype))
