"""LM-head cross-entropy without f32 (N, V) logits (counterpart of ``ray_lightning_tpu/ops/lm_head_loss.py``).

Opt-in ops, as in the JAX package: ``GPTModule`` materializes its f32
logits; a module that wants the memory back calls
``TransformerLM(..., return_hidden=True)`` and one of these on the
hidden states and the head's table.

- :func:`lm_head_xent`: the direct form. The logits are computed once
  in ``compute_dtype`` and are the only (N, V) tensor; the log-sum-exp
  reads them row block by row block in f32 and backward recomputes the
  softmax the same way (:class:`_LogSumExp`), where a plain
  ``logits.float()`` would keep an f32 copy of all of them.
- :func:`chunked_lm_head_xent`: token chunks of ``chunk_size``, each
  chunk's (C, V) f32 logits computed from ``compute_dtype`` operands
  (exact products, f32 sums: JAX's ``preferred_element_type=f32``),
  reduced to its loss and dropped; ``torch.utils.checkpoint`` on each
  chunk recomputes its slice in backward, so the extra memory is
  O(chunk_size x V), not O(N x V). The last chunk is padded and masked.

The head product stays ``torch.matmul``: the JAX package computes it
outside any Pallas kernel.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["lm_head_xent", "chunked_lm_head_xent"]

_LSE_ROWS = 1024          # rows of f32 logits alive at once in _LogSumExp


class _LogSumExp(torch.autograd.Function):
    """Row log-sum-exp of (N, V) logits in f32, the logits kept in their
    own dtype: f32 copies exist one block of rows at a time."""

    @staticmethod
    def forward(ctx, logits):
        lse = torch.empty(logits.shape[0], dtype=torch.float32,
                          device=logits.device)
        for i in range(0, logits.shape[0], _LSE_ROWS):
            lse[i:i + _LSE_ROWS] = torch.logsumexp(
                logits[i:i + _LSE_ROWS].float(), dim=-1)
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        grad = torch.empty_like(logits)
        for i in range(0, logits.shape[0], _LSE_ROWS):
            rows = slice(i, i + _LSE_ROWS)
            grad[rows] = (torch.exp(logits[rows].float() - lse[rows, None])
                          * g[rows, None]).to(logits.dtype)
        return grad


def _flat(hidden, labels):
    if hidden.ndim == 3:
        return hidden.reshape(-1, hidden.shape[-1]), labels.reshape(-1)
    return hidden, labels


def lm_head_xent(hidden: torch.Tensor, embedding: torch.Tensor,
                 labels: torch.Tensor, *,
                 compute_dtype: torch.dtype = torch.bfloat16
                 ) -> torch.Tensor:
    """Mean next-token cross-entropy with ``compute_dtype`` logits.

    ``hidden`` (B, T, D) or (N, D) final hidden states; ``embedding``
    (V, D), the tied table (an untied (D, V) kernel goes as ``kernel.T``);
    ``labels`` (B, T) or (N,) integer targets. Returns the f32 scalar."""
    hidden, labels = _flat(hidden, labels)
    logits = torch.matmul(hidden.to(compute_dtype),
                          embedding.to(compute_dtype).T)    # (N, V)
    lse = _LogSumExp.apply(logits)
    label_logit = logits.gather(1, labels[:, None].long())[:, 0].float()
    return (lse - label_logit).mean()


def _chunk_loss(emb, x_c, y_c, m_c, compute_dtype, z_loss: float):
    # (C, V) f32: compute-dtype operands, products exact in f32
    logits = torch.matmul(x_c.to(compute_dtype).float(),
                          emb.to(compute_dtype).float().T)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(1, y_c[:, None])[:, 0]
    loss = (lse - label_logit) * m_c
    if z_loss:
        loss = loss + z_loss * torch.square(lse) * m_c
    return loss.sum()


def chunked_lm_head_xent(hidden: torch.Tensor, embedding: torch.Tensor,
                         labels: torch.Tensor, *, chunk_size: int = 2048,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token cross-entropy over token chunks, never holding
    the full logits. Arguments as :func:`lm_head_xent`, plus
    ``chunk_size`` (tokens a chunk; peak extra memory ``chunk_size * V *
    4`` bytes of f32 logits and their gradient) and ``z_loss`` (the
    coefficient of the auxiliary ``lse**2`` term; 0 disables). Returns
    the f32 scalar mean over every token."""
    hidden, labels = _flat(hidden, labels)
    n_tokens, d = hidden.shape
    chunk = max(1, min(chunk_size, n_tokens))
    pad = (-n_tokens) % chunk
    labels = labels.long()
    if pad:
        hidden = torch.cat([hidden, hidden.new_zeros(pad, d)])
        labels = torch.cat([labels, labels.new_zeros(pad)])
    valid = (torch.arange(n_tokens + pad, device=hidden.device)
             < n_tokens).float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, n_tokens + pad, chunk):
        rows = slice(i, i + chunk)
        total = total + checkpoint(_chunk_loss, embedding, hidden[rows],
                                   labels[rows], valid[rows], compute_dtype,
                                   z_loss, use_reentrant=False)
    return total / n_tokens
