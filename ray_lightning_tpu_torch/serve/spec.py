"""Speculative decoding: k draft steps and ONE widened target verify (counterpart of ``ray_lightning_tpu/serve/spec.py``).

Leviathan et al. 2023 on the engine's fixed shapes: a small **draft
model** (a sibling sharing the target's vocab and ``max_seq_len``, e.g.
a few layers of it) proposes ``k`` tokens a slot, one single-token step
at a time, and the target scores all ``k`` proposals in ONE
``(num_slots, k+1)`` **verify**: through the page arena on page-native
engines (:func:`~ray_lightning_tpu_torch.models.generate.verify_step_paged`;
the read side is the paged-attention kernel K1 at T = k+1 under
``attention_kernel="cuda"``), else on the dense slot pool or the dense
view of the arena (:func:`~ray_lightning_tpu_torch.models.generate.verify_step`;
:func:`_spec_rounds_impl`, :func:`_spec_rounds_paged_impl`). The
longest agreeing prefix is accepted plus one target token, so each
target pass commits 1..k+1 tokens.

Acceptance, per row, by the row's own sampling parameters:

- **greedy** (``temperature == 0``): draft token ``d_j`` is accepted iff
  it equals the target's argmax at that offset; at the first divergence
  the target's argmax is committed instead. Every committed token is the
  token the non-spec engine would have produced.
- **sampled**: accept ``d_j`` with probability ``min(1, p(d_j)/q(d_j))``,
  else resample from the residual ``max(p - q, 0)`` (``p`` where that is
  all zero), which keeps the target distribution exactly. Every draw
  comes from the row's step seed
  (:func:`~ray_lightning_tpu_torch.models.generate.row_seed` of engine
  seed, request seed and step): the draft's draw from the sub-stream
  :func:`stream_seed` ``(seed, 1)``, the accept uniform from sub-stream
  2, the residual resample and the bonus token from the step seed
  itself -- the seed the non-spec engine samples that step with. So the
  token committed at step ``s`` depends only on (engine seed, request
  seed, ``s``, context), whatever the round boundaries.

Rollback is a position decrement: the verify writes K/V for every draft
token, and a rejected token's K/V stays past the new commit point, where
the next writes land before any mask admits it (the slot owns that row
or those pages; a write past its pages goes to the sink).

The draft keeps its own DENSE ``(num_slots, max_seq_len)`` KV cache
(a per-row :class:`~ray_lightning_tpu_torch.models.transformer.DenseKV`
per layer). Every slot activation marks the row stale
(:class:`SpecDecoder`), and before the next spec dispatch the engine
rebuilds it by a ``(1, max_seq_len)`` prefill of the row's whole context
(:func:`_draft_refill_impl`) -- which is why chunked prefill and prefix
adoption compose with a draft.

The draft half runs no kernel of its own (plain PyTorch, as the JAX
package runs it in XLA) except K5 when its weights are quantized.

Multi-LoRA: the rows' adapter bank ids (``adapter_ids=``) reach the
TARGET verify only; the draft stays unadapted (one draft serves every
adapter: a draft that disagrees more costs acceptance, never
correctness), as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set

import numpy as np
import torch

from ray_lightning_tpu_torch.models.generate import (_mix64, _prefill_impl,
                                                    decode_step, row_seed,
                                                    sample_logits_rows,
                                                    verify_step,
                                                    verify_step_paged)
from ray_lightning_tpu_torch.models.quant import param_bytes
from ray_lightning_tpu_torch.models.transformer import (TransformerLM,
                                                        new_cache)
from ray_lightning_tpu_torch.serve.pages import (dense_storage_commit,
                                                 dense_storage_values,
                                                 gather_pages, scatter_pages)

__all__ = ["SpecDecoder", "stream_seed"]

#: sub-stream tags off each step seed (see the module docstring)
_DRAFT_STREAM = 1
_ACCEPT_STREAM = 2
_NEG = torch.finfo(torch.float32).min
_TINY = torch.finfo(torch.float32).tiny


def stream_seed(step_seed: int, tag: int) -> int:
    """Sub-stream ``tag`` of one step's seed (JAX ``fold_in(key, tag)``)."""
    return _mix64(step_seed ^ _mix64(tag))


def _uniform(seed: int, shape, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device)


def _row_probs(logits: torch.Tensor, temperature, top_k) -> torch.Tensor:
    """Per-row sampling distribution over (B, V) logits: the softmax of
    exactly the processed logits :func:`sample_logits_rows` draws from
    (temperature scaling, then the top-k rank mask), so the rejection
    test's ``p``/``q`` are what the samplers did. Greedy rows get a
    well-defined (unused) distribution. ``temperature`` and ``top_k``
    are (B,) host values."""
    dev = logits.device
    t = torch.as_tensor(np.asarray(temperature, np.float32), device=dev)
    tk = np.asarray(top_k, np.int64)
    logits = logits.float()
    scaled = logits / torch.where(t > 0, t, 1.0)[:, None]
    if (tk > 0).any():
        order = torch.argsort(-logits, dim=-1, stable=True)
        ranks = torch.empty_like(order)
        ranks.scatter_(1, order, torch.arange(
            logits.shape[1], device=dev).expand_as(order))
        tk_t = torch.as_tensor(tk, device=dev)[:, None]
        scaled = torch.where((tk_t > 0) & (ranks >= tk_t), _NEG, scaled)
    return torch.softmax(scaled, dim=-1)


def _spec_accept(L, draft_toks, draft_logits, cur, pos, active, remaining,
                 temp, top_k, eos, stepno, step_seeds, max_pos, *, k):
    """Accept and commit for one round, over every row at once.

    ``L`` (B, k+1, V) target logits, offset ``j`` conditioned on the
    row's context plus drafts ``< j``; ``draft_toks`` (B, k) int32;
    ``draft_logits`` (B, k, V). ``temp``/``top_k`` are (B,) host values;
    ``step_seeds`` is None for an all-greedy batch, else k+1 lists of B
    seeds, those of steps ``stepno + j``. Returns the updated row state
    (cur, pos, active, remaining, stepno) plus ``emitted`` (B, k+1) --
    committed tokens in order, −1 past each row's commit count --
    ``accepted`` (B,), the committed DRAFT tokens, ``rejected`` (B,), 1
    iff a real divergence entered the committed stream, and
    ``finished`` (B,). Draft agreements cut by the budget or an eos are
    neither accepted nor rejected.
    """
    B, dev = cur.shape[0], cur.device
    sampled = np.asarray(temp) > 0.0
    tgts = torch.argmax(L, dim=-1).to(torch.int32)        # (B, k+1)
    acc = draft_toks == tgts[:, :k]
    fix = tgts[:, :k]
    if sampled.any():
        # the batch-level gate: an all-greedy batch never gets here
        acc, fix = acc.clone(), fix.clone()
        rows = np.flatnonzero(sampled)
        for j in range(k):
            d = draft_toks[:, j].long()[:, None]
            p = _row_probs(L[:, j], temp, top_k)
            q = _row_probs(draft_logits[:, j], temp, top_k)
            p_d, q_d = p.gather(1, d)[:, 0], q.gather(1, d)[:, 0]
            residual = torch.clamp(p - q, min=0.0)
            res = torch.where(residual.sum(-1, keepdim=True) > 0,
                              residual, p)
            logr = torch.log(res + 1e-30)
            for r in rows:
                seed = step_seeds[j][r]
                u = _uniform(stream_seed(seed, _ACCEPT_STREAM), (1,), dev)
                # u < p/q, multiplication first: q_d == 0 rejects
                acc[r, j] = (u * q_d[r] < p_d[r])[0]
                g = -torch.log(-torch.log(
                    _uniform(seed, logr.shape[1:], dev).clamp_min(_TINY)))
                fix[r, j] = torch.argmax(logr[r] + g).to(torch.int32)
    # the bonus after a fully accepted block: the target's own sample at
    # offset k, with the plain step seed -- the non-spec engine's draw
    bonus = sample_logits_rows(
        L[:, k], step_seeds[k] if step_seeds is not None else [0] * B,
        temp, top_k)
    fixes_all = torch.cat([fix, bonus[:, None]], dim=1)
    a = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)     # (B,)
    fix_at_a = fixes_all.gather(1, a.long()[:, None])
    idx = torch.arange(k + 1, device=dev)[None, :]
    drafts_pad = torch.cat(
        [draft_toks, torch.zeros((B, 1), dtype=torch.int32, device=dev)],
        dim=1)
    tok = torch.where(idx < a[:, None], drafts_pad, fix_at_a)

    # commit mask: a prefix per row -- the accepted drafts and the fix or
    # bonus, clamped by the budget, cut after the first eos, none for
    # inactive rows
    within = (idx <= a[:, None]) & (idx < remaining[:, None])
    is_eos = (tok == eos[:, None]) & (eos >= 0)[:, None]
    eos_i = is_eos.to(torch.int32)
    eos_before = torch.cumsum(eos_i, dim=1) - eos_i
    within = within & (eos_before == 0) & active[:, None]
    n = within.to(torch.int32).sum(dim=1)
    emitted = torch.where(within, tok, -1)
    accepted = torch.minimum(n, a)
    # a real rejection: the divergence fix committed (n == a+1, a < k)
    rejected = (active & (a < k) & (n == a + 1)).to(torch.int32)

    last = tok.gather(1, (n - 1).clamp(0, k).long()[:, None])
    commit = active & (n > 0)
    cur = torch.where(commit[:, None], last, cur)
    pos = torch.clamp(pos + n[:, None], max=max_pos)
    stepno = stepno + n
    remaining = remaining - n
    hit_eos = torch.any(is_eos & within, dim=1)
    finished = active & (hit_eos | (remaining <= 0))
    active = active & ~finished
    return (cur, pos, active, remaining, stepno, emitted, accepted,
            rejected, finished)


def _draft_propose(draft_model, draft_cache, cur, pos, temp, top_k,
                   draft_seeds, max_pos, *, k):
    """One round's draft half: k+1 single-token feeds -- feed ``j`` puts
    token ``t_j`` (``t_0 = cur``, then the proposals) at ``pos + j`` and
    proposes ``d_{j+1}``; the last feed only writes its K/V (the cache
    then covers a fully accepted round). ``draft_seeds``: None (all
    greedy) or k lists of B seeds. Returns ``(draft_toks (B, k) int32,
    draft_logits (B, k, V))``."""
    B = cur.shape[0]
    t, toks, logits_all = cur, [], []
    for j in range(k + 1):
        logits = decode_step(draft_model, draft_cache, t,
                             torch.clamp(pos + j, max=max_pos))
        if j == k:
            break
        d = sample_logits_rows(
            logits, draft_seeds[j] if draft_seeds is not None else [0] * B,
            temp, top_k)
        toks.append(d)
        logits_all.append(logits)
        t = d[:, None]
    return torch.stack(toks, dim=1), torch.stack(logits_all, dim=1)


def _round_seeds(engine_seed: int, request_seeds: np.ndarray,
                 sampled: np.ndarray, stepno: torch.Tensor,
                 k: int) -> Optional[List[List[int]]]:
    """The step seeds of one round, ``[j][row]`` for steps ``stepno + j``,
    j = 0..k (0 for greedy rows); None for an all-greedy batch, which
    then never reads ``stepno`` back to the host."""
    if not sampled.any():
        return None
    st = stepno.cpu().numpy()
    return [[row_seed(engine_seed, int(request_seeds[r]), int(st[r]) + j)
             if sampled[r] else 0 for r in range(len(st))]
            for j in range(k + 1)]


def _spec_rounds(verify, max_seq_len, draft_model, draft_cache, cur, pos,
                 active, remaining, temp, top_k, eos, stepno, engine_seed,
                 request_seeds, *, k, rounds):
    """``rounds`` spec rounds: each is k+1 draft feeds, one ``(B, k+1)``
    target verify (``verify(tokens, kv_positions)`` gives its (B, k+1,
    V) logits), and the accept rule. Inactive rows run the same math at
    frozen positions: their draft writes go into a row the next
    activation refills. ``temp`` (B,) is zero for rows not in flight at
    entry. Returns the row state and ``emitted`` (rounds, B, k+1),
    ``accepted``, ``rejected``, ``finished`` (rounds, B)."""
    max_pos = max_seq_len - 1
    sampled = np.asarray(temp) > 0.0
    offs = torch.arange(k + 1, dtype=pos.dtype, device=pos.device)[None]
    outs = []
    for _ in range(rounds):
        step_seeds = _round_seeds(engine_seed, request_seeds, sampled,
                                  stepno, k)
        draft_seeds = None if step_seeds is None else [
            [stream_seed(s, _DRAFT_STREAM) for s in row] for row in
            step_seeds[:k]]
        draft_toks, draft_logits = _draft_propose(
            draft_model, draft_cache, cur, pos, temp, top_k, draft_seeds,
            max_pos, k=k)
        tokens_in = torch.cat([cur, draft_toks], dim=1)
        L = verify(tokens_in, torch.clamp(pos + offs, max=max_pos))
        (cur, pos, active, remaining, stepno, emitted, accepted, rejected,
         finished) = _spec_accept(
            L, draft_toks, draft_logits, cur, pos, active, remaining, temp,
            top_k, eos, stepno, step_seeds, max_pos, k=k)
        outs.append((emitted, accepted, rejected, finished))
    emitted, accepted, rejected, finished = (torch.stack(x) for x in
                                             zip(*outs))
    return (cur, pos, active, remaining, stepno, emitted, accepted,
            rejected, finished)


def _spec_rounds_page_native_impl(model, draft_model, arena, page_table,
                                  *rows, k, rounds, adapter_ids=None):
    """The spec rounds with the verify through the (write-masked) page
    table: inactive rows' target writes go to the sink. ``rows`` are
    :func:`_spec_rounds`' from ``draft_cache`` on."""
    return _spec_rounds(
        lambda tokens, positions: verify_step_paged(
            model, arena, tokens, positions, page_table, adapter_ids),
        model.cfg.max_seq_len, draft_model, *rows, k=k, rounds=rounds)


def _spec_rounds_impl(model, draft_model, storage, *rows, k, rounds,
                      adapter_ids=None):
    """The spec rounds on dense target storage (the slot pool, or a
    gathered view): the verify block-writes each row's k+1 tokens into
    its own row (:func:`~ray_lightning_tpu_torch.models.generate.verify_step`).
    int8 storage is dequantized whole before the rounds and re-quantized
    whole after, as the plain dense step does."""
    cache = dense_storage_values(storage, model.cfg.dtype)
    out = _spec_rounds(
        lambda tokens, positions: verify_step(model, cache, tokens,
                                              positions, adapter_ids),
        model.cfg.max_seq_len, draft_model, *rows, k=k, rounds=rounds)
    dense_storage_commit(storage, cache)
    return out


def _spec_rounds_paged_impl(model, draft_model, arena, page_table, *rows, k,
                            rounds, adapter_ids=None):
    """The spec rounds on a page arena without page-native attention:
    gather the dense view through the full ``page_table``, run
    :func:`_spec_rounds_impl` on it, scatter back the mapped pages of
    the rows active at entry (``rows[3]``), as the dense-view step
    does."""
    view = gather_pages(arena, page_table, model.cfg.dtype)
    write_pt = torch.where(rows[3][:, None], page_table, -1)
    out = _spec_rounds_impl(model, draft_model, view, *rows, k=k,
                            rounds=rounds, adapter_ids=adapter_ids)
    scatter_pages(arena, view, write_pt)
    return out


def _draft_refill_impl(draft_model, pool_cache, tokens: torch.Tensor,
                       length: torch.Tensor, slot: int) -> None:
    """Rebuild ONE slot's draft KV row from its whole context: a
    ``(1, P)`` ragged prefill (P = max_seq_len, so any context fits) and
    the row copied in whole at ``slot``, so nothing of the slot's last
    tenant or of parked rounds survives an activation."""
    pf_cache, _ = _prefill_impl(draft_model, tokens, length)
    for pool, pf in zip(pool_cache, pf_cache):
        pool.key[slot] = pf.key[0]
        pool.value[slot] = pf.value[0]


class SpecDecoder:
    """The draft model, its dense ``(num_slots, max_seq_len)`` KV cache
    and the stale-slot ledger of one engine's spec path.

    ``draft_model`` is a port ``TransformerLM`` (its config is used) and
    ``draft_params`` its state dict; the decoder builds its own copy on
    ``device`` (``weight_dtype=`` quantizes it, as the engine quantizes
    the target). Every slot activation marks its row stale; the engine
    refills stale rows before the next spec dispatch. The JAX decoder
    refuses a draft config with ``decode=False``; here ``decode`` changes
    nothing and either value is taken.
    """

    def __init__(self, draft_model, draft_params, *, num_slots: int, k: int,
                 target_cfg, device=None,
                 weight_dtype: Optional[str] = None,
                 weight_group_size: Optional[int] = None):
        cfg = draft_model.cfg
        if cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size ({cfg.vocab_size}) must match the "
                f"target's ({target_cfg.vocab_size}) -- draft proposals "
                "are verified id-for-id")
        if cfg.max_seq_len != target_cfg.max_seq_len:
            raise ValueError(
                f"draft max_seq_len ({cfg.max_seq_len}) must match the "
                f"target's ({target_cfg.max_seq_len}) -- draft and target "
                "decode the same absolute positions")
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        self.model = TransformerLM(cfg, device="meta").to_empty(
            device=device)
        self.model.load_state_dict(draft_params)
        self.model.requires_grad_(False).eval()
        # at-rest bytes before and after quantization (the engine's
        # engine.weights_quantized event); None unquantized
        self.quantized_bytes = None
        if weight_dtype is not None:
            before = self.param_bytes()
            self.model.quantize_weights(weight_dtype, weight_group_size)
            self.quantized_bytes = (before, self.param_bytes())
        self.k = k
        self.num_slots = num_slots
        self.prefill_len = cfg.max_seq_len
        self.cache = new_cache(cfg, num_slots, self.model.device)
        self._stale: Set[int] = set()
        self.refills = 0

    def param_bytes(self) -> int:
        return param_bytes(self.model.named_weights())

    # ----------------------------------------------------------- ledger
    @property
    def stale(self) -> List[int]:
        return sorted(self._stale)

    def mark_stale(self, slot: int) -> None:
        self._stale.add(slot)

    def discard(self, slot: int) -> None:
        self._stale.discard(slot)

    # ----------------------------------------------------------- refill
    def refill(self, slot: int, context: Sequence[int]) -> None:
        """Rebuild ``slot``'s draft KV from ``context``: the row's prompt
        and every committed token but the current one, so the cache
        covers positions ``0..pos-1`` and the next round feeds the
        current token at ``pos``."""
        P = self.prefill_len
        if not 1 <= len(context) <= P:
            raise ValueError(
                f"draft refill context length {len(context)} outside "
                f"[1, {P}]")
        tokens = np.zeros((1, P), np.int64)
        tokens[0, :len(context)] = context
        dev = self.model.device
        with torch.inference_mode():
            _draft_refill_impl(self.model, self.cache,
                               torch.from_numpy(tokens).to(dev),
                               torch.tensor([len(context)], device=dev),
                               slot)
        self.refills += 1
        self._stale.discard(slot)

    def shutdown(self) -> None:
        """Drop the draft KV cache (device memory)."""
        self.cache = None
        self._stale.clear()
