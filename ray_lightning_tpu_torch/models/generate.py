"""Serving-side generation pieces (counterpart of ``ray_lightning_tpu/models/generate.py``).

The prefill/decode split the engine runs: :func:`_prefill_impl` fills a
batch of ragged, left-aligned prompts in one forward;
:func:`_chunk_prefill_impl` runs one chunk of one long prompt through
its pages; :func:`decode_step_paged` runs one cached step through the
page arena; :func:`sample_logits_rows` samples each row with its own
parameters. Speculative decoding adds :func:`decode_step` (a draft's
step on its dense per-row cache) and :func:`verify_step_paged` (the
target scoring T tokens a row through the arena).

**Sampling keys.** The JAX engine draws row ``r``'s noise from the
threefry key ``fold_in(fold_in(base, seed), step)``, which torch cannot
reproduce. The port derives it from :func:`row_seed`, a 64-bit mix of
(engine seed, request seed, step) that seeds a ``torch.Generator`` on the
logits' device for that row alone. The contract stays the JAX engine's:
a sampled stream depends only on those three values, never on the slot
or on which requests share the batch. Across the two frameworks only
greedy tokens can be compared.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ray_lightning_tpu_torch.models.transformer import ChunkKV, new_cache

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def row_seed(engine_seed: int, request_seed: int, step: int) -> int:
    """The counter-based seed of one row's sample at one step."""
    h = _mix64(engine_seed & _MASK64)
    h = _mix64(h ^ (request_seed & _MASK64))
    return _mix64(h ^ (step & _MASK64))


def sample_logits_rows(logits: torch.Tensor, seeds: Sequence[int],
                       temperature: Sequence[float],
                       top_k: Sequence[int]) -> torch.Tensor:
    """Per-row sampling from (B, V) logits; returns (B,) int32.

    ``temperature`` 0 is greedy argmax for that row (the first maximal
    index, as ``jnp.argmax``); ``top_k`` 0 is unrestricted, else the
    ``k`` highest logits stay (ties broken by a stable descending sort).
    ``seeds`` (from :func:`row_seed`) feed one ``torch.Generator`` per
    sampled row: Gumbel-max over ``logits / temperature``, the
    categorical draw ``jax.random.categorical`` makes. The three
    sequences are host values: an all-greedy batch pays one argmax.
    """
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    neg = torch.finfo(torch.float32).min
    tiny = torch.finfo(torch.float32).tiny
    for r in range(logits.shape[0]):
        t = float(temperature[r])
        if t <= 0.0:
            continue
        row = logits[r].float()
        scaled = row / t
        k = int(top_k[r])
        if k > 0:
            order = torch.argsort(-row, stable=True)
            ranks = torch.empty_like(order)
            ranks[order] = torch.arange(row.shape[0], device=row.device)
            scaled = torch.where(ranks >= k, neg, scaled)
        gen = torch.Generator(device=row.device)
        gen.manual_seed(int(seeds[r]))
        u = torch.rand(row.shape, generator=gen, device=row.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        out[r] = torch.argmax(scaled + gumbel).to(torch.int32)
    return out


def _arena_apply(model, arena, tokens: torch.Tensor,
                 kv_positions: torch.Tensor, page_table: torch.Tensor):
    """Page-native forward: the arena (one ``PagedKV`` per layer) is read
    and written in place through ``page_table``."""
    return model(tokens, positions=kv_positions, kv_positions=kv_positions,
                 page_table=page_table, cache=arena)


def decode_step_paged(model, arena, tokens: torch.Tensor,
                      kv_positions: torch.Tensor, page_table: torch.Tensor):
    """ONE cached step through the page arena: ``tokens`` (B, 1) at
    ``kv_positions`` (B, 1); ``page_table`` (B, pages_per_slot) int32 is
    the engine's write-masked table (−1 rows write nothing that is read).
    Returns the last logits (B, V)."""
    return _arena_apply(model, arena, tokens, kv_positions, page_table)[:, -1]


def verify_step_paged(model, arena, tokens: torch.Tensor,
                      kv_positions: torch.Tensor, page_table: torch.Tensor):
    """The speculative verify through the page arena: ``tokens`` (B, T)
    -- each row's current token and its T-1 draft proposals -- at
    ``kv_positions`` (B, T), the run ``pos..pos+T-1``. Every token's K/V
    is written before the read side attends, so offset ``j``'s logits
    are what T sequential :func:`decode_step_paged` calls give. Returns
    all of them, (B, T, V)."""
    return _arena_apply(model, arena, tokens, kv_positions, page_table)


def decode_step(model, cache, tokens: torch.Tensor,
                kv_positions: torch.Tensor):
    """ONE cached step on dense per-row caches (a list of ``DenseKV``,
    updated in place): ``tokens`` (B, 1) at ``kv_positions`` (B, 1), each
    row at its own position. Returns the last logits (B, V)."""
    return model(tokens, positions=kv_positions, kv_positions=kv_positions,
                 cache=cache)[:, -1]


def _prefill_impl(model, prompt_tokens: torch.Tensor,
                  prompt_lengths: Optional[torch.Tensor]):
    """Single-pass prompt fill of (B, P) left-aligned prompts into fresh
    shared-index caches covering the whole ``max_seq_len`` row (zeros
    past P). Returns ``(cache, last_logits (B, V))``, the logits at each
    row's ``length - 1``: causality keeps a short row's pad tail out of
    them, and its pad K/V stays masked until decode overwrites it."""
    B, P = prompt_tokens.shape
    cache = new_cache(model.cfg, B, model.device)
    positions = torch.arange(P, device=prompt_tokens.device)[None]
    logits = model(prompt_tokens, positions=positions, cache=cache)
    if prompt_lengths is None:
        last = logits[:, -1]
    else:
        idx = (prompt_lengths.long() - 1)[:, None, None]
        last = logits.gather(1, idx.expand(B, 1, logits.shape[-1]))[:, 0]
    return cache, last


def _chunk_prefill_impl(model, arena, row_pages: torch.Tensor,
                        tokens: torch.Tensor, offset: int, valid_len: int):
    """One ``(1, C)`` chunk of one prompt at absolute ``offset`` (the
    counterpart of the JAX engine's ``_chunk_prefill_impl``): its K/V go
    into the pages it covers (``row_pages`` (pages_per_slot,) is the
    row's page-table entries on the arena's device), its queries attend
    everything the row holds up to themselves, and the logits at
    ``valid_len - 1`` (1, V) come back. Tokens past ``valid_len`` are
    padding: their K/V land in the row's later pages (or the sink),
    where causality keeps every real query from them."""
    C = tokens.shape[1]
    positions = offset + torch.arange(C, device=tokens.device)[None]
    cache = [ChunkKV(kv, row_pages, offset) for kv in arena]
    logits = model(tokens, positions=positions, cache=cache)
    return logits[:, valid_len - 1]
