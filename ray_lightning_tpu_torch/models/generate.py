"""Generation: one-shot ``generate()`` and the serving engine's pieces (counterpart of ``ray_lightning_tpu/models/generate.py``).

**Outside the engine** (T9): :func:`generate` runs a ``(B, P)`` prompt
batch through one prefill (:func:`prefill`, the shared-index cache
mode) and ``max_new_tokens - 1`` cached single-token steps: uniform
prompts step at the caches' shared index, ragged ones
(``prompt_lengths=``) each row at its own position through
:func:`decode_step`. :func:`generate_full_scan` is the reference path
that teacher-forces the prompt through the same one-token step.
:func:`sample_logits` samples one batch with one set of parameters.

**The engine's pieces**: :func:`_prefill_impl` fills a batch of
ragged, left-aligned prompts in one forward; :func:`_chunk_prefill_impl`
runs one chunk of one long prompt through its pages;
:func:`decode_step_paged` runs one cached step through the page arena
and :func:`decode_step` one on dense per-row caches;
:func:`sample_logits_rows` samples each row with its own parameters.
Speculative decoding adds :func:`verify_step` and
:func:`verify_step_paged` (the target scoring T tokens a row, on dense
caches or through the arena). Each of these takes ``adapter_ids`` (B,),
the rows' LoRA bank slots on a model with adapter banks (−1 = the base
model); None leaves the model's default (slot 0 on a LoRA model).

**Sampling keys.** The JAX engine draws row ``r``'s noise from the
threefry key ``fold_in(fold_in(base, seed), step)``, which torch cannot
reproduce. The port derives it from :func:`row_seed`, a 64-bit mix of
(engine seed, request seed, step) that seeds a ``torch.Generator`` on the
logits' device for that row alone. The contract stays the JAX engine's:
a sampled stream depends only on those three values, never on the slot
or on which requests share the batch. :func:`generate` takes ``rng`` as
an integer seed or a ``torch.Generator`` on the model's device and draws
every step from it, where JAX splits one threefry key a step. Across the
two frameworks only greedy tokens can be compared.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ray_lightning_tpu_torch.models.transformer import (ChunkKV, latch_eos,
                                                        new_cache)

_MASK64 = (1 << 64) - 1
_NEG = torch.finfo(torch.float32).min
_TINY = torch.finfo(torch.float32).tiny


def _logits_only(outputs):
    """The logits of a model's output: a Mixture-of-Experts LM returns
    ``(logits, aux)`` (the JAX ``generate.py``'s ``_logits_only``)."""
    return outputs[0] if isinstance(outputs, tuple) else outputs


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
            scaled = torch.where(ranks >= k, _NEG, scaled)
        gen = torch.Generator(device=row.device)
        gen.manual_seed(int(seeds[r]))
        out[r] = _gumbel_argmax(scaled, gen).to(torch.int32)
    return out


def _gumbel_argmax(scaled: torch.Tensor,
                   gen: torch.Generator) -> torch.Tensor:
    """The categorical draw over the last axis of ``scaled`` logits:
    argmax of logits plus Gumbel noise from ``gen``."""
    u = torch.rand(scaled.shape, generator=gen, device=scaled.device)
    return torch.argmax(scaled - torch.log(-torch.log(u.clamp_min(_TINY))),
                        dim=-1)


def _generator(rng: Union[int, torch.Generator, None],
               device: torch.device) -> torch.Generator:
    """The generator a sampled :func:`generate` draws from: ``rng``
    itself, or one on ``device`` seeded with the integer ``rng``."""
    if isinstance(rng, torch.Generator):
        if rng.device.type != torch.device(device).type:
            raise ValueError(
                f"rng is a generator on {rng.device}, the model is on "
                f"{device}: pass a generator on the model's device or an "
                "integer seed")
        return rng
    if isinstance(rng, (int, np.integer)):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng))
        return gen
    raise TypeError(f"rng must be an int seed or a torch.Generator, got "
                    f"{type(rng).__name__}")


def sample_logits(logits: torch.Tensor,
                  rng: Union[int, torch.Generator, None] = None,
                  temperature: float = 1.0,
                  top_k: Optional[int] = None) -> torch.Tensor:
    """Sample token ids from (B, V) logits with one set of parameters;
    returns (B,) int32.

    ``temperature=0`` is greedy argmax (``rng`` unused); otherwise a
    Gumbel-max draw over ``logits / temperature`` from ``rng`` (an
    integer seed or a ``torch.Generator`` on the logits' device).
    ``top_k`` keeps the logits at or above the k-th largest, ties with
    it included, as JAX's ``lax.top_k`` threshold does."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, _NEG, scaled)
    gen = _generator(rng, logits.device)
    return _gumbel_argmax(scaled, gen).to(torch.int32)


def _adapter_kw(adapter_ids):
    """The ``adapter_ids`` keyword only when set: a model call without
    it is the call every path made before LoRA."""
    return {} if adapter_ids is None else {"adapter_ids": adapter_ids}


def _arena_apply(model, arena, tokens: torch.Tensor,
                 kv_positions: torch.Tensor, page_table: torch.Tensor,
                 adapter_ids=None):
    """Page-native forward: the arena (one ``PagedKV`` per layer) is read
    and written in place through ``page_table``."""
    return _logits_only(model(
        tokens, positions=kv_positions, kv_positions=kv_positions,
        page_table=page_table, cache=arena, **_adapter_kw(adapter_ids)))


def decode_step_paged(model, arena, tokens: torch.Tensor,
                      kv_positions: torch.Tensor, page_table: torch.Tensor,
                      adapter_ids=None):
    """ONE cached step through the page arena: ``tokens`` (B, 1) at
    ``kv_positions`` (B, 1); ``page_table`` (B, pages_per_slot) int32 is
    the engine's write-masked table (−1 rows write nothing that is read).
    Returns the last logits (B, V)."""
    return _arena_apply(model, arena, tokens, kv_positions, page_table,
                        adapter_ids)[:, -1]


def verify_step_paged(model, arena, tokens: torch.Tensor,
                      kv_positions: torch.Tensor, page_table: torch.Tensor,
                      adapter_ids=None):
    """The speculative verify through the page arena: ``tokens`` (B, T)
    -- each row's current token and its T-1 draft proposals -- at
    ``kv_positions`` (B, T), the run ``pos..pos+T-1``. Every token's K/V
    is written before the read side attends, so offset ``j``'s logits
    are what T sequential :func:`decode_step_paged` calls give. Returns
    all of them, (B, T, V)."""
    return _arena_apply(model, arena, tokens, kv_positions, page_table,
                        adapter_ids)


def decode_step(model, cache, tokens: torch.Tensor,
                kv_positions: torch.Tensor, adapter_ids=None):
    """ONE cached step on dense per-row caches (a list of ``DenseKV``,
    updated in place): ``tokens`` (B, 1) at ``kv_positions`` (B, 1), each
    row at its own position. Returns the last logits (B, V)."""
    return _logits_only(model(
        tokens, positions=kv_positions, kv_positions=kv_positions,
        cache=cache, **_adapter_kw(adapter_ids)))[:, -1]


def verify_step(model, cache, tokens: torch.Tensor,
                kv_positions: torch.Tensor, adapter_ids=None):
    """The speculative verify on dense per-row caches (a list of
    ``DenseKV``, updated in place): ``tokens`` (B, T) -- each row's
    current token and its T-1 draft proposals -- block-written at the
    run ``kv_positions`` (B, T) under a block-causal mask, so offset
    ``j``'s logits are what T sequential :func:`decode_step` calls give.
    Returns all of them, (B, T, V)."""
    return _logits_only(model(
        tokens, positions=kv_positions, kv_positions=kv_positions,
        cache=cache, **_adapter_kw(adapter_ids)))


def _prefill_impl(model, prompt_tokens: torch.Tensor,
                  prompt_lengths: Optional[torch.Tensor], adapter_ids=None):
    """Single-pass prompt fill of (B, P) left-aligned prompts into fresh
    shared-index caches covering the whole ``max_seq_len`` row (zeros
    past P). Returns ``(cache, last_logits (B, V))``, the logits at each
    row's ``length - 1``: causality keeps a short row's pad tail out of
    them, and its pad K/V stays masked until decode overwrites it."""
    B, P = prompt_tokens.shape
    cache = new_cache(model.cfg, B, model.device)
    positions = torch.arange(P, device=prompt_tokens.device)[None]
    logits = _logits_only(model(prompt_tokens, positions=positions,
                                cache=cache, **_adapter_kw(adapter_ids)))
    if prompt_lengths is None:
        last = logits[:, -1]
    else:
        idx = (prompt_lengths.long() - 1)[:, None, None]
        last = logits.gather(1, idx.expand(B, 1, logits.shape[-1]))[:, 0]
    return cache, last


def _chunk_prefill_impl(model, arena, row_pages: torch.Tensor,
                        tokens: torch.Tensor, offset: int, valid_len: int,
                        adapter_ids=None):
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
    logits = _logits_only(model(tokens, positions=positions, cache=cache,
                                **_adapter_kw(adapter_ids)))
    return logits[:, valid_len - 1]


# ------------------------------------------------- decode outside the engine
class _WithParams:
    """``model`` called with ``params`` (a state dict) in place of its
    own weights (``torch.func.functional_call``); the model is not
    changed."""

    def __init__(self, model, params):
        self.module, self.params = model, params
        self.cfg, self.device = model.cfg, model.device

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self.module, self.params, args,
                                          kwargs)


def _bind(model, params):
    return model if params is None else _WithParams(model, params)


def _as_tokens(tokens, device) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    return tokens.to(device=device, dtype=torch.long)


def _check_decode_model(model, P: int, max_new_tokens: int = 0) -> None:
    """The prompt and its generation must fit the model's ``max_seq_len``.
    Unlike JAX's check, a config with ``decode=False`` is taken: every
    port module carries its caches."""
    cfg = model.cfg
    if P + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq_len ({cfg.max_seq_len})")


def prefill(model, params, prompt_tokens,
            prompt_lengths=None):
    """Single-pass prompt fill: the ``(B, P)`` prompt through the
    shared-index cache mode in one forward. Returns ``(cache,
    last_logits)``: one ``DenseKV`` per layer (index P) and the (B, V)
    logits at each row's last prompt position (``prompt_lengths[i] - 1``
    when lengths are given, else ``P - 1``). ``params`` is a state dict
    for the model's parameters, or None for its own weights.

    After a ragged prefill the positions ``lengths[i]..P-1`` of short rows
    hold pad K/V: continue with per-row :func:`decode_step`\\ s at
    ``lengths + s``, as :func:`generate` does, never with shared-index
    steps."""
    tokens = _as_tokens(prompt_tokens, model.device)
    _check_decode_model(model, tokens.shape[1])
    lengths = (None if prompt_lengths is None
               else _as_tokens(prompt_lengths, model.device))
    with torch.no_grad():
        return _prefill_impl(_bind(model, params), tokens, lengths)


def _prefill_start(model, prompt_tokens, lengths, gen, *, max_new_tokens,
                   temperature, top_k, eos_id, ragged):
    """The prefill, the first token's sample, and the output buffer
    (B, P + max_new_tokens) with the first token at each row's length."""
    B, P = prompt_tokens.shape
    cache, last = _prefill_impl(model, prompt_tokens,
                                lengths if ragged else None)
    first = sample_logits(last, gen, temperature, top_k)
    done = (first == eos_id if eos_id is not None
            else torch.zeros((B,), dtype=torch.bool, device=first.device))
    tokens = torch.cat([prompt_tokens.to(torch.int32),
                        torch.zeros((B, max_new_tokens), dtype=torch.int32,
                                    device=first.device)], dim=1)
    tokens.scatter_(1, lengths[:, None], first[:, None])
    return cache, tokens, done


def _decode_scan(model, cache, tokens, lengths, gen, done, *, steps,
                 temperature, top_k, eos_id, ragged):
    """``steps`` cached single-token steps after the prefill, writing
    each sample into ``tokens`` in place. Uniform rows step at the
    caches' shared index; ragged rows at their own ``lengths + s``, the
    engine's per-row :func:`decode_step`. A row that sampled ``eos_id``
    repeats it."""
    B, total = tokens.shape
    eos = (None if eos_id is None else
           torch.full((B,), eos_id, dtype=torch.int32, device=tokens.device))
    for s in range(steps):
        if ragged:
            pos = (lengths + s)[:, None]
            cur = tokens.gather(1, pos)
            last = decode_step(model, cache, cur, pos)
        else:
            t = total - steps - 1 + s
            pos = torch.full((B, 1), t, dtype=torch.long,
                             device=tokens.device)
            last = _logits_only(model(tokens[:, t:t + 1], positions=pos,
                                      cache=cache))[:, -1]
        nxt = sample_logits(last, gen, temperature, top_k)
        if eos is not None:
            nxt, done = latch_eos(nxt, done, eos)
        tokens.scatter_(1, (lengths + s + 1)[:, None], nxt[:, None])
    return tokens


def _lengths(prompt_lengths, B: int, P: int, device) -> torch.Tensor:
    if prompt_lengths is None:
        return torch.full((B,), P, dtype=torch.long, device=device)
    lengths = _as_tokens(prompt_lengths, device)
    if lengths.shape != (B,) or bool(((lengths < 1) | (lengths > P)).any()):
        raise ValueError(
            f"prompt_lengths must be ({B},) values in 1..{P}, got "
            f"{lengths.tolist()}")
    return lengths


def generate(model, params, prompt_tokens, max_new_tokens: int,
             rng: Union[int, torch.Generator, None],
             temperature: float = 1.0, top_k: Optional[int] = None,
             prompt_lengths=None, eos_id: Optional[int] = None,
             use_prefill: bool = True) -> torch.Tensor:
    """Generate ``max_new_tokens`` past ``prompt_tokens`` (B, P) (a
    tensor, array or nested list of token ids).

    Returns (B, P + max_new_tokens) int32 on the model's device.
    ``params`` is a state dict for the model's parameters, or None for
    the model's own weights (a quantized model runs its quantized
    matmuls: the fused kernel under ``matmul_kernel="cuda"``). ``rng``
    is an integer seed or a ``torch.Generator`` on the model's device
    (unused when ``temperature`` is 0, greedy).

    One prefill (:func:`prefill`), then ``max_new_tokens - 1`` cached
    steps. Ragged prompts: left-align each row, pad to P and pass
    ``prompt_lengths`` (B,); row ``i`` emits exactly ``max_new_tokens``
    tokens at positions ``lengths[i]..lengths[i] + max_new_tokens - 1``,
    and the rest of its row keeps the pad it had (zeros past P).
    ``eos_id`` stops a row once sampled: every later token of its window
    repeats it. ``use_prefill=False`` runs :func:`generate_full_scan`;
    greedy tokens are the same either way."""
    if not use_prefill:
        return generate_full_scan(model, params, prompt_tokens,
                                  max_new_tokens, rng, temperature, top_k,
                                  prompt_lengths, eos_id)
    tokens = _as_tokens(prompt_tokens, model.device)
    B, P = tokens.shape
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    _check_decode_model(model, P, max_new_tokens)
    ragged = prompt_lengths is not None
    lengths = _lengths(prompt_lengths, B, P, model.device)
    gen = None if temperature == 0.0 else _generator(rng, model.device)
    fwd = _bind(model, params)
    with torch.no_grad():
        cache, out, done = _prefill_start(
            fwd, tokens, lengths, gen, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, eos_id=eos_id,
            ragged=ragged)
        if max_new_tokens == 1:
            return out
        return _decode_scan(fwd, cache, out, lengths, gen, done,
                            steps=max_new_tokens - 1,
                            temperature=temperature, top_k=top_k,
                            eos_id=eos_id, ragged=ragged)


def generate_full_scan(model, params, prompt_tokens, max_new_tokens: int,
                       rng: Union[int, torch.Generator, None],
                       temperature: float = 1.0,
                       top_k: Optional[int] = None, prompt_lengths=None,
                       eos_id: Optional[int] = None) -> torch.Tensor:
    """The one-loop reference path: the prompt is teacher-forced through
    the same one-token shared-index step that samples (P sequential
    steps before the first new token). Every row is filled to ``P +
    max_new_tokens`` (a short row keeps generating past its own window),
    and eos latches only once a row is past its prompt. Same arguments
    and result as :func:`generate`."""
    tokens_in = _as_tokens(prompt_tokens, model.device)
    B, P = tokens_in.shape
    _check_decode_model(model, P, max_new_tokens)
    total = P + max_new_tokens
    lengths = _lengths(prompt_lengths, B, P, model.device)
    gen = None if temperature == 0.0 else _generator(rng, model.device)
    fwd = _bind(model, params)
    dev = model.device
    tokens = torch.cat([tokens_in.to(torch.int32),
                        torch.zeros((B, max_new_tokens), dtype=torch.int32,
                                    device=dev)], dim=1)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        cache = new_cache(model.cfg, B, dev)
        for t in range(total - 1):
            pos = torch.full((B, 1), t, dtype=torch.long, device=dev)
            last = _logits_only(fwd(tokens[:, t:t + 1], positions=pos,
                                    cache=cache))[:, -1]
            nxt = sample_logits(last, gen, temperature, top_k)
            if eos_id is not None:
                # only a row past its prompt latches: another row's
                # teacher-forced samples are thrown away
                generating = (t + 1) >= lengths
                nxt = torch.where(done, eos_id, nxt)
                done = done | (generating & (nxt == eos_id))
            tokens[:, t + 1] = torch.where(t + 1 < lengths,
                                           tokens[:, t + 1], nxt)
    return tokens
