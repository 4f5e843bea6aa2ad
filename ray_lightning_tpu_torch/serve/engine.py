"""Continuous-batching serving engine on dense or paged KV (counterpart of ``ray_lightning_tpu/serve/engine.py``).

Iteration-level scheduling over a fixed batch of **KV slots**:

1. **prefill** (``(prefill_batch, prefill_len)``): up to ``prefill_batch``
   waiting prompts, left-aligned, run one forward
   (:func:`~ray_lightning_tpu_torch.models.generate._prefill_impl`);
   each row samples its first token with its own parameters, and its
   whole KV row is copied into its slot (dense) or scattered into the
   pages it was given (paged).
2. **chunk prefill** (``(1, prefill_chunk)``, engines with
   ``prefill_chunk=``): ONE chunk of one prompt at its current offset
   (:func:`~ray_lightning_tpu_torch.models.generate._chunk_prefill_impl`),
   written into its pages and attending everything the row already
   holds -- the flash forward (K2) under ``attention_kernel="cuda"``.
   Long prompts (up to ``max_seq_len - max_new_tokens``) stream in
   chunk dispatches the scheduler interleaves with decode, so an
   in-flight decode stalls for one chunk, not one prompt.
   ``prefix_cache=True`` routes every prompt through chunks and lets a
   request adopt the pages of a cached prompt prefix
   (:class:`~ray_lightning_tpu_torch.serve.pages.PrefixCache`),
   starting at its first un-cached offset.
3. **step** (``(num_slots, 1)``): ``steps_per_dispatch`` cached decode
   steps for every slot at its own position. Page-native engines
   (``page_native=True``) write and read K/V straight through the page
   table inside the model's attention
   (:func:`~ray_lightning_tpu_torch.models.generate.decode_step_paged`)
   -- the read side is the CUDA paged-attention kernel under
   ``attention_kernel="cuda"``; the others run the per-row dense
   :func:`~ray_lightning_tpu_torch.models.generate.decode_step` on the
   slot pool, or on the dense view a paged engine gathers from its
   arena and scatters back (``page_native=False``). Each row samples
   with its request's own
   temperature/top_k/seed, counts down its own budget and latches its
   own eos; finished rows retire mid-flight and their slot and pages go
   to the next queued request.
4. **spec round** (engines with ``draft_model=``,
   :mod:`~ray_lightning_tpu_torch.serve.spec`): ``step()`` runs
   ``steps_per_dispatch`` speculative rounds instead of decode steps --
   k+1 draft feeds on the draft's dense cache, one ``(num_slots, k+1)``
   target verify (through the page table, K1 at T = k+1, on page-native
   engines; on the dense pool or view otherwise), and the accept rule --
   committing 1..k+1 tokens a row a round. Greedy tokens are the
   non-spec engine's by construction. Stale draft rows (every
   activation) are refilled from the row's whole context first.

``weight_dtype="int8"|"int4"`` quantizes the engine's own model after it
loads the weights (every matrix to codes plus scales, the f32 copies
dropped: :meth:`ServeEngine.param_bytes` is then the codes and scales);
``matmul_kernel="cuda"`` runs each projection and the tied LM head
through the fused dequant-matmul kernel, ``"torch"`` through its plain
version. ``draft_weight_dtype=`` quantizes a spec engine's draft the same
way, with the same group size and matmul kernel.

KV layout (JAX's three): ``page_size=None`` (the default) keeps one
``(num_slots, max_seq_len, H, D)`` K and V pool per layer
(:class:`KVSlotPool`); ``page_size=P`` a page arena behind a per-slot
page table (:class:`~ray_lightning_tpu_torch.serve.pages.PagePool`),
read and written through the table inside the attention with
``page_native=True``, or gathered into the dense per-slot view and
scattered back around each step with ``page_native=False``.
``kv_dtype="int8"`` stores K/V as absmax int8 codes: per (page, head)
scales in the arena, per (slot, position, head) in the pool, which every
dispatch dequantizes whole and re-quantizes whole.

Inactive slots still run (the batch is fixed) and their tokens are
masked out. Their K/V writes land in the arena's sink page (page-native:
the page table they see is write-masked to −1), in their own pool row
(dense: the next admission overwrites the whole row), or nowhere (the
dense view's scatter writes back only the rows active at entry). Row
state (current token, position, budget, step number) lives on the host
between dispatches -- the synced frontier -- and crosses to the device
as one packed array each way per dispatch.

**Async dispatch** (:meth:`ServeEngine.step_enqueue` /
:meth:`ServeEngine.step_sync`): an enqueue launches a step or spec
dispatch and returns a :class:`PendingDispatch` without waiting on the
card. Its outputs come back through a non-blocking copy into pinned
host memory behind a CUDA event, and its row state stays on the device
as the **carry** the next enqueue chains on, so dispatch N+1 is queued
before N's tokens reach the host. Every other host input of a dispatch
(eos ids, the page table, the adapter ids) goes up through pinned
staging, non-blocking, and is cached on the device until the host copy
changes: a steady-state enqueue makes no synchronizing call. Handles
sync exactly once, in enqueue order; admission, chunks, cancels and
adapter loads are barriers that need the synced frontier and refuse
while a handle is outstanding. A row that retired inside an un-synced
dispatch keeps its page entries one more dispatch and re-writes its
frozen K/V into its own pages; they are freed at its sync and handed to
the next admission only behind the barrier.

**Multi-LoRA** (``max_resident_adapters=``, ``lora_rank=``,
``adapters=``): a zero bank of ``max_resident_adapters`` slots is
grafted onto every targeted projection after weight quantization
(:mod:`~ray_lightning_tpu_torch.models.lora`); an
:class:`~ray_lightning_tpu_torch.serve.adapters.AdapterRegistry` maps
names to slots (LRU eviction, pinning by in-flight rows). A request's
adapter (its own, else its tenant class's default) is bound at
admission and unbound at retire, cancel or rollback; every dispatch
carries the rows' bank ids (−1 = the base model). ``tenant_classes=``
lets :meth:`ServeEngine.validate` refuse unknown tenants and
:meth:`ServeEngine.prefill` enforce each class's ``max_active_slots``.

**Crash replay** (driven by
:class:`~ray_lightning_tpu_torch.reliability.ServeSupervisor`): a
request re-admitted with ``replay_tokens`` feeds ``prompt +
replay_tokens`` through the batched prefill (up to ``prefill_len``
tokens) or through chunk dispatches (chunked engines: up to
``max_seq_len``; :attr:`ServeEngine.max_replay_len`) and samples its
next token with the seed of step ``len(replay_tokens)``, so the KV the
dead engine held is rebuilt and the stream continues where it stopped.
On a spec engine the replay prefill's draw is discarded and the row is
armed one step early: the next spec round regenerates that step through
the accept rule. :meth:`ServeEngine.snapshot_in_flight` is the synced
frontier a supervisor replays from. Every dispatch fires the fault site
``serve.dispatch`` (a spec round ``serve.verify`` too, after its draft
refills) and the ``serve.poison`` check before it launches anything or
advances the carry, so an injected crash leaves no half-issued dispatch.
Only host-side faults and out-of-memory errors recover in-process: a
sticky CUDA error poisons the process's context.

**Telemetry** (``telemetry=``, a
:class:`~ray_lightning_tpu_torch.obs.Telemetry`): the JAX engine's
events (``engine.prefill``, ``engine.chunk``, ``engine.step``,
``engine.spec_round``, ``engine.dispatch_enqueued``/``_synced``,
``engine.prefix_hit``, ``engine.adapter_*``, ``engine.weights_quantized``,
``engine.config_clamped``), spans around each dispatch and its metrics,
each payload built from host state (no device read, no added launch);
``None`` (the default) costs one attribute read a dispatch.

:data:`UNPORTED` is empty: every constructor argument of the JAX engine
is ported.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Deque, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.obs.spans import NULL_SPAN
from ray_lightning_tpu_torch.reliability import faults
from ray_lightning_tpu_torch.models import paged_attention as _pa
from ray_lightning_tpu_torch.models.lora import (LoraConfig, adapter_bytes,
                                                 install_adapter,
                                                 install_lora_bank,
                                                 zero_adapter)
from ray_lightning_tpu_torch.models.generate import (_chunk_prefill_impl,
                                                    _prefill_impl,
                                                    decode_step,
                                                    decode_step_paged,
                                                    row_seed,
                                                    sample_logits_rows)
from ray_lightning_tpu_torch.models.quant import (DEFAULT_GROUP_SIZE,
                                                  check_weight_dtype,
                                                  param_bytes)
from ray_lightning_tpu_torch.models.transformer import (ATTENTION_KERNELS,
                                                        MATMUL_KERNELS,
                                                        TransformerLM,
                                                        latch_eos,
                                                        new_cache)
from ray_lightning_tpu_torch.serve.pages import (PagePool, PrefixCache,
                                                 SlotPoolFull,
                                                 check_kv_dtype,
                                                 check_seed_free,
                                                 dense_storage_commit,
                                                 dense_storage_values,
                                                 gather_pages,
                                                 quantize_dense_cache,
                                                 scatter_pages)
from ray_lightning_tpu_torch.serve.adapters import (AdapterRegistry,
                                                    UnknownAdapter)
from ray_lightning_tpu_torch.serve.request import (Completion,
                                                   DEFAULT_TENANT,
                                                   FINISH_EOS,
                                                   FINISH_LENGTH,
                                                   FINISH_TIMEOUT, Request)
from ray_lightning_tpu_torch.serve.spec import (SpecDecoder,
                                                _spec_rounds_impl,
                                                _spec_rounds_page_native_impl,
                                                _spec_rounds_paged_impl)
from ray_lightning_tpu_torch.serve.tenancy import resolve_tenant_classes

__all__ = ["ServeEngine", "KVSlotPool", "SlotPoolFull", "PendingDispatch",
           "UNPORTED", "refuse_unported"]

#: constructor arguments of features not ported yet -> the ROADMAP.md
#: queue-A item that ports them (empty: every argument is ported)
UNPORTED: Dict[str, str] = {}


def refuse_unported(kwargs: Dict[str, object],
                    table: Dict[str, str]) -> None:
    """Raise for every argument of an unported feature that was set
    (anything but None/False); ``TypeError`` for an unknown name."""
    for name, value in kwargs.items():
        if name not in table:
            raise TypeError(f"unexpected keyword argument {name!r}")
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= is not ported to ray_lightning_tpu_torch yet "
                f"(ROADMAP.md queue A, item {table[name]})")


def _quantized_event(which: str, weight_dtype: str,
                     group_size: Optional[int], before: int,
                     after: int) -> dict:
    """The ``engine.weights_quantized`` payload of one model (the JAX
    engine's keys): its dtype, the int4 group, at-rest bytes before and
    after."""
    return dict(model=which, dtype=weight_dtype,
                group_size=(None if weight_dtype == "int8"
                            else group_size or DEFAULT_GROUP_SIZE),
                bytes_before=before, bytes_after=after)


def _advance_rows(max_seq_len: int, last, cur, pos, active, remaining,
                  temp, top_k, eos, seeds, stepno):
    """Per-row sampling + bookkeeping for one decode step's logits.

    ``cur`` is the token sampled last step, ``pos`` its absolute
    position. Inactive rows run the same math but stay frozen: emitted
    is masked to −1 and ``pos``/``stepno`` don't advance. ``temp``,
    ``top_k`` and ``seeds`` are host values (see
    :func:`sample_logits_rows`); the rest are device tensors.
    """
    nxt = sample_logits_rows(last, seeds, temp, top_k)
    # done=False: finished rows leave the batch instead of repeating eos
    _, eos_hit = latch_eos(nxt, torch.zeros_like(active), eos)
    act_i = active.to(torch.int32)
    remaining = remaining - act_i
    finished = active & (eos_hit | (remaining <= 0))
    emitted = torch.where(active, nxt, -1)
    cur = torch.where(active[:, None], nxt[:, None], cur)
    pos = torch.clamp(pos + act_i[:, None], max=max_seq_len - 1)
    stepno = stepno + act_i
    active = active & ~finished
    return cur, pos, active, remaining, stepno, emitted, finished


def _decode_steps(step, max_seq_len: int, row_state, temp, top_k,
                  seeds_at, *, steps: int) -> torch.Tensor:
    """``steps`` decode steps: ``step(cur, pos)`` gives one step's last
    logits (B, V), then the shared :func:`_advance_rows` bookkeeping;
    ``seeds_at(s)`` gives sub-step ``s``'s row seeds. Returns the
    :class:`PendingDispatch` packing (emitted and finished per sub-step,
    then cur, pos, active, remaining, stepno)."""
    cur, pos, active, remaining, stepno, eos = row_state
    emitted_all, finished_all = [], []
    for s in range(steps):
        (cur, pos, active, remaining, stepno, emitted,
         finished) = _advance_rows(
            max_seq_len, step(cur, pos), cur, pos, active, remaining, temp,
            top_k, eos, seeds_at(s), stepno)
        emitted_all.append(emitted)
        finished_all.append(finished.to(torch.int32))
    return torch.stack(emitted_all + finished_all
                       + [cur[:, 0], pos[:, 0], active.to(torch.int32),
                          remaining, stepno])


def _engine_step_impl(model, storage, row_state, temp, top_k, seeds_at, *,
                      steps: int, adapter_ids=None) -> torch.Tensor:
    """The decode step program on dense storage (the slot pool, or a
    paged engine's gathered view): ``steps`` per-row
    :func:`~ray_lightning_tpu_torch.models.generate.decode_step`\\ s on
    the compute-dtype caches. int8 storage is dequantized whole before
    them and re-quantized whole after (JAX's ``dense_storage_values`` /
    ``dense_storage_commit``). An inactive row re-writes its frozen K/V
    into its own row. ``adapter_ids`` (B,): the rows' LoRA bank slots."""
    cache = dense_storage_values(storage, model.cfg.dtype)
    packed = _decode_steps(
        lambda cur, pos: decode_step(model, cache, cur, pos, adapter_ids),
        model.cfg.max_seq_len, row_state, temp, top_k, seeds_at,
        steps=steps)
    dense_storage_commit(storage, cache)
    return packed


def _paged_step_impl(model, arena, page_table, row_state, temp, top_k,
                     seeds_at, *, steps: int,
                     adapter_ids=None) -> torch.Tensor:
    """The decode step program on a page arena without page-native
    attention: gather the dense view through the FULL page table
    (dequantizing int8 pages), run :func:`_engine_step_impl`'s body on
    it, and scatter back every mapped page of the rows active at entry
    (the others' entries masked to −1: a mid-chunking slot's pages never
    see a parked decode write). int8 pages are re-quantized per (page,
    head) as they go back."""
    view = gather_pages(arena, page_table, model.cfg.dtype)
    active = row_state[2]
    write_pt = torch.where(active[:, None], page_table, -1)
    packed = _engine_step_impl(model, view, row_state, temp, top_k,
                               seeds_at, steps=steps,
                               adapter_ids=adapter_ids)
    scatter_pages(arena, view, write_pt)
    return packed


def _prefill_inject_impl(model, storage, prompts, lengths, slots, seeds,
                         temp, top_k, adapter_ids=None) -> torch.Tensor:
    """Batched prompt fill on the slot pool: the prefill forward at
    ``(prefill_batch, prefill_len)``, each row's first token sampled,
    then each of the ``len(slots)`` valid rows' WHOLE KV row (zeros past
    the prompt) copied into its slot; padding rows are written nowhere.
    int8 storage is dequantized whole and re-quantized whole around the
    copy. Returns the first tokens (B_pf,)."""
    cache = dense_storage_values(storage, model.cfg.dtype)
    pf_cache, last = _prefill_impl(model, prompts, lengths, adapter_ids)
    first = sample_logits_rows(last, seeds, temp, top_k)
    n = len(slots)
    idx = torch.tensor(slots, dtype=torch.long, device=prompts.device)
    for pool, pf in zip(cache, pf_cache):
        pool.key.index_copy_(0, idx, pf.key[:n])
        pool.value.index_copy_(0, idx, pf.value[:n])
    dense_storage_commit(storage, cache)
    return first


class KVSlotPool:
    """Dense storage: the ``(num_slots, max_seq_len)`` K/V pool (one
    ``DenseKV`` per layer, or int8 codes with per-(slot, position, head)
    scales, :class:`~ray_lightning_tpu_torch.serve.pages.QuantizedDenseKV`)
    and the slot -> request map. Slots go lowest index first and the
    free list is re-sorted on release, so traces are deterministic; two
    co-resident slots never share a sampling seed."""

    def __init__(self, cfg, num_slots: int, kv_dtype: Optional[str] = None,
                 device: Optional[torch.device] = None):
        self.num_slots = num_slots
        self.kv_dtype = kv_dtype
        cache = new_cache(cfg, num_slots, device)
        if check_kv_dtype(kv_dtype):
            cache = quantize_dense_cache(cache)
        self.cache = cache
        self._free: List[int] = list(range(num_slots))
        self._requests: Dict[int, Request] = {}   # slot -> request

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active(self) -> Dict[int, Request]:
        return dict(self._requests)

    def slot_of(self, request_id: int) -> Optional[int]:
        for slot, req in self._requests.items():
            if req.id == request_id:
                return slot
        return None

    def acquire(self, request: Request) -> int:
        if not self._free:
            raise SlotPoolFull(f"all {self.num_slots} KV slots in use",
                               slots_free=0, active=len(self._requests))
        check_seed_free(self._requests, request)
        slot = self._free.pop(0)
        self._requests[slot] = request
        return slot

    def release(self, slot: int) -> Request:
        req = self._requests.pop(slot)
        self._free.append(slot)
        self._free.sort()
        return req


@dataclasses.dataclass
class _ChunkState:
    """One prompt mid-chunking: its slot is held, its pages allocated,
    and ``fed[next_off:]`` still has to stream through chunk
    dispatches."""
    request: Request
    slot: int
    fed: List[int]       # prompt + replayed tokens
    next_off: int        # first position not yet written (admission
    #                      sets it past any adopted prefix pages)


@dataclasses.dataclass
class PendingDispatch:
    """The deferred-sync handle of one enqueued step or spec dispatch.

    ``host`` is the dispatch's int32 output on the host -- a step
    dispatch's rows ``[0, rounds)`` emitted tokens (−1 = parked),
    ``[rounds, 2*rounds)`` finished flags, then cur, pos, active,
    remaining, stepno; a spec dispatch (``kind="spec"``) packs emitted
    (rounds, B, k+1), finished, accepted and rejected (rounds, B), then
    the row state, flat. On the card it is a pinned buffer that a
    non-blocking copy fills, with ``event`` recorded after that copy,
    which :meth:`ServeEngine.step_sync` waits on (``wait_s``: how long
    it waited); on the CPU the output itself.
    ``carry`` (cur (B, 1), pos (B, 1), active, remaining, stepno) stays
    on the device: the next enqueue chains on it. ``dispatch`` is the
    engine's 1-based dispatch index and ``owner`` the issuing engine's
    identity token: handles sync exactly once, in enqueue order, on the
    engine that issued them; a rebuilt-away engine's handle is
    discarded, never synced. ``asynchronous`` marks a
    :meth:`~ServeEngine.step_enqueue` handle, ``enqueued_at`` its
    ``time.perf_counter()`` at enqueue, and ``enqueued_tick`` the
    driving client's clock at enqueue (set by an armed client)."""
    kind: str                       # "step" | "spec"
    dispatch: int
    rounds: int
    carry: tuple
    owner: object
    host: torch.Tensor
    event: Optional[object] = None  # torch.cuda.Event on the card
    wait_s: float = 0.0
    asynchronous: bool = False
    enqueued_at: float = 0.0
    enqueued_tick: Optional[float] = None


class ServeEngine:
    """In-flight batching over a fixed slot batch with dense or paged KV.

    ``model`` is a port ``TransformerLM`` (its config is used;
    ``attention_kernel=`` overrides the config's read side) and
    ``params`` its state dict -- e.g. ``model.state_dict()`` after
    :func:`~ray_lightning_tpu_torch.interop.load_flax_params`. The
    engine builds its own copy of the model on ``device`` (``None`` =
    the card; no card raises) and never changes the caller's.

    ``page_size=None`` (the default) serves from the dense slot pool
    (:class:`KVSlotPool`); ``page_size=P`` from a page arena
    (``num_pages=`` pages, default ``num_slots * max_seq_len / P``),
    through the page table inside the attention with ``page_native=True``
    or through a gathered dense view with ``page_native=False``.
    ``attention_kernel="cuda"`` is the paged-attention kernel, the read
    side of ``page_native=True`` only (the JAX engine's rule for its
    Pallas kernel): the dense layouts attend through the plain dense
    attention. ``kv_dtype="int8"`` stores K/V as absmax int8 codes.

    ``weight_dtype="int8"|"int4"`` (``weight_group_size=`` sizes the int4
    groups, default 64) quantizes the engine's model;
    ``matmul_kernel="cuda"`` (needs ``weight_dtype=``) runs its quantized
    matmuls through the fused kernel, ``"torch"`` (the default) through
    the plain version; ``None`` keeps the model config's choice.

    ``prefill_chunk=C`` (a multiple of ``page_size`` dividing
    ``max_seq_len``) streams prompts longer than ``C`` or than
    ``prefill_len`` in chunk dispatches (:meth:`prefill_chunk_step`);
    ``prefix_cache=True`` (needs ``prefill_chunk``) routes every prompt
    through them and reuses the pages of cached prompt prefixes.

    ``draft_model=``/``draft_params=`` (a port ``TransformerLM`` sharing
    the target's vocab and ``max_seq_len``, and its state dict) make
    ``step()`` speculative with ``spec_k=`` draft tokens a round
    (default 4); ``draft_weight_dtype=`` quantizes the draft. Under
    ``attention_kernel="cuda"`` the verify's k+1 tokens a row must fit
    the kernel's ``MAX_T``. Unlike the JAX engine, neither model's
    config needs ``decode=True``.

    ``max_resident_adapters=N, lora_rank=r`` arm a LoRA adapter bank of N
    slots on every ``qkv``/``out``/``up``/``down`` projection
    (``adapters=`` a ``{name: adapter tree}`` to load at once;
    :meth:`load_adapter`, :meth:`unload_adapter` later);
    ``tenant_classes=`` a list of
    :class:`~ray_lightning_tpu_torch.serve.tenancy.TenantClass`.

    ``telemetry=`` a :class:`~ray_lightning_tpu_torch.obs.Telemetry`
    arms the engine's events, spans and metrics (module docstring).

    Drive it with :class:`~ray_lightning_tpu_torch.serve.client.ServeClient`
    or directly: ``prefill([reqs])`` starts requests, ``step()`` advances
    every in-flight one; each returns newly finished
    :class:`Completion`\\ s. ``step()`` is :meth:`step_enqueue` and
    :meth:`step_sync` back to back; ``ServeClient(async_dispatch=True)``
    splits them across ticks.
    """

    def __init__(self, model, params, *, num_slots: int = 8,
                 prefill_batch: Optional[int] = None,
                 prefill_len: int = 64, steps_per_dispatch: int = 1,
                 seed: int = 0, page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 page_native: bool = False,
                 attention_kernel: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 weight_group_size: Optional[int] = None,
                 matmul_kernel: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 draft_model=None, draft_params=None,
                 spec_k: Optional[int] = None,
                 draft_weight_dtype: Optional[str] = None,
                 tenant_classes=None, adapters=None,
                 max_resident_adapters: Optional[int] = None,
                 lora_rank: Optional[int] = None,
                 telemetry=None, device=None, **unported):
        refuse_unported(unported, UNPORTED)
        if page_native and page_size is None:
            raise ValueError(
                "page_native=True is a paged-KV mode (attention reads K/V "
                "through the page table): pass page_size= too")
        if page_size is None and (num_pages is not None
                                  or prefill_chunk is not None
                                  or prefix_cache):
            raise ValueError(
                "num_pages / prefill_chunk / prefix_cache are paged-KV "
                "features: pass page_size= to enable the page arena")
        self.device = resolve_device(device)
        cfg = model.cfg
        if attention_kernel is not None:
            if attention_kernel not in ATTENTION_KERNELS:
                raise ValueError(
                    f"attention_kernel must be None or one of "
                    f"{ATTENTION_KERNELS}, got {attention_kernel!r}")
            cfg = dataclasses.replace(cfg, attention_kernel=attention_kernel)
        self.attention_kernel = cfg.attention_kernel
        if self.attention_kernel == "cuda" and not page_native:
            raise ValueError(
                "attention_kernel='cuda' is the page-native paged-attention "
                "kernel (K/V read through the page table inside one "
                "launch): pass page_native=True (and page_size=) too")
        check_weight_dtype(weight_dtype)  # unknown dtypes refused here
        check_weight_dtype(draft_weight_dtype)
        if matmul_kernel is not None:
            if matmul_kernel not in MATMUL_KERNELS:
                raise ValueError(
                    f"matmul_kernel must be None or one of "
                    f"{MATMUL_KERNELS}, got {matmul_kernel!r}")
            cfg = dataclasses.replace(cfg, matmul_kernel=matmul_kernel)
        self.matmul_kernel = cfg.matmul_kernel
        if self.matmul_kernel == "cuda" and weight_dtype is None \
                and draft_weight_dtype is None:
            raise ValueError(
                "matmul_kernel='cuda' is the fused dequant-matmul kernel for "
                "QUANTIZED weights: pass weight_dtype='int8'|'int4' (or "
                "draft_weight_dtype=) too, or drop the kernel")
        if weight_group_size is not None \
                and "int4" not in (weight_dtype, draft_weight_dtype):
            raise ValueError(
                "weight_group_size is an int4 grouping option: pass "
                "weight_dtype='int4' (or draft_weight_dtype='int4') to "
                "enable it -- int8 scales are per-output-channel")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if prefill_len > cfg.max_seq_len:
            raise ValueError(
                f"prefill_len ({prefill_len}) exceeds max_seq_len "
                f"({cfg.max_seq_len})")
        if steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}")
            if prefill_chunk % page_size != 0:
                raise ValueError(
                    f"prefill_chunk ({prefill_chunk}) must be a multiple "
                    f"of page_size ({page_size})")
            if cfg.max_seq_len % prefill_chunk != 0:
                raise ValueError(
                    f"prefill_chunk ({prefill_chunk}) must divide "
                    f"max_seq_len ({cfg.max_seq_len}) so chunk offsets "
                    "can never overflow the sequence axis")
        if prefix_cache and prefill_chunk is None:
            raise ValueError(
                "prefix_cache=True needs prefill_chunk= too: an adopted "
                "prefix resumes prefill at its first un-cached offset, "
                "which is a chunk dispatch")
        if (spec_k is not None or draft_params is not None) \
                and draft_model is None:
            raise ValueError(
                "spec_k / draft_params are speculative-decoding options: "
                "pass draft_model= (a small LM sharing the target's vocab "
                "and max_seq_len) to enable them")
        if draft_model is not None and draft_params is None:
            raise ValueError("draft_model needs draft_params too")
        if draft_weight_dtype is not None and draft_model is None:
            raise ValueError(
                "draft_weight_dtype is a speculative-decoding option: "
                "pass draft_model=/draft_params= to enable it")
        if draft_model is not None and self.attention_kernel == "cuda" \
                and spec_k is not None and spec_k + 1 > _pa.MAX_T:
            raise ValueError(
                f"spec_k={spec_k} verifies {spec_k + 1} tokens a row, but "
                f"the paged-attention kernel (attention_kernel='cuda') "
                f"takes at most T = {_pa.MAX_T}: pass spec_k <= "
                f"{_pa.MAX_T - 1}")
        if prefill_batch is not None and prefill_batch < 1:
            raise ValueError(
                f"prefill_batch must be >= 1, got {prefill_batch}")
        self.prefill_batch = min(prefill_batch or num_slots, num_slots)
        if prefill_batch is not None and self.prefill_batch != prefill_batch:
            warnings.warn(
                f"prefill_batch={prefill_batch} clamped to "
                f"{self.prefill_batch} (valid range 1..num_slots="
                f"{num_slots})", stacklevel=2)
            if telemetry is not None:
                telemetry.event("engine.config_clamped",
                                field="prefill_batch",
                                requested=prefill_batch,
                                effective=self.prefill_batch)
        check_kv_dtype(kv_dtype)
        # tenancy: the engine keeps the class map so validate() refuses
        # unknown tenants and prefill() enforces max_active_slots for
        # direct callers; the scheduling policy is the client's
        self.tenant_classes = (resolve_tenant_classes(tenant_classes)
                               if tenant_classes else None)
        self.max_resident_adapters = max_resident_adapters
        self.lora_rank = lora_rank
        if max_resident_adapters is None:
            if adapters:
                raise ValueError(
                    "adapters= needs max_resident_adapters= too: the "
                    "bank's num_adapters axis is sized up front")
            if lora_rank is not None:
                raise ValueError(
                    "lora_rank is a multi-LoRA serving option: pass "
                    "max_resident_adapters= to arm the adapter bank")
        else:
            if max_resident_adapters < 1:
                raise ValueError(
                    f"max_resident_adapters must be >= 1, got "
                    f"{max_resident_adapters}")
            if lora_rank is None or lora_rank < 1:
                raise ValueError(
                    "multi-LoRA serving needs lora_rank >= 1 (the bank's "
                    f"low-rank dimension), got {lora_rank!r}")
            if adapters and len(adapters) > max_resident_adapters:
                raise ValueError(
                    f"{len(adapters)} initial adapters exceed "
                    f"max_resident_adapters={max_resident_adapters}")
            # the bank is grafted below, after quantization: a bank in
            # the caller's weights is replaced by a zero one
            cfg = dataclasses.replace(cfg, lora=None)
            params = {k: v for k, v in params.items()
                      if not k.rsplit(".", 1)[-1].startswith("lora_")}
        # the engine's own model: built without initializing (meta), then
        # filled from params on the target device
        self.model = TransformerLM(cfg, device="meta").to_empty(
            device=self.device)
        self.model.load_state_dict(params)
        self.model.requires_grad_(False).eval()
        self.weight_dtype = weight_dtype
        # the weights_quantized events' payloads, emitted at the end of
        # __init__ (the JAX engine's order)
        quantized_events: List[dict] = []
        if weight_dtype is not None:
            group = weight_group_size if weight_dtype == "int4" else None
            before = param_bytes(self.model.named_weights())
            self.model.quantize_weights(weight_dtype, group)
            quantized_events.append(_quantized_event(
                "target", weight_dtype, group, before,
                param_bytes(self.model.named_weights())))
        # the adapter bank rides beside the (possibly quantized) base
        # weights at full precision, and its delta outside the base
        # matmuls: a null row is the unadapted engine's
        self._registry: Optional[AdapterRegistry] = None
        self._adapter_ids: Optional[np.ndarray] = None
        self._adapter_of: Dict[int, str] = {}
        adapter_events: List[dict] = []
        if max_resident_adapters is not None:
            install_lora_bank(self.model, LoraConfig(
                rank=lora_rank, num_adapters=max_resident_adapters))
            self.model.requires_grad_(False)
            self._registry = AdapterRegistry(
                max_resident_adapters,
                bytes_per_adapter=adapter_bytes(self.model))
            self._adapter_ids = np.full((num_slots,), -1, np.int32)
            for name, tree in dict(adapters or {}).items():
                index, _ = self._registry.admit(name)
                install_adapter(self.model, tree, index)
                adapter_events.append(
                    dict(adapter=name, index=index, evicted=None))
        # speculative decoding: the draft runs the target's matmul kernel
        self.spec_k: Optional[int] = None
        self.spec: Optional[SpecDecoder] = None
        if draft_model is not None:
            self.spec_k = 4 if spec_k is None else spec_k
            self.spec = SpecDecoder(
                TransformerLM(dataclasses.replace(
                    draft_model.cfg, matmul_kernel=cfg.matmul_kernel),
                    device="meta"),
                draft_params, num_slots=num_slots, k=self.spec_k,
                target_cfg=cfg, device=self.device,
                weight_dtype=draft_weight_dtype,
                weight_group_size=(weight_group_size
                                   if draft_weight_dtype == "int4"
                                   else None))
            if draft_weight_dtype is not None:
                quantized_events.append(_quantized_event(
                    "draft", draft_weight_dtype,
                    weight_group_size if draft_weight_dtype == "int4"
                    else None, *self.spec.quantized_bytes))
        self.num_slots = num_slots
        self.prefill_len = prefill_len
        self.steps_per_dispatch = steps_per_dispatch
        self.seed = seed
        self.kv_dtype = kv_dtype
        self.paged = page_size is not None
        self.page_native = page_native
        if self.paged:
            self.pool = PagePool(cfg, num_slots, page_size,
                                 num_pages=num_pages, kv_dtype=kv_dtype,
                                 device=self.device)
        else:
            self.pool = KVSlotPool(cfg, num_slots, kv_dtype=kv_dtype,
                                   device=self.device)
        self.prefill_chunk = prefill_chunk
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        self._chunk_queue: Deque[_ChunkState] = deque()
        # the request whose FINAL chunk the last prefill_chunk_step
        # activated into decode (None otherwise): the client stamps its
        # TTFT
        self.chunk_activated: Optional[Request] = None
        # the logits at valid_len - 1 of the last chunk dispatch, (1,
        # vocab): a final chunk's first token is sampled from them
        self.chunk_logits: Optional[torch.Tensor] = None

        B = num_slots
        self._cur = np.zeros((B, 1), np.int32)
        self._pos = np.zeros((B, 1), np.int32)
        self._active = np.zeros((B,), bool)
        self._remaining = np.zeros((B,), np.int32)
        self._temp = np.zeros((B,), np.float32)
        self._top_k = np.zeros((B,), np.int32)
        self._eos = np.full((B,), -1, np.int32)
        self._seeds = np.zeros((B,), np.int64)      # request seeds
        self._stepno = np.zeros((B,), np.int32)
        self._tokens: Dict[int, List[int]] = {}
        # the async seat: the numpy fields above hold the SYNCED frontier
        # (the newest dispatch whose tokens the host has seen); while a
        # dispatch is enqueued but not synced, its device row state lives
        # here and the next enqueue chains on it (None = synced, barriers
        # allowed)
        self._carry: Optional[tuple] = None
        # the highest dispatch step_sync has committed (the in-order
        # guard) and this engine's identity, stamped into its handles
        self._synced_dispatch = 0
        self._engine_token = object()
        # host inputs cached on the device: name -> (host copy, tensor),
        # re-uploaded (pinned, non-blocking) only when the host copy
        # changes
        self._staged: Dict[str, Tuple[np.ndarray, torch.Tensor]] = {}
        # the sync step()'s retry seat: a handle whose host copy failed
        # after its dispatch launched (step_sync left the engine
        # untouched, so the next step() syncs the SAME dispatch instead
        # of wedging behind _require_synced with the handle lost)
        self._retry_sync: Optional[PendingDispatch] = None

        # counters: steps counts dispatches, decode_substeps decode
        # token-steps (steps x steps_per_dispatch)
        self.steps = 0
        self.decode_substeps = 0
        self.prefills = 0
        self.chunk_dispatches = 0
        self.tokens_generated = 0
        # speculative decoding (all zero without a draft): decode_substeps
        # then counts rounds -- one verify is one target pass however
        # many tokens it commits
        self.spec_rounds = 0
        self.spec_accepted_tokens = 0
        self.spec_rejected_tokens = 0
        self.spec_draft_steps = 0

        # off by default: one attribute read + None check a dispatch
        self._tel = telemetry
        # extra args splatted into every engine span (a fleet stamps its
        # replica's seat here); empty for a standalone engine
        self._span_extra: Dict[str, object] = {}
        if telemetry is not None:
            for payload in quantized_events:
                telemetry.event("engine.weights_quantized", **payload)
            telemetry.metrics.gauge(
                "serve_param_bytes",
                help="at-rest parameter bytes this engine streams per "
                "decode pass (target + draft; quantized codes + scales "
                "when weight_dtype is set)").set(self.param_bytes())
            if self._registry is not None:
                for payload in adapter_events:
                    telemetry.event("engine.adapter_loaded", **payload)
                self._set_adapter_gauge()

    # ------------------------------------------------------- multi-LoRA
    @property
    def resident_adapters(self) -> List[str]:
        """Resident adapter names, least-recently-bound first (the
        eviction order); empty without a bank."""
        return (self._registry.residents
                if self._registry is not None else [])

    def adapter_bank_bytes(self) -> int:
        """At-rest device bytes of the whole adapter bank: capacity times
        one slot's bytes
        (:func:`~ray_lightning_tpu_torch.models.lora.adapter_bytes`)."""
        if self._registry is None:
            return 0
        return self._registry.capacity * self._registry.bytes_per_adapter

    def adapter_refcount(self, name: str) -> int:
        """In-flight rows bound to ``name`` (0 without a bank or when not
        resident)."""
        return (self._registry.refcount(name)
                if self._registry is not None else 0)

    def _set_adapter_gauge(self) -> None:
        self._tel.metrics.gauge(
            "serve_adapter_resident",
            help="LoRA adapters currently resident in the engine's "
            "adapter bank").set(len(self._registry.residents))

    def _need_bank(self) -> None:
        if self._registry is None:
            raise ValueError(
                "this engine has no adapter bank -- pass "
                "max_resident_adapters=/lora_rank= to arm multi-LoRA "
                "serving")

    def load_adapter(self, name: str, adapter) -> Optional[str]:
        """Hot-load (or overwrite) adapter ``name``: claim a bank slot
        (its own, else a free one, else the least-recently-bound unpinned
        resident's), write the adapter tree into it. Returns the evicted
        adapter's name, whose later submits shed with
        :class:`~ray_lightning_tpu_torch.serve.adapters.UnknownAdapter`,
        or None. A barrier: needs the synced frontier."""
        self._need_bank()
        self._require_synced("load_adapter")
        index, evicted = self._registry.admit(name)
        install_adapter(self.model, adapter, index)
        tel = self._tel
        if tel is not None:
            if evicted is not None:
                tel.event("engine.adapter_evicted", adapter=evicted,
                          index=index, by=name)
            tel.event("engine.adapter_loaded", adapter=name,
                      index=index, evicted=evicted)
            self._set_adapter_gauge()
        return evicted

    def unload_adapter(self, name: str) -> None:
        """Release ``name``'s bank slot (refused while in-flight rows are
        bound to it) and zero it. A barrier, like :meth:`load_adapter`."""
        self._need_bank()
        self._require_synced("unload_adapter")
        index = self._registry.unload(name)
        zero_adapter(self.model, index)
        tel = self._tel
        if tel is not None:
            tel.event("engine.adapter_unloaded", adapter=name, index=index)
            self._set_adapter_gauge()

    def _effective_adapter(self, request: Request) -> Optional[str]:
        """The adapter a request decodes under: its own, else its tenant
        class's default, else None (the base model)."""
        name = request.adapter
        if name is None and self.tenant_classes is not None:
            cls = self.tenant_classes.get(request.tenant)
            if cls is not None:
                name = cls.adapter
        return name

    def _bind_adapter(self, req: Request, slot: int) -> int:
        """Pin the request's adapter at admission (inside the atomic
        admission; a rollback unbinds): bumps its refcount so eviction
        never takes the slot from an in-flight row, arms the row's bank
        id and stamps the resolved name on the request. Returns the bank
        index (−1 = the base model)."""
        name = self._effective_adapter(req)
        if name is None or self._registry is None:
            return -1
        index = self._registry.bind(name)   # UnknownAdapter if evicted
        self._adapter_ids[slot] = index
        self._adapter_of[slot] = name
        req.adapter = name
        tel = self._tel
        if tel is not None:
            tel.event("engine.adapter_bound", id=req.id, adapter=name,
                      slot=slot, index=index)
            tel.metrics.counter(
                f"serve_adapter_requests_total_{name}",
                help="requests admitted under this LoRA adapter").inc()
        return index

    def _unbind_adapter(self, slot: int) -> None:
        """Drop a slot's adapter pin (retire, cancel, rollback)."""
        if self._registry is None:
            return
        name = self._adapter_of.pop(slot, None)
        if name is not None:
            self._registry.unbind(name)
        self._adapter_ids[slot] = -1

    def _adapter_arg(self, ids: Optional[np.ndarray], name: str,
                     slot: Optional[int] = None):
        """The rows' bank ids (``ids``, or only ``slot``'s) on the device,
        cached under ``name``; None without a bank: the model is then
        called as before LoRA."""
        if self._registry is None:
            return None
        if slot is not None:
            ids = ids[slot:slot + 1]
        return self._on_device(name, ids)

    # ------------------------------------------------------------- state
    def param_bytes(self) -> int:
        """At-rest bytes of the engine's models (target and draft): f32
        parameters, or codes plus scales for quantized matrices."""
        draft = self.spec.param_bytes() if self.spec is not None else 0
        return param_bytes(self.model.named_weights()) + draft

    @property
    def free_slots(self) -> int:
        return self.pool.free_slots

    @property
    def free_pages(self) -> Optional[int]:
        """Free arena pages; None on a dense engine."""
        return self.pool.free_pages if self.paged else None

    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    @property
    def active_requests(self) -> Dict[int, Request]:
        return self.pool.active

    @property
    def chunk_pending(self) -> int:
        """Prompts admitted but still streaming through chunk prefill."""
        return len(self._chunk_queue)

    @property
    def chunk_pending_ids(self) -> FrozenSet[int]:
        return frozenset(st.request.id for st in self._chunk_queue)

    @property
    def carry_deferred(self) -> bool:
        """True while an enqueued dispatch's carry has not been synced
        back to the host (an outstanding :class:`PendingDispatch`)."""
        return self._carry is not None

    @property
    def retry_pending(self) -> bool:
        """True while a failed sync step's handle waits in the retry
        seat -- the next :meth:`step` drains it before dispatching anew
        (the sync client's tick does this ahead of any barrier, so a
        transient host-copy error cannot wedge deadline cancels or
        admissions)."""
        return self._retry_sync is not None

    @property
    def max_replay_len(self) -> int:
        """Longest prompt + already-emitted-tokens sequence a crash
        recovery can re-feed: one batched prefill pass without chunking
        (``prefill_len``), the whole sequence axis with it (chunked
        replay streams any admissible request back in)."""
        if self.prefill_chunk is not None:
            return self.model.cfg.max_seq_len
        return self.prefill_len

    @property
    def spec_needs_refill(self) -> bool:
        """True when the next spec dispatch rebuilds draft rows from the
        host's token streams (stale slots): the async client drains its
        pipeline first, so the refill reads the synced streams."""
        return self.spec is not None and bool(self.spec.stale)

    @property
    def spec_sampled(self) -> bool:
        """True when a spec dispatch would sample a row: its round seeds
        come from the rows' step numbers, which a spec round advances by
        a data-dependent count, so the dispatch reads them back and the
        async client drains its pipeline first."""
        return self.spec is not None and bool(
            (self._temp[self._active] > 0).any())

    def _require_synced(self, op: str) -> None:
        """Barrier dispatches (admission, chunk, cancel, adapter loads)
        change the host row state in place: they need the synced
        frontier, or the next enqueue would chain on a stale carry."""
        if self._carry is not None:
            raise RuntimeError(
                f"{op} needs the synced frontier but an enqueued dispatch "
                "is still pending -- step_sync() the outstanding "
                "PendingDispatch first (ServeClient(async_dispatch=True) "
                "drains its pipeline before admission/chunk/cancel)")

    def validate(self, request: Request) -> None:
        """Admission check: the request must fit the engine's shapes,
        name a declared tenant class (tenancy configured) and, if it
        names an adapter, a resident one."""
        tenant = request.tenant
        if self.tenant_classes is not None:
            if tenant not in self.tenant_classes:
                raise ValueError(
                    f"unknown tenant {tenant!r}: this engine's declared "
                    f"classes are {list(self.tenant_classes)}")
        elif tenant != DEFAULT_TENANT:
            raise ValueError(
                f"request names tenant {tenant!r} but the engine has no "
                "tenant classes configured -- pass tenant_classes= to "
                "arm multi-tenant scheduling")
        # an unknown or evicted adapter sheds here, with the registry's
        # context, never at a dispatch
        adapter = self._effective_adapter(request)
        if adapter is not None:
            if self._registry is None:
                raise UnknownAdapter(
                    f"request names adapter {adapter!r} but the engine "
                    "has no adapter bank -- pass max_resident_adapters=/"
                    "lora_rank= to arm multi-LoRA serving",
                    adapter=adapter, resident=[], capacity=0)
            self._registry.index_of(adapter)
        cfg = self.model.cfg
        if self.prefill_chunk is None \
                and request.prompt_len > self.prefill_len:
            raise ValueError(
                f"prompt length {request.prompt_len} exceeds the engine's "
                f"prefill_len ({self.prefill_len})")
        if request.prompt_len + request.max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({request.prompt_len}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_seq_len "
                f"({cfg.max_seq_len})")
        if self.spec is not None and (request.prompt_len
                                      + request.max_new_tokens
                                      + self.spec_k - 1) > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({request.prompt_len}) + max_new_tokens "
                f"({request.max_new_tokens}) needs spec_k-1 = "
                f"{self.spec_k - 1} positions of verify headroom beyond "
                f"it (the verify writes k draft positions past the last "
                f"budgeted token) -- max_seq_len ({cfg.max_seq_len}) is "
                "too small")
        if not self.paged:
            return
        need = self.pool.pages_needed(request)
        if need > self.pool.num_pages:
            raise ValueError(
                f"request needs {need} KV pages (prompt "
                f"{request.prompt_len} + max_new_tokens "
                f"{request.max_new_tokens} at page_size "
                f"{self.pool.page_size}) but the arena only has "
                f"{self.pool.num_pages} -- it can never be admitted")

    # ------------------------------------------------------- admission
    def _check_slot_quota(self, request: Request) -> None:
        """Per-class ``max_active_slots`` at admission (tenancy
        configured): the scheduler never picks past it, so this is the
        guard for direct callers; it raises inside the atomic admission,
        so the batch rolls back."""
        if self.tenant_classes is None:
            return
        cls = self.tenant_classes[request.tenant]
        if cls.max_active_slots is None:
            return
        held = sum(1 for r in self.pool.active.values()
                   if r.tenant == request.tenant)
        if held >= cls.max_active_slots:
            raise SlotPoolFull(
                f"tenant {request.tenant!r} at max_active_slots="
                f"{cls.max_active_slots}", tenant=request.tenant,
                slots_free=self.free_slots, active=len(self.pool.active))

    def _routes_chunked(self, request: Request) -> bool:
        """Chunk routing: every prompt when the prefix cache is on (the
        pages it publishes must all come from chunk dispatches), else
        prompts longer than a chunk (a bounded decode stall) or than the
        batched prefill takes at all."""
        if self.prefill_chunk is None:
            return False
        if self.prefix is not None:
            return True
        fed = request.prompt_len + len(request.replay_tokens or ())
        return fed > self.prefill_chunk or fed > self.prefill_len

    def _chunk_floor(self, pages: int) -> int:
        """A page count rounded down to whole chunks: the one place the
        chunk-alignment cap lives, shared by adoption and the hit-rate
        denominator."""
        per_chunk = self.prefill_chunk // self.pool.page_size
        return (pages // per_chunk) * per_chunk

    def _adoptable_prefix(self, fed: List[int]) -> List[int]:
        """Cached pages this admission may adopt: the matched chain
        capped to whole chunks, so the resumed prefill starts on a chunk
        boundary and no chunk writes into a shared page."""
        if self.prefix is None:
            return []
        matched = self.prefix.match(fed)
        return matched[:self._chunk_floor(len(matched))]

    def admissible_prefix(self, requests: List[Request]) -> int:
        """How many of the queue-head ``requests`` one prefill call can
        admit (FIFO -- a prefix, never a skip-ahead): free slots, the
        batched prefill's width (chunk-routed requests take none of it),
        and cumulative page demand against free plus cache-evictable
        pages. Prefix hits count as consuming their pages (adoption pins
        them), never as a discount."""
        limit = min(len(requests), self.free_slots)
        if not self.paged:
            return min(limit, self.prefill_batch)
        budget = self.pool.free_pages + (self.prefix.evictable()
                                         if self.prefix is not None else 0)
        n = batched = 0
        for req in requests[:limit]:
            chunked = self._routes_chunked(req)
            if not chunked and batched == self.prefill_batch:
                break
            need = self.pool.pages_needed(req)
            if need > budget:
                break
            budget -= need
            batched += not chunked
            n += 1
        return n

    def _admit_paged(self, request: Request, adopt: List[int]) -> int:
        """Acquire a slot and pages for one admission, evicting
        cache-only pages (never the chain being adopted) when the free
        list runs short."""
        fresh_need = self.pool.pages_needed(request) - len(adopt)
        short = fresh_need - self.pool.free_pages
        if short > 0 and self.prefix is not None:
            self.prefix.evict(short, protect=adopt)
        return self.pool.acquire(request, adopt)

    # ---------------------------------------------------------- programs
    def prefill(self, requests: List[Request]) -> List[Completion]:
        """Start ``requests``: slots (and pages) are acquired atomically
        for the whole batch. Prompts the batched prefill takes run one
        pass that samples every first token and copies every KV row into
        its slot or scatters it into its pages; chunk-routed prompts
        (longer than ``prefill_chunk``, or any prompt under a prefix
        cache) are queued for :meth:`prefill_chunk_step` instead, past
        any prefix pages they adopt. Returns completions of requests that
        finish on their first token (eos or a budget of one).

        A request carrying ``replay_tokens`` (crash recovery, see
        :class:`~ray_lightning_tpu_torch.reliability.ServeSupervisor`)
        feeds its prompt + those tokens: the pass rebuilds the KV the
        dead engine held and samples with the seed of step
        ``len(replay_tokens)``."""
        if not requests:
            return []
        self._require_synced("prefill")
        faults.fire("serve.dispatch")
        n_batched = sum(not self._routes_chunked(r) for r in requests)
        if n_batched > self.prefill_batch \
                or len(requests) > self.free_slots:
            raise SlotPoolFull(
                f"{len(requests)} requests ({n_batched} batched) > "
                f"min(free_slots={self.free_slots}, prefill_batch="
                f"{self.prefill_batch})",
                slots_free=self.free_slots, pages_free=self.free_pages,
                active=len(self.pool.active))
        B_pf, P = self.prefill_batch, self.prefill_len
        prompts = np.zeros((B_pf, P), np.int64)
        lengths = np.ones((B_pf,), np.int64)
        inject_pt = (np.full((B_pf, self.pool.pages_per_slot), -1, np.int32)
                     if self.paged else None)
        seeds = [0] * B_pf
        temp = np.zeros((B_pf,), np.float32)
        top_k = np.zeros((B_pf,), np.int32)
        # the rows' adapter bank ids (−1 = base model, padding rows too)
        adapter_row = np.full((B_pf,), -1, np.int32)
        acquired: List[int] = []
        batched: List[Request] = []
        slots: List[int] = []
        adoptions = []
        n_chunked = 0
        try:
            for req in requests:
                self.validate(req)
                self._check_slot_quota(req)
                replay = list(req.replay_tokens or ())
                fed = list(req.prompt) + replay
                if self._routes_chunked(req):
                    adopt = self._adoptable_prefix(fed)
                    slot = self._admit_paged(req, adopt)
                    acquired.append(slot)
                    self._bind_adapter(req, slot)
                    hit = len(adopt) * self.pool.page_size
                    req.prefix_hit_tokens = hit
                    self._chunk_queue.append(_ChunkState(
                        request=req, slot=slot, fed=fed, next_off=hit))
                    n_chunked += 1
                    if self.prefix is not None:
                        # eligible: what a fully warm cache could have
                        # served under the same chunk-alignment cap
                        eligible = self._chunk_floor(
                            (len(fed) - 1) // self.pool.page_size)
                        adoptions.append((eligible, len(adopt), req))
                    continue
                L = len(fed)
                if L > self.prefill_len:
                    raise ValueError(
                        f"request {req.id}: prompt ({req.prompt_len}) + "
                        f"replayed tokens ({len(replay)}) exceed "
                        f"prefill_len ({self.prefill_len}) -- not "
                        "resumable in one prefill pass")
                slot = (self._admit_paged(req, []) if self.paged
                        else self.pool.acquire(req))
                acquired.append(slot)
                r = len(batched)
                adapter_row[r] = self._bind_adapter(req, slot)
                batched.append(req)
                slots.append(slot)
                prompts[r, :L] = fed
                lengths[r] = L
                if self.paged:
                    inject_pt[r] = self.pool.page_table[slot]
                seeds[r] = row_seed(self.seed, req.seed, len(replay))
                temp[r] = req.temperature
                top_k[r] = req.top_k or 0
        except Exception:
            # atomic admission: a mid-batch reject (seed collision, bad
            # shape, page shortage) must not leak the slots, pages or
            # chunk seats already taken. Prefix entries evicted to seat
            # earlier members stay evicted: a retry loses some cache
            # warmth, never tokens
            for slot in acquired:
                self.pool.release(slot)
                self._unbind_adapter(slot)
            for _ in range(n_chunked):
                self._chunk_queue.pop()
            raise
        # poison fires AFTER the batch is seated (the dispatch fire above
        # precedes slot acquisition): a poison crash leaves its request
        # in flight, where snapshot_in_flight() sees it
        faults.poison_check(requests)
        # statistics only once the whole batch's admission held
        tel = self._tel
        for eligible, adopted, req in adoptions:
            self.prefix.record_admission(eligible, adopted)
            if tel is not None and adopted:
                tel.event("engine.prefix_hit", id=req.id, pages=adopted,
                          tokens=adopted * self.pool.page_size)
                tel.metrics.counter(
                    "serve_prefix_pages_reused_total",
                    help="KV pages adopted from the prefix cache"
                ).inc(adopted)
        if not batched:
            return []
        dev = self.device
        prompts_t = torch.from_numpy(prompts).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        adapter_arg = self._adapter_arg(adapter_row, "prefill_adapters")
        with (tel.span("engine.prefill", n=len(batched), **self._span_extra)
              if tel is not None else NULL_SPAN), torch.inference_mode():
            if self.paged:
                cache, last = _prefill_impl(self.model, prompts_t, lengths_t,
                                            adapter_arg)
                first = sample_logits_rows(last, seeds, temp, top_k)
                # padding rows' table is all −1: their pages go to the sink
                scatter_pages(self.pool.arena, cache,
                              torch.from_numpy(inject_pt).to(dev))
            else:
                first = _prefill_inject_impl(
                    self.model, self.pool.cache, prompts_t, lengths_t,
                    slots, seeds, temp, top_k, adapter_arg)
            first = first.cpu().numpy()
        if tel is not None:
            tel.event("engine.prefill", n=len(batched),
                      ids=[r.id for r in batched], slots=list(slots))
        done: List[Completion] = []
        for r, req in enumerate(batched):
            comp = self._activate(req, slots[r], int(first[r]))
            if comp is not None:
                done.append(comp)
        self.prefills += 1
        return done

    def prefill_chunk_step(self) -> List[Completion]:
        """One chunk dispatch for the head of the chunk queue: the next
        ``prefill_chunk`` tokens of prompt + replayed tokens at the
        request's offset. On the final chunk the sampled token (the same
        ``row_seed(engine seed, request seed, len(replay_tokens))`` draw
        as the batched prefill's) activates the decode row, or retires
        the request (eos or an exhausted budget); with a prefix cache the
        prompt's full pages are published first."""
        self.chunk_activated = None
        if not self._chunk_queue:
            return []
        self._require_synced("prefill_chunk_step")
        faults.fire("serve.dispatch")
        st = self._chunk_queue[0]
        faults.poison_check((st.request,))
        req = st.request
        C = self.prefill_chunk
        L = len(st.fed)
        off = st.next_off
        valid = min(C, L - off)
        final = off + valid >= L
        tokens = np.zeros((1, C), np.int64)
        tokens[0, :valid] = st.fed[off:off + valid]
        startno = len(req.replay_tokens or ())
        dev = self.device
        tel = self._tel
        with (tel.span("engine.chunk", id=req.id, off=off, n=valid,
                       slot=st.slot, **self._span_extra)
              if tel is not None else NULL_SPAN), torch.inference_mode():
            last = _chunk_prefill_impl(
                self.model, self.pool.arena,
                torch.from_numpy(self.pool.page_table[st.slot]).to(dev),
                torch.from_numpy(tokens).to(dev), off, valid,
                self._adapter_arg(self._adapter_ids, "chunk_adapters",
                                  st.slot))
            self.chunk_logits = last
            first = None
            if final:
                first = int(sample_logits_rows(
                    last, [row_seed(self.seed, req.seed, startno)],
                    [req.temperature], [req.top_k or 0])[0])
        st.next_off = off + valid
        self.chunk_dispatches += 1
        if tel is not None:
            tel.event("engine.chunk", id=req.id, off=off, n=valid,
                      final=final)
        if not final:
            return []
        self._chunk_queue.popleft()
        if self.prefix is not None:
            # publish before activation: eos-on-first retires the slot,
            # but the cache's own references keep the prefix pages warm
            self.prefix.publish(list(req.prompt), st.slot)
        comp = self._activate(req, st.slot, first)
        if comp is None:
            self.chunk_activated = req
            return []
        return [comp]

    def _activate(self, req: Request, slot: int,
                  tok: int) -> Optional[Completion]:
        """First-token bookkeeping shared by the batched prefill and the
        final chunk: record the token after any replayed ones, retire on
        eos or an exhausted budget, else arm the slot's row."""
        toks = list(req.replay_tokens or ())
        if self.spec is None or not toks:
            toks.append(tok)
            self.tokens_generated += 1
        # else: spec-engine replay -- the prefill's plain draw is NOT the
        # token the uninterrupted spec stream committed at this step
        # (that one came through the accept rule). Discard it and arm the
        # row one step earlier: the next spec round regenerates step
        # len(replay) through the same accept rule off the same seeds, so
        # sampled streams stay replay-exact (greedy commits the target
        # argmax either way)
        self._tokens[slot] = toks
        hit_eos = req.eos_id is not None and toks[-1] == req.eos_id
        if hit_eos or len(toks) >= req.max_new_tokens:
            return self._retire(slot, FINISH_EOS if hit_eos
                                else FINISH_LENGTH)
        self._cur[slot, 0] = toks[-1]
        self._pos[slot, 0] = req.prompt_len + len(toks) - 1
        self._active[slot] = True
        self._remaining[slot] = req.max_new_tokens - len(toks)
        self._temp[slot] = req.temperature
        self._top_k[slot] = req.top_k or 0
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._seeds[slot] = req.seed
        self._stepno[slot] = len(toks)
        if self.spec is not None:
            # whatever armed the row (a prefill, a final chunk, a crash
            # replay), the draft rebuilds its KV from the whole context
            # before the next round
            self.spec.mark_stale(slot)
        return None

    def step(self) -> List[Completion]:
        """Advance every in-flight request up to ``steps_per_dispatch``
        tokens in one dispatch; returns the completions of rows that
        finished inside it (rows finishing at sub-step k park for the
        rest). :meth:`step_enqueue` and :meth:`step_sync` back to back;
        refused while a handle is outstanding (a sync step past an
        un-synced enqueue would drop that dispatch's tokens). A failed
        host copy is retryable: the failed sync leaves the engine
        untouched and the handle parks in a retry seat, so the next
        ``step()`` syncs the SAME dispatch before launching anew."""
        if self._retry_sync is not None:
            # a prior step()'s sync failed after its dispatch launched:
            # drain it first (the carry is deliberately still deferred)
            pending, self._retry_sync = self._retry_sync, None
        else:
            self._require_synced("step")
            pending = self._enqueue(asynchronous=False)
            if pending is None:
                return []
        try:
            return self.step_sync(pending)
        except Exception:
            self._retry_sync = pending
            raise

    def step_enqueue(self) -> Optional[PendingDispatch]:
        """Enqueue one step or spec dispatch against the device carry and
        return without waiting for its outputs: the handle is reconciled
        by :meth:`step_sync` while the next dispatch computes. Rows that
        retire inside an un-synced dispatch are parked by the latches
        the next dispatch already carries (they emit −1), so chained
        enqueues commit the sync driver's tokens. None when nothing is in
        flight at the synced frontier and no carry is deferred."""
        return self._enqueue(asynchronous=True)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device: on the card through pinned
        staging with a non-blocking copy (the stream orders it before
        the dispatch that reads it; the pinned block is not reused until
        the copy is done), on the CPU a copy."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _on_device(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the device, cached under ``name``: uploaded again
        only when the host copy changed since the last upload (eos ids,
        page tables and adapter ids change at admissions and
        retirements, not every dispatch)."""
        hit = self._staged.get(name)
        if hit is not None and np.array_equal(hit[0], arr):
            return hit[1]
        t = self._upload(arr)
        self._staged[name] = (np.array(arr), t)
        return t

    def _write_masked_table(self) -> np.ndarray:
        """The page table with inactive rows' entries masked to −1: their
        parked writes go to the sink, their reads clamp harmlessly. The
        mask is the SYNCED frontier's: a row that retired inside a
        still-pending dispatch keeps its entries one dispatch more and
        re-writes its own frozen K/V there; its pages are freed at its
        sync and reused only behind the admission barrier."""
        return np.where(self._active[:, None], self.pool.page_table,
                        -1).astype(np.int32)

    def _row_state(self):
        """The row state the next dispatch consumes: the newest
        outstanding dispatch's device carry, else the synced host
        frontier in one upload -- cur and pos (B, 1), active, remaining,
        stepno (B,) -- plus eos (B,), cached on the device."""
        if self._carry is not None:
            carry = self._carry
        else:
            state = self._upload(np.stack([
                self._cur[:, 0], self._pos[:, 0],
                self._active.astype(np.int32), self._remaining,
                self._stepno]))
            carry = (state[0][:, None], state[1][:, None], state[2].bool(),
                     state[3], state[4])
        return carry + (self._on_device("eos", self._eos),)

    def _outstanding(self) -> int:
        """Enqueued dispatches the host has not synced yet."""
        return self.steps - self._synced_dispatch

    def _handle(self, kind: str, rounds: int, packed: torch.Tensor,
                carry: tuple, asynchronous: bool) -> PendingDispatch:
        """Count the dispatch, start its outputs' copy to the host (on the
        card: non-blocking into pinned memory, an event after it) and
        make its handle; its carry becomes the one the next enqueue
        chains on."""
        host, event = packed, None
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        self._carry = carry
        self.steps += 1
        if self._tel is not None and asynchronous:
            self._tel.event("engine.dispatch_enqueued", dispatch=self.steps,
                            kind=kind)
        return PendingDispatch(kind=kind, dispatch=self.steps, rounds=rounds,
                               carry=carry, owner=self._engine_token,
                               host=host, event=event,
                               asynchronous=asynchronous,
                               enqueued_at=time.perf_counter())

    def _enqueue(self, *, asynchronous: bool) -> Optional[PendingDispatch]:
        if self._carry is None and not self._active.any():
            return None
        if self.spec is not None:
            return self._spec_enqueue(asynchronous)
        # fault sites fire before anything launches or the carry moves
        faults.fire("serve.dispatch")
        faults.poison_check(self.pool.active.values())
        tel = self._tel
        steps = self.steps_per_dispatch
        cur, pos, active, remaining, stepno, eos = self._row_state()
        # only rows in flight at the synced frontier sample; a row that
        # finished inside an outstanding dispatch or inside this one
        # keeps sampling into its masked-out emissions
        temp = np.where(self._active, self._temp, 0.0)
        # a row still in flight at sub-step s of this dispatch has
        # advanced one step for every sub-step of the dispatches the host
        # has not synced yet
        base = self._stepno + steps * self._outstanding()

        def seeds_at(s):
            return [row_seed(self.seed, int(self._seeds[r]), int(base[r]) + s)
                    if temp[r] > 0 else 0 for r in range(self.num_slots)]

        model = self.model
        row_state = (cur, pos, active, remaining, stepno, eos)
        adapter_ids = self._adapter_arg(self._adapter_ids, "adapters")
        with (tel.span("engine.step", active=int(self._active.sum()),
                       **self._span_extra)
              if tel is not None else NULL_SPAN), torch.inference_mode():
            if self.page_native:
                arena = self.pool.arena
                page_table = self._on_device("write_table",
                                             self._write_masked_table())
                packed = _decode_steps(
                    lambda cur, pos: decode_step_paged(
                        model, arena, cur, pos, page_table, adapter_ids),
                    model.cfg.max_seq_len, row_state, temp, self._top_k,
                    seeds_at, steps=steps)
            elif self.paged:
                packed = _paged_step_impl(
                    model, self.pool.arena,
                    self._on_device("table", self.pool.page_table),
                    row_state, temp, self._top_k, seeds_at, steps=steps,
                    adapter_ids=adapter_ids)
            else:
                packed = _engine_step_impl(
                    model, self.pool.cache, row_state, temp, self._top_k,
                    seeds_at, steps=steps, adapter_ids=adapter_ids)
        n = 2 * steps
        carry = (packed[n][:, None], packed[n + 1][:, None],
                 packed[n + 2].bool(), packed[n + 3], packed[n + 4])
        self.decode_substeps += steps
        return self._handle("step", steps, packed, carry, asynchronous)

    def _spec_enqueue(self, asynchronous: bool) -> PendingDispatch:
        """One speculative dispatch: refill stale draft rows from the
        host-side token streams (the synced ones: the async client drains
        before a dispatch with stale rows), then ``steps_per_dispatch``
        rounds (k+1 draft feeds, one ``(B, k+1)`` verify, the accept rule
        each): through the write-masked table (page-native), on the
        gathered view of the full table with write-masked scatter (dense
        view), or on the slot pool (dense). The rows' adapter ids reach
        the target's verify only. ``serve.dispatch`` fires first,
        ``serve.verify`` after the draft refills, both before the
        rounds launch."""
        faults.fire("serve.dispatch")
        faults.poison_check(self.pool.active.values())
        spec = self.spec
        for slot in spec.stale:
            req = self.pool.active.get(slot)
            if req is None or not self._active[slot]:
                spec.discard(slot)
                continue
            # the draft KV covers 0..pos-1: the whole context but the
            # current token, which the round's first feed supplies
            spec.refill(slot, list(req.prompt) + self._tokens[slot][:-1])
        faults.fire("serve.verify")
        tel = self._tel
        k, rounds = spec.k, self.steps_per_dispatch
        cur, pos, active, remaining, stepno, eos = self._row_state()
        temp = np.where(self._active, self._temp, 0.0)
        rows = (spec.cache, cur, pos, active, remaining, temp, self._top_k,
                eos, stepno, self.seed, self._seeds)
        adapter_ids = self._adapter_arg(self._adapter_ids, "adapters")
        with (tel.span("engine.spec_round", active=int(self._active.sum()),
                       k=k, **self._span_extra)
              if tel is not None else NULL_SPAN), torch.inference_mode():
            if self.page_native:
                out = _spec_rounds_page_native_impl(
                    self.model, spec.model, self.pool.arena,
                    self._on_device("write_table",
                                    self._write_masked_table()),
                    *rows, k=k, rounds=rounds, adapter_ids=adapter_ids)
            elif self.paged:
                out = _spec_rounds_paged_impl(
                    self.model, spec.model, self.pool.arena,
                    self._on_device("table", self.pool.page_table),
                    *rows, k=k, rounds=rounds, adapter_ids=adapter_ids)
            else:
                out = _spec_rounds_impl(self.model, spec.model,
                                        self.pool.cache, *rows, k=k,
                                        rounds=rounds,
                                        adapter_ids=adapter_ids)
            (cur, pos, active, remaining, stepno, emitted, accepted,
             rejected, finished) = out
            packed = torch.cat([
                x.to(torch.int32).reshape(-1)
                for x in (emitted, finished, accepted, rejected, cur, pos,
                          active, remaining, stepno)])
        self.decode_substeps += rounds
        self.spec_rounds += rounds
        self.spec_draft_steps += (k + 1) * rounds
        return self._handle("spec", rounds, packed,
                            (cur, pos, active, remaining, stepno),
                            asynchronous)

    def step_sync(self, pending: PendingDispatch) -> List[Completion]:
        """Materialize one enqueued dispatch: wait on its event (the
        blocking point; everything the caller did since the enqueue
        overlapped the card), catch the synced frontier up to its carry,
        and retire finished rows. Handles sync exactly once, in enqueue
        order, on the engine that issued them; a handle from a
        rebuilt-away engine must be DISCARDED, never synced (its tokens
        were regenerated by the replay)."""
        if pending.owner is not self._engine_token:
            raise RuntimeError(
                "step_sync on a foreign handle: this PendingDispatch was "
                "issued by another engine -- discard it, never sync it")
        if pending.dispatch != self._synced_dispatch + 1:
            raise RuntimeError(
                f"step_sync out of order: handle is dispatch "
                f"{pending.dispatch}, engine expects "
                f"{self._synced_dispatch + 1} -- handles sync exactly "
                "once, in enqueue order")
        tel = self._tel
        overlap_ms = 1e3 * (time.perf_counter() - pending.enqueued_at)
        # every fallible step (the event wait, the host read) comes
        # before the commit point below: a failure leaves the engine
        # untouched, and the caller can retry this same sync
        if pending.event is not None:
            t0 = time.perf_counter()
            pending.event.synchronize()
            pending.wait_s = time.perf_counter() - t0
        data = pending.host.numpy()
        n, B = pending.rounds, self.num_slots
        acc_total = rej_total = 0
        if pending.kind == "spec":
            # (rounds, B, k+1) emissions; accepted/rejected drafts
            w = n * B * (self.spec_k + 1)
            emitted = data[:w].reshape(n, B, -1).transpose(0, 2, 1)
            emitted = emitted.reshape(-1, B)      # (rounds * (k+1), B)
            finished, accepted, rejected = data[w:w + 3 * n * B].reshape(
                3, n, B)
            finished = finished.astype(bool)
            acc_total, rej_total = int(accepted.sum()), int(rejected.sum())
            cur, pos, active, remaining, stepno = data[w + 3 * n * B:
                                                       ].reshape(5, B)
        else:
            emitted, finished = data[:n], data[n:2 * n].astype(bool)
            cur, pos, active, remaining, stepno = data[2 * n:]
        # ---- commit point: everything below is host-side bookkeeping
        self._synced_dispatch = pending.dispatch
        self.spec_accepted_tokens += acc_total
        self.spec_rejected_tokens += rej_total
        self._cur = cur[:, None].astype(np.int32)
        self._pos = pos[:, None].astype(np.int32)
        self._active = active.astype(bool)
        self._remaining = remaining.astype(np.int32)
        self._stepno = stepno.astype(np.int32)
        if self._carry is pending.carry:
            # the frontier caught up with the newest enqueue: barrier
            # dispatches may run again
            self._carry = None
        done: List[Completion] = []
        committed = 0
        for slot in range(self.num_slots):
            toks = [int(t) for t in emitted[:, slot] if t >= 0]
            if not toks:
                continue
            self._tokens[slot].extend(toks)
            committed += len(toks)
            self.tokens_generated += len(toks)
            if finished[:, slot].any():
                req = self.pool.active[slot]
                hit_eos = req.eos_id is not None and toks[-1] == req.eos_id
                done.append(self._retire(
                    slot, FINISH_EOS if hit_eos else FINISH_LENGTH))
        if tel is not None:
            self._sync_telemetry(tel, pending, done, overlap_ms, committed,
                                 acc_total, rej_total)
        return done

    def _sync_telemetry(self, tel, pending: PendingDispatch,
                        done: List[Completion], overlap_ms: float,
                        committed: int, acc_total: int,
                        rej_total: int) -> None:
        """The armed half of :meth:`step_sync` (the JAX engine's events
        and metrics): ``engine.dispatch_synced`` and the overlap
        histogram for an async handle, else ``engine.step`` /
        ``engine.spec_round``; a spec dispatch's acceptance counters and
        accept-rate histogram. Every value is a host int or float."""
        m = tel.metrics
        if pending.kind == "spec":
            # judged = drafts the verify ruled on in the committed stream
            # (accepted + contradicted): the rate reads the draft's
            # quality, 1.0 for a draft that always agrees
            judged = acc_total + rej_total
            if pending.asynchronous:
                tel.event("engine.dispatch_synced",
                          dispatch=pending.dispatch, kind="spec",
                          judged=judged, accepted=acc_total,
                          committed=committed, retired=len(done))
            else:
                tel.event("engine.spec_round", dispatch=pending.dispatch,
                          rounds=pending.rounds, judged=judged,
                          accepted=acc_total, committed=committed,
                          retired=len(done))
        elif pending.asynchronous:
            tel.event("engine.dispatch_synced", dispatch=pending.dispatch,
                      kind="step", retired=len(done))
        else:
            tel.event("engine.step", dispatch=pending.dispatch,
                      active=self.active_count, retired=len(done))
        if pending.asynchronous:
            m.histogram(
                "serve_dispatch_overlap_ms",
                help="host work overlapped with an in-flight "
                "dispatch: enqueue return -> sync start, wall ms"
            ).observe(overlap_ms)
        if pending.kind == "spec":
            m.counter("serve_spec_accepted_tokens_total",
                      help="draft tokens accepted by the verify step"
                      ).inc(acc_total)
            m.counter("serve_spec_rejected_tokens_total",
                      help="draft tokens contradicted by the verify "
                      "step").inc(rej_total)
            if judged:
                m.histogram(
                    "serve_spec_accept_rate",
                    help="per-dispatch draft acceptance rate "
                    "(accepted / judged)").observe(acc_total / judged)

    # -------------------------------------------------------- lifecycle
    def snapshot_in_flight(self) -> List[Tuple[Request, List[int]]]:
        """``[(request, tokens_emitted_so_far)]`` for every in-flight
        slot, in slot order: what a supervisor re-admits after a crash
        (copies, never live buffers). The tokens are the SYNCED frontier
        (an un-synced async dispatch is invisible). Mid-chunking prompts
        have no token list yet (decode hasn't started, or, for a
        replay-of-a-replay, hasn't REstarted), so they fall back to their
        ``replay_tokens``: a second crash during a replay's chunk
        re-feed keeps the first crash's emissions."""
        active = self.pool.active
        return [(active[slot],
                 list(self._tokens.get(
                     slot, active[slot].replay_tokens or ())))
                for slot in sorted(active)]

    def cancel(self, request_id: int,
               reason: str = FINISH_TIMEOUT) -> Optional[Completion]:
        """Abort an in-flight request (deadline expiry): frees its slot,
        returns a completion with the tokens produced so far."""
        slot = self.pool.slot_of(request_id)
        if slot is None:
            return None
        self._require_synced("cancel")
        return self._retire(slot, reason)

    def shutdown(self) -> None:
        """Drop the prefix cache's page references and release the KV
        arena and the draft's cache; the engine is unusable afterwards.
        An outstanding dispatch is discarded with the carry: its tokens
        were never committed."""
        if self.prefix is not None:
            self.prefix.drop()
        self.prefix = None
        self.pool = None
        if self.spec is not None:
            self.spec.shutdown()
        self.spec = None
        self._chunk_queue.clear()
        self._tokens.clear()
        self._adapter_of.clear()
        # an in-flight enqueued dispatch is discarded with the carry and
        # the retry seat: its tokens were never committed
        self._carry = None
        self._retry_sync = None
        self._staged.clear()
        self.chunk_logits = None
        self._active[:] = False

    def _retire(self, slot: int, reason: str) -> Completion:
        # only cancel() retires a slot still chunking: don't rebuild the
        # queue on every retirement
        if any(st.slot == slot for st in self._chunk_queue):
            self._chunk_queue = deque(
                st for st in self._chunk_queue if st.slot != slot)
        req = self.pool.release(slot)
        self._active[slot] = False
        self._unbind_adapter(slot)
        if self.spec is not None:
            # a cancel between activation and the next spec dispatch must
            # not refill a slot that no longer holds the request
            self.spec.discard(slot)
        # a mid-chunking REPLAY has no token list yet: its pre-crash
        # emissions live in replay_tokens, and a cancel must still
        # surface them
        tokens = self._tokens.pop(slot, None)
        if tokens is None:
            tokens = list(req.replay_tokens or ())
        return Completion(
            request_id=req.id, prompt=list(req.prompt), tokens=tokens,
            finish_reason=reason, arrival_time=req.arrival_time,
            first_token_time=req.first_token_time,
            prefix_hit_tokens=req.prefix_hit_tokens, tenant=req.tenant,
            adapter=req.adapter)
