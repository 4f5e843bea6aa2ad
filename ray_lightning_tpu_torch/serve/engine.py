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

This port covers the three layouts with chunked prefill and the prefix
cache (paged engines) and speculative decoding; a crashed request's
replay (``replay_tokens``) is not ported, so a chunk feeds the prompt
alone. Every constructor argument of an unported feature raises
``NotImplementedError`` naming its ``ROADMAP.md`` item
(:data:`UNPORTED`).
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Deque, Dict, FrozenSet, List, NamedTuple, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models import paged_attention as _pa
from ray_lightning_tpu_torch.models.generate import (_chunk_prefill_impl,
                                                    _prefill_impl,
                                                    decode_step,
                                                    decode_step_paged,
                                                    row_seed,
                                                    sample_logits_rows)
from ray_lightning_tpu_torch.models.quant import (check_weight_dtype,
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
from ray_lightning_tpu_torch.serve.request import (Completion, FINISH_EOS,
                                                   FINISH_LENGTH,
                                                   FINISH_TIMEOUT, Request)
from ray_lightning_tpu_torch.serve.spec import (SpecDecoder,
                                                _spec_rounds_impl,
                                                _spec_rounds_page_native_impl,
                                                _spec_rounds_paged_impl)

__all__ = ["ServeEngine", "KVSlotPool", "SlotPoolFull", "UNPORTED",
           "refuse_unported"]

#: constructor arguments of features this slice does not port yet ->
#: the ROADMAP.md queue-A item that ports them
UNPORTED = {
    "adapters": "S4 (multi-LoRA serving, tenancy)",
    "max_resident_adapters": "S4 (multi-LoRA serving, tenancy)",
    "lora_rank": "S4 (multi-LoRA serving, tenancy)",
    "tenant_classes": "S4 (multi-LoRA serving, tenancy)",
    "telemetry": "S6 (serving reliability and observability)",
}


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
                      steps: int) -> torch.Tensor:
    """The decode step program on dense storage (the slot pool, or a
    paged engine's gathered view): ``steps`` per-row
    :func:`~ray_lightning_tpu_torch.models.generate.decode_step`\\ s on
    the compute-dtype caches. int8 storage is dequantized whole before
    them and re-quantized whole after (JAX's ``dense_storage_values`` /
    ``dense_storage_commit``). An inactive row re-writes its frozen K/V
    into its own row."""
    cache = dense_storage_values(storage, model.cfg.dtype)
    packed = _decode_steps(
        lambda cur, pos: decode_step(model, cache, cur, pos),
        model.cfg.max_seq_len, row_state, temp, top_k, seeds_at,
        steps=steps)
    dense_storage_commit(storage, cache)
    return packed


def _paged_step_impl(model, arena, page_table, row_state, temp, top_k,
                     seeds_at, *, steps: int) -> torch.Tensor:
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
                               seeds_at, steps=steps)
    scatter_pages(arena, view, write_pt)
    return packed


def _prefill_inject_impl(model, storage, prompts, lengths, slots, seeds,
                         temp, top_k) -> torch.Tensor:
    """Batched prompt fill on the slot pool: the prefill forward at
    ``(prefill_batch, prefill_len)``, each row's first token sampled,
    then each of the ``len(slots)`` valid rows' WHOLE KV row (zeros past
    the prompt) copied into its slot; padding rows are written nowhere.
    int8 storage is dequantized whole and re-quantized whole around the
    copy. Returns the first tokens (B_pf,)."""
    cache = dense_storage_values(storage, model.cfg.dtype)
    pf_cache, last = _prefill_impl(model, prompts, lengths)
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
    fed: List[int]       # the prompt
    next_off: int        # first position not yet written (admission
    #                      sets it past any adopted prefix pages)


class PendingDispatch(NamedTuple):
    """One launched step dispatch: ``packed`` is the device array
    :meth:`ServeEngine.step_sync` copies to the host -- rows
    ``[0, steps)`` emitted tokens (−1 = parked), ``[steps, 2*steps)``
    finished flags, then cur, pos, active, remaining, stepno. A spec
    dispatch (``spec=True``) packs it flat: emitted (rounds, B, k+1),
    finished, accepted and rejected (rounds, B), then the row state."""
    rounds: int
    packed: torch.Tensor
    spec: bool = False


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

    Drive it with :class:`~ray_lightning_tpu_torch.serve.client.ServeClient`
    or directly: ``prefill([reqs])`` starts requests, ``step()`` advances
    every in-flight one; each returns newly finished
    :class:`Completion`\\ s.
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
                 device=None, **unported):
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
        check_kv_dtype(kv_dtype)
        # the engine's own model: built without initializing (meta), then
        # filled from params on the target device
        self.model = TransformerLM(cfg, device="meta").to_empty(
            device=self.device)
        self.model.load_state_dict(params)
        self.model.requires_grad_(False).eval()
        self.weight_dtype = weight_dtype
        if weight_dtype is not None:
            self.model.quantize_weights(
                weight_dtype,
                weight_group_size if weight_dtype == "int4" else None)
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

    def validate(self, request: Request) -> None:
        """Admission check: the request must fit the engine's shapes."""
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
    def _routes_chunked(self, request: Request) -> bool:
        """Chunk routing: every prompt when the prefix cache is on (the
        pages it publishes must all come from chunk dispatches), else
        prompts longer than a chunk (a bounded decode stall) or than the
        batched prefill takes at all."""
        if self.prefill_chunk is None:
            return False
        if self.prefix is not None:
            return True
        fed = request.prompt_len
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
        its slot or scatters it into its pages; chunk-routed prompts (longer than ``prefill_chunk``, or
        any prompt under a prefix cache) are queued for
        :meth:`prefill_chunk_step` instead, past any prefix pages they
        adopt. Returns completions of requests that finish on their
        first token (eos or a budget of one)."""
        if not requests:
            return []
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
        acquired: List[int] = []
        batched: List[Request] = []
        slots: List[int] = []
        adoptions = []
        n_chunked = 0
        try:
            for req in requests:
                self.validate(req)
                fed = list(req.prompt)
                if self._routes_chunked(req):
                    adopt = self._adoptable_prefix(fed)
                    slot = self._admit_paged(req, adopt)
                    acquired.append(slot)
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
                        adoptions.append((eligible, len(adopt)))
                    continue
                slot = (self._admit_paged(req, []) if self.paged
                        else self.pool.acquire(req))
                acquired.append(slot)
                r = len(batched)
                batched.append(req)
                slots.append(slot)
                prompts[r, :req.prompt_len] = fed
                lengths[r] = req.prompt_len
                if self.paged:
                    inject_pt[r] = self.pool.page_table[slot]
                seeds[r] = row_seed(self.seed, req.seed, 0)
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
            for _ in range(n_chunked):
                self._chunk_queue.pop()
            raise
        # statistics only once the whole batch's admission held
        for eligible, adopted in adoptions:
            self.prefix.record_admission(eligible, adopted)
        if not batched:
            return []
        dev = self.device
        prompts_t = torch.from_numpy(prompts).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        with torch.inference_mode():
            if self.paged:
                cache, last = _prefill_impl(self.model, prompts_t, lengths_t)
                first = sample_logits_rows(last, seeds, temp, top_k)
                # padding rows' table is all −1: their pages go to the sink
                scatter_pages(self.pool.arena, cache,
                              torch.from_numpy(inject_pt).to(dev))
            else:
                first = _prefill_inject_impl(
                    self.model, self.pool.cache, prompts_t, lengths_t,
                    slots, seeds, temp, top_k)
            first = first.cpu().numpy()
        done: List[Completion] = []
        for r, req in enumerate(batched):
            comp = self._activate(req, slots[r], int(first[r]))
            if comp is not None:
                done.append(comp)
        self.prefills += 1
        return done

    def prefill_chunk_step(self) -> List[Completion]:
        """One chunk dispatch for the head of the chunk queue: the next
        ``prefill_chunk`` tokens at the request's offset. On the final
        chunk the sampled first token (the same ``row_seed(engine seed,
        request seed, 0)`` draw as the batched prefill's) activates the
        decode row, or retires the request (eos or a budget of one);
        with a prefix cache the prompt's full pages are published
        first."""
        self.chunk_activated = None
        if not self._chunk_queue:
            return []
        st = self._chunk_queue[0]
        req = st.request
        C = self.prefill_chunk
        L = len(st.fed)
        off = st.next_off
        valid = min(C, L - off)
        final = off + valid >= L
        tokens = np.zeros((1, C), np.int64)
        tokens[0, :valid] = st.fed[off:off + valid]
        dev = self.device
        with torch.inference_mode():
            last = _chunk_prefill_impl(
                self.model, self.pool.arena,
                torch.from_numpy(self.pool.page_table[st.slot]).to(dev),
                torch.from_numpy(tokens).to(dev), off, valid)
            self.chunk_logits = last
            first = None
            if final:
                first = int(sample_logits_rows(
                    last, [row_seed(self.seed, req.seed, 0)],
                    [req.temperature], [req.top_k or 0])[0])
        st.next_off = off + valid
        self.chunk_dispatches += 1
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
        """First-token bookkeeping: record the token, retire on
        eos-on-first or a budget of one, else arm the slot's row."""
        self._tokens[slot] = [tok]
        self.tokens_generated += 1
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if hit_eos or req.max_new_tokens <= 1:
            return self._retire(slot, FINISH_EOS if hit_eos
                                else FINISH_LENGTH)
        self._cur[slot, 0] = tok
        self._pos[slot, 0] = req.prompt_len
        self._active[slot] = True
        self._remaining[slot] = req.max_new_tokens - 1
        self._temp[slot] = req.temperature
        self._top_k[slot] = req.top_k or 0
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._seeds[slot] = req.seed
        self._stepno[slot] = 1
        if self.spec is not None:
            # whatever armed the row (a prefill, a final chunk), the draft
            # rebuilds its KV from the whole context before the next round
            self.spec.mark_stale(slot)
        return None

    def step(self) -> List[Completion]:
        """Advance every in-flight request up to ``steps_per_dispatch``
        tokens in one dispatch; returns the completions of rows that
        finished inside it (rows finishing at sub-step k park for the
        rest)."""
        pending = self._enqueue()
        if pending is None:
            return []
        return self.step_sync(pending)

    def _write_masked_table(self) -> np.ndarray:
        """The page table with inactive rows' entries masked to −1: their
        parked writes go to the sink, their reads clamp harmlessly."""
        return np.where(self._active[:, None], self.pool.page_table,
                        -1).astype(np.int32)

    def _row_state(self):
        """The host row state on the device, in one copy: cur and pos
        (B, 1), active, remaining, stepno, eos (B,)."""
        state = torch.from_numpy(np.stack([
            self._cur[:, 0], self._pos[:, 0], self._active.astype(np.int32),
            self._remaining, self._stepno, self._eos])).to(self.device)
        return (state[0][:, None], state[1][:, None], state[2].bool(),
                state[3], state[4], state[5])

    def _enqueue(self) -> Optional[PendingDispatch]:
        if not self._active.any():
            return None
        if self.spec is not None:
            return self._spec_enqueue()
        dev = self.device
        steps = self.steps_per_dispatch
        row_state = self._row_state()
        # only rows in flight at entry sample; a row that finishes inside
        # the dispatch keeps sampling into its masked-out emissions
        temp = np.where(self._active, self._temp, 0.0)

        def seeds_at(s):
            # a row still in flight at sub-step s is at step stepno+s
            return [row_seed(self.seed, int(self._seeds[r]),
                             int(self._stepno[r]) + s)
                    if temp[r] > 0 else 0 for r in range(self.num_slots)]

        model = self.model
        with torch.inference_mode():
            if self.page_native:
                arena = self.pool.arena
                page_table = torch.from_numpy(
                    self._write_masked_table()).to(dev)
                packed = _decode_steps(
                    lambda cur, pos: decode_step_paged(
                        model, arena, cur, pos, page_table),
                    model.cfg.max_seq_len, row_state, temp, self._top_k,
                    seeds_at, steps=steps)
            elif self.paged:
                packed = _paged_step_impl(
                    model, self.pool.arena,
                    torch.from_numpy(self.pool.page_table).to(dev),
                    row_state, temp, self._top_k, seeds_at, steps=steps)
            else:
                packed = _engine_step_impl(
                    model, self.pool.cache, row_state, temp, self._top_k,
                    seeds_at, steps=steps)
        self.steps += 1
        self.decode_substeps += steps
        return PendingDispatch(rounds=steps, packed=packed)

    def _spec_enqueue(self) -> PendingDispatch:
        """One speculative dispatch: refill stale draft rows from the
        host-side token streams, then ``steps_per_dispatch`` rounds (k+1
        draft feeds, one ``(B, k+1)`` verify, the accept rule each):
        through the write-masked table (page-native), on the gathered
        view of the full table with write-masked scatter (dense view), or
        on the slot pool (dense)."""
        spec = self.spec
        for slot in spec.stale:
            req = self.pool.active.get(slot)
            if req is None or not self._active[slot]:
                spec.discard(slot)
                continue
            # the draft KV covers 0..pos-1: the whole context but the
            # current token, which the round's first feed supplies
            spec.refill(slot, list(req.prompt) + self._tokens[slot][:-1])
        k, rounds = spec.k, self.steps_per_dispatch
        cur, pos, active, remaining, stepno, eos = self._row_state()
        temp = np.where(self._active, self._temp, 0.0)
        rows = (spec.cache, cur, pos, active, remaining, temp, self._top_k,
                eos, stepno, self.seed, self._seeds)
        with torch.inference_mode():
            if self.page_native:
                page_table = torch.from_numpy(
                    self._write_masked_table()).to(self.device)
                out = _spec_rounds_page_native_impl(
                    self.model, spec.model, self.pool.arena, page_table,
                    *rows, k=k, rounds=rounds)
            elif self.paged:
                out = _spec_rounds_paged_impl(
                    self.model, spec.model, self.pool.arena,
                    torch.from_numpy(self.pool.page_table).to(self.device),
                    *rows, k=k, rounds=rounds)
            else:
                out = _spec_rounds_impl(self.model, spec.model,
                                        self.pool.cache, *rows, k=k,
                                        rounds=rounds)
            (cur, pos, active, remaining, stepno, emitted, accepted,
             rejected, finished) = out
            packed = torch.cat([
                x.to(torch.int32).reshape(-1)
                for x in (emitted, finished, accepted, rejected, cur, pos,
                          active, remaining, stepno)])
        self.steps += 1
        self.decode_substeps += rounds
        self.spec_rounds += rounds
        self.spec_draft_steps += (k + 1) * rounds
        return PendingDispatch(rounds=rounds, packed=packed, spec=True)

    def step_sync(self, pending: PendingDispatch) -> List[Completion]:
        """Copy one dispatch's outputs to the host (the blocking point),
        catch the host row state up, and retire finished rows."""
        data = pending.packed.cpu().numpy()
        n, B = pending.rounds, self.num_slots
        if pending.spec:
            # (rounds, B, k+1) emissions; accepted/rejected drafts
            w = n * B * (self.spec_k + 1)
            emitted = data[:w].reshape(n, B, -1).transpose(0, 2, 1)
            emitted = emitted.reshape(-1, B)      # (rounds * (k+1), B)
            finished, accepted, rejected = data[w:w + 3 * n * B].reshape(
                3, n, B)
            finished = finished.astype(bool)
            self.spec_accepted_tokens += int(accepted.sum())
            self.spec_rejected_tokens += int(rejected.sum())
            cur, pos, active, remaining, stepno = data[w + 3 * n * B:
                                                       ].reshape(5, B)
        else:
            emitted, finished = data[:n], data[n:2 * n].astype(bool)
            cur, pos, active, remaining, stepno = data[2 * n:]
        self._cur = cur[:, None].astype(np.int32)
        self._pos = pos[:, None].astype(np.int32)
        self._active = active.astype(bool)
        self._remaining = remaining.astype(np.int32)
        self._stepno = stepno.astype(np.int32)
        done: List[Completion] = []
        for slot in range(self.num_slots):
            toks = [int(t) for t in emitted[:, slot] if t >= 0]
            if not toks:
                continue
            self._tokens[slot].extend(toks)
            self.tokens_generated += len(toks)
            if finished[:, slot].any():
                req = self.pool.active[slot]
                hit_eos = req.eos_id is not None and toks[-1] == req.eos_id
                done.append(self._retire(
                    slot, FINISH_EOS if hit_eos else FINISH_LENGTH))
        return done

    # -------------------------------------------------------- lifecycle
    def cancel(self, request_id: int,
               reason: str = FINISH_TIMEOUT) -> Optional[Completion]:
        """Abort an in-flight request (deadline expiry): frees its slot,
        returns a completion with the tokens produced so far."""
        slot = self.pool.slot_of(request_id)
        if slot is None:
            return None
        return self._retire(slot, reason)

    def shutdown(self) -> None:
        """Drop the prefix cache's page references and release the KV
        arena and the draft's cache; the engine is unusable afterwards."""
        if self.prefix is not None:
            self.prefix.drop()
        self.prefix = None
        self.pool = None
        if self.spec is not None:
            self.spec.shutdown()
        self.spec = None
        self._chunk_queue.clear()
        self._tokens.clear()
        self._active[:] = False

    def _retire(self, slot: int, reason: str) -> Completion:
        # only cancel() retires a slot still chunking: don't rebuild the
        # queue on every retirement
        if any(st.slot == slot for st in self._chunk_queue):
            self._chunk_queue = deque(
                st for st in self._chunk_queue if st.slot != slot)
        req = self.pool.release(slot)
        self._active[slot] = False
        if self.spec is not None:
            # a cancel between activation and the next spec dispatch must
            # not refill a slot that no longer holds the request
            self.spec.discard(slot)
        tokens = self._tokens.pop(slot, [])
        return Completion(
            request_id=req.id, prompt=list(req.prompt), tokens=tokens,
            finish_reason=reason, arrival_time=req.arrival_time,
            first_token_time=req.first_token_time,
            prefix_hit_tokens=req.prefix_hit_tokens)
