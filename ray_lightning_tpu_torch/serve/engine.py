"""Continuous-batching serving engine, page-native paged KV (counterpart of ``ray_lightning_tpu/serve/engine.py``).

Iteration-level scheduling over a fixed batch of **KV slots**:

1. **prefill** (``(prefill_batch, prefill_len)``): up to ``prefill_batch``
   waiting prompts, left-aligned, run one forward
   (:func:`~ray_lightning_tpu_torch.models.generate._prefill_impl`);
   each row samples its first token with its own parameters, and its
   KV row is scattered into the pages it was given.
2. **step** (``(num_slots, 1)``): ``steps_per_dispatch`` cached decode
   steps for every slot at its own position. K/V are written and read
   straight through the page table inside the model's attention
   (:func:`~ray_lightning_tpu_torch.models.generate.decode_step_paged`)
   -- the read side is the CUDA paged-attention kernel under
   ``attention_kernel="cuda"``. Each row samples with its request's own
   temperature/top_k/seed, counts down its own budget and latches its
   own eos; finished rows retire mid-flight and their slot and pages go
   to the next queued request.

``weight_dtype="int8"|"int4"`` quantizes the engine's own model after it
loads the weights (every matrix to codes plus scales, the f32 copies
dropped: :meth:`ServeEngine.param_bytes` is then the codes and scales);
``matmul_kernel="cuda"`` runs each projection and the tied LM head
through the fused dequant-matmul kernel, ``"torch"`` through its plain
version.

Inactive slots still run (the batch is fixed): the page table they see
is write-masked to −1, so their K/V writes land in the arena's sink page
and their tokens are masked out. Row state (current token, position,
budget, step number) lives on the host between dispatches -- the
synced frontier -- and crosses to the device as one packed array each
way per dispatch.

This slice ports the page-native paged engine only. Every constructor
argument of an unported feature raises ``NotImplementedError`` naming
its ``ROADMAP.md`` item (:data:`UNPORTED`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.generate import (_prefill_impl,
                                                    decode_step_paged,
                                                    row_seed,
                                                    sample_logits_rows)
from ray_lightning_tpu_torch.models.quant import (check_weight_dtype,
                                                  param_bytes)
from ray_lightning_tpu_torch.models.transformer import (ATTENTION_KERNELS,
                                                        MATMUL_KERNELS,
                                                        TransformerLM,
                                                        latch_eos)
from ray_lightning_tpu_torch.serve.pages import (PagePool, SlotPoolFull,
                                                 check_kv_dtype,
                                                 scatter_pages)
from ray_lightning_tpu_torch.serve.request import (Completion, FINISH_EOS,
                                                   FINISH_LENGTH,
                                                   FINISH_TIMEOUT, Request)

__all__ = ["ServeEngine", "SlotPoolFull", "UNPORTED", "refuse_unported"]

#: constructor arguments of features this slice does not port yet ->
#: the ROADMAP.md queue-A item that ports them
UNPORTED = {
    "prefill_chunk": "S2 (chunked prefill, prefix cache)",
    "prefix_cache": "S2 (chunked prefill, prefix cache)",
    "draft_model": "S3 (speculative decoding)",
    "draft_params": "S3 (speculative decoding)",
    "spec_k": "S3 (speculative decoding)",
    "draft_weight_dtype": "S3 (speculative decoding)",
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


class PendingDispatch(NamedTuple):
    """One launched step dispatch: ``packed`` is the device array
    :meth:`ServeEngine.step_sync` copies to the host -- rows
    ``[0, steps)`` emitted tokens (−1 = parked), ``[steps, 2*steps)``
    finished flags, then cur, pos, active, remaining, stepno."""
    rounds: int
    packed: torch.Tensor


class ServeEngine:
    """In-flight batching over a fixed slot batch with a page-native KV
    arena.

    ``model`` is a port ``TransformerLM`` (its config is used;
    ``attention_kernel=`` overrides the config's read side) and
    ``params`` its state dict -- e.g. ``model.state_dict()`` after
    :func:`~ray_lightning_tpu_torch.interop.load_flax_params`. The
    engine builds its own copy of the model on ``device`` (``None`` =
    the card; no card raises) and never changes the caller's.

    ``page_size=`` and ``page_native=True`` are required: the dense slot
    pool and the dense-view paged path are not ported. ``kv_dtype="int8"``
    stores K/V as absmax int8 codes with per-page-per-head scales.

    ``weight_dtype="int8"|"int4"`` (``weight_group_size=`` sizes the int4
    groups, default 64) quantizes the engine's model;
    ``matmul_kernel="cuda"`` (needs ``weight_dtype=``) runs its quantized
    matmuls through the fused kernel, ``"torch"`` (the default) through
    the plain version; ``None`` keeps the model config's choice.

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
                 device=None, **unported):
        refuse_unported(unported, UNPORTED)
        if page_size is None:
            raise NotImplementedError(
                "the dense KV slot pool (page_size=None) is not ported to "
                "ray_lightning_tpu_torch yet (ROADMAP.md queue A, item S1): "
                "pass page_size= and page_native=True")
        if not page_native:
            raise NotImplementedError(
                "the dense-view paged path (page_native=False) is not "
                "ported to ray_lightning_tpu_torch yet (ROADMAP.md queue A, "
                "item S1): pass page_native=True")
        self.device = resolve_device(device)
        cfg = model.cfg
        if attention_kernel is not None:
            if attention_kernel not in ATTENTION_KERNELS:
                raise ValueError(
                    f"attention_kernel must be None or one of "
                    f"{ATTENTION_KERNELS}, got {attention_kernel!r}")
            cfg = dataclasses.replace(cfg, attention_kernel=attention_kernel)
        self.attention_kernel = cfg.attention_kernel
        check_weight_dtype(weight_dtype)  # unknown dtypes refused here
        if matmul_kernel is not None:
            if matmul_kernel not in MATMUL_KERNELS:
                raise ValueError(
                    f"matmul_kernel must be None or one of "
                    f"{MATMUL_KERNELS}, got {matmul_kernel!r}")
            cfg = dataclasses.replace(cfg, matmul_kernel=matmul_kernel)
        self.matmul_kernel = cfg.matmul_kernel
        if self.matmul_kernel == "cuda" and weight_dtype is None:
            raise ValueError(
                "matmul_kernel='cuda' is the fused dequant-matmul kernel for "
                "QUANTIZED weights: pass weight_dtype='int8'|'int4' too, or "
                "drop the kernel")
        if weight_group_size is not None and weight_dtype != "int4":
            raise ValueError(
                "weight_group_size is an int4 grouping option: pass "
                "weight_dtype='int4' to enable it -- int8 scales are "
                "per-output-channel")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if prefill_len > cfg.max_seq_len:
            raise ValueError(
                f"prefill_len ({prefill_len}) exceeds max_seq_len "
                f"({cfg.max_seq_len})")
        if steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
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
            self.model.quantize_weights(weight_dtype, weight_group_size)
        self.num_slots = num_slots
        self.prefill_len = prefill_len
        self.steps_per_dispatch = steps_per_dispatch
        self.seed = seed
        self.kv_dtype = kv_dtype
        self.pool = PagePool(cfg, num_slots, page_size, num_pages=num_pages,
                             kv_dtype=kv_dtype, device=self.device)

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
        self.tokens_generated = 0

    # ------------------------------------------------------------- state
    def param_bytes(self) -> int:
        """At-rest bytes of the engine's model: f32 parameters, or codes
        plus scales for quantized matrices."""
        return param_bytes(self.model.named_weights())

    @property
    def free_slots(self) -> int:
        return self.pool.free_slots

    @property
    def free_pages(self) -> int:
        return self.pool.free_pages

    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    @property
    def active_requests(self) -> Dict[int, Request]:
        return self.pool.active

    def validate(self, request: Request) -> None:
        """Admission check: the request must fit the engine's shapes."""
        cfg = self.model.cfg
        if request.prompt_len > self.prefill_len:
            raise ValueError(
                f"prompt length {request.prompt_len} exceeds the engine's "
                f"prefill_len ({self.prefill_len})")
        if request.prompt_len + request.max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({request.prompt_len}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_seq_len "
                f"({cfg.max_seq_len})")
        need = self.pool.pages_needed(request)
        if need > self.pool.num_pages:
            raise ValueError(
                f"request needs {need} KV pages (prompt "
                f"{request.prompt_len} + max_new_tokens "
                f"{request.max_new_tokens} at page_size "
                f"{self.pool.page_size}) but the arena only has "
                f"{self.pool.num_pages} -- it can never be admitted")

    def admissible_prefix(self, requests: List[Request]) -> int:
        """How many of the queue-head ``requests`` one prefill call can
        admit (FIFO -- a prefix, never a skip-ahead): free slots, the
        prefill batch, and cumulative page demand against free pages."""
        limit = min(len(requests), self.free_slots, self.prefill_batch)
        budget = self.pool.free_pages
        n = 0
        for req in requests[:limit]:
            need = self.pool.pages_needed(req)
            if need > budget:
                break
            budget -= need
            n += 1
        return n

    # ---------------------------------------------------------- programs
    def prefill(self, requests: List[Request]) -> List[Completion]:
        """Start ``requests``: slots and pages are acquired atomically for
        the whole batch, then one prefill pass samples every first token
        and scatters every KV row into its pages. Returns completions of
        requests that finish on their first token (eos or a budget of
        one)."""
        if not requests:
            return []
        if len(requests) > min(self.prefill_batch, self.free_slots):
            raise SlotPoolFull(
                f"{len(requests)} requests > min(free_slots="
                f"{self.free_slots}, prefill_batch={self.prefill_batch})",
                slots_free=self.free_slots, pages_free=self.free_pages,
                active=len(self.pool.active))
        B_pf, P = self.prefill_batch, self.prefill_len
        prompts = np.zeros((B_pf, P), np.int64)
        lengths = np.ones((B_pf,), np.int64)
        inject_pt = np.full((B_pf, self.pool.pages_per_slot), -1, np.int32)
        seeds = [0] * B_pf
        temp = np.zeros((B_pf,), np.float32)
        top_k = np.zeros((B_pf,), np.int32)
        slots: List[int] = []
        try:
            for r, req in enumerate(requests):
                self.validate(req)
                slot = self.pool.acquire(req)
                slots.append(slot)
                prompts[r, :req.prompt_len] = req.prompt
                lengths[r] = req.prompt_len
                inject_pt[r] = self.pool.page_table[slot]
                seeds[r] = row_seed(self.seed, req.seed, 0)
                temp[r] = req.temperature
                top_k[r] = req.top_k or 0
        except Exception:
            # atomic admission: a mid-batch reject (seed collision, bad
            # shape, page shortage) must not leak the slots already taken
            for slot in slots:
                self.pool.release(slot)
            raise
        dev = self.device
        with torch.inference_mode():
            cache, last = _prefill_impl(
                self.model, torch.from_numpy(prompts).to(dev),
                torch.from_numpy(lengths).to(dev))
            first = sample_logits_rows(last, seeds, temp, top_k)
            # padding rows' table is all −1: their pages go to the sink
            scatter_pages(self.pool.arena, cache,
                          torch.from_numpy(inject_pt).to(dev))
            first = first.cpu().numpy()
        done: List[Completion] = []
        for r, req in enumerate(requests):
            comp = self._activate(req, slots[r], int(first[r]))
            if comp is not None:
                done.append(comp)
        self.prefills += 1
        return done

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

    def _enqueue(self) -> Optional[PendingDispatch]:
        if not self._active.any():
            return None
        dev = self.device
        steps = self.steps_per_dispatch
        state = torch.from_numpy(np.stack([
            self._cur[:, 0], self._pos[:, 0], self._active.astype(np.int32),
            self._remaining, self._stepno, self._eos])).to(dev)
        cur, pos = state[0][:, None], state[1][:, None]
        active, remaining, stepno, eos = (state[2].bool(), state[3],
                                          state[4], state[5])
        page_table = torch.from_numpy(self._write_masked_table()).to(dev)
        # only rows in flight at entry sample; a row that finishes inside
        # the dispatch keeps sampling into its masked-out emissions
        temp = np.where(self._active, self._temp, 0.0)
        emitted_all, finished_all = [], []
        with torch.inference_mode():
            for s in range(steps):
                # a row still in flight at sub-step s is at step stepno+s
                seeds = [row_seed(self.seed, int(self._seeds[r]),
                                  int(self._stepno[r]) + s)
                         if temp[r] > 0 else 0
                         for r in range(self.num_slots)]
                last = decode_step_paged(self.model, self.pool.arena, cur,
                                         pos, page_table)
                (cur, pos, active, remaining, stepno, emitted,
                 finished) = _advance_rows(
                    self.model.cfg.max_seq_len, last, cur, pos, active,
                    remaining, temp, self._top_k, eos, seeds, stepno)
                emitted_all.append(emitted)
                finished_all.append(finished.to(torch.int32))
            packed = torch.stack(
                emitted_all + finished_all
                + [cur[:, 0], pos[:, 0], active.to(torch.int32), remaining,
                   stepno])
        self.steps += 1
        self.decode_substeps += steps
        return PendingDispatch(rounds=steps, packed=packed)

    def step_sync(self, pending: PendingDispatch) -> List[Completion]:
        """Copy one dispatch's outputs to the host (the blocking point),
        catch the host row state up, and retire finished rows."""
        data = pending.packed.cpu().numpy()
        n = pending.rounds
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
        """Release the KV arena; the engine is unusable afterwards."""
        self.pool = None
        self._tokens.clear()
        self._active[:] = False

    def _retire(self, slot: int, reason: str) -> Completion:
        req = self.pool.release(slot)
        self._active[slot] = False
        tokens = self._tokens.pop(slot, [])
        return Completion(
            request_id=req.id, prompt=list(req.prompt), tokens=tokens,
            finish_reason=reason, arrival_time=req.arrival_time,
            first_token_time=req.first_token_time)
