"""Synchronous serving loop: engine + scheduler + clock (counterpart of ``ray_lightning_tpu/serve/client.py``).

:class:`ServeClient` is the single-threaded event loop: submit requests
(immediately or from an arrival trace), then tick -- each tick expires
deadlines, asks the scheduler for the next dispatch (prefill / step /
idle), runs it, and stamps completion timing.

Two clock modes:

- **tick clock** (default, ``clock=None``): time = number of engine
  dispatches so far. Deterministic -- arrival traces in ticks replay
  identically ("request 3 arrives after the 5th dispatch, mid-flight").
- **wall clock** (``clock=time.perf_counter`` or any callable): real
  latencies; arrival times are seconds from the first clock read.

``prefill_chunk=`` and ``prefix_cache=`` are the engine's: long prompts
stream in chunk dispatches the scheduler alternates with decode, and a
chunked request's first token (its TTFT stamp) comes with its final
chunk. ``draft_model=``, ``draft_params=``, ``spec_k=`` and
``draft_weight_dtype=`` make the engine's steps speculative
(:mod:`~ray_lightning_tpu_torch.serve.spec`).

**Async dispatch** (``async_dispatch=True``): a depth-2 pipelined tick
for the decode hot path. When the scheduler's next action is another
step over the same resident rows, the tick ENQUEUES dispatch N+1 on the
device carry first and only then syncs dispatch N, so the retire loop,
the scheduler and the deadline sweep run on N's tokens while N+1
computes. Admission, chunk and idle ticks, adapter loads and a deadline
due on a row in flight drain the pipeline first (they need the synced
frontier), and so does a spec dispatch with stale draft rows or a
sampled row (its round seeds read the step numbers back). Tokens equal
the sync driver's, greedy and sampled; one tick is one *enqueued*
dispatch, so tick-clock stamps equal the JAX async client's.

**Tenancy and multi-LoRA**: ``tenant_classes=`` replaces the FIFO queue
by a :class:`~ray_lightning_tpu_torch.serve.tenancy.TenantScheduler`
(per-class queues, deficit-weighted fair share, tiers, quotas);
``adapters=``, ``max_resident_adapters=`` and ``lora_rank=`` arm the
engine's adapter bank; ``submit(tenant=, adapter=)`` names a request's
class and adapter, and a shed raises
:class:`~ray_lightning_tpu_torch.serve.tenancy.ClassQueueFull` or
:class:`~ray_lightning_tpu_torch.serve.adapters.UnknownAdapter`.

Not yet ported: crash supervision (``retry_policy``), telemetry, the
request journal and fleets (:data:`UNPORTED`).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.serve.engine import (UNPORTED as _ENGINE_UNPORTED,
                                                  ServeEngine,
                                                  refuse_unported)
from ray_lightning_tpu_torch.serve.request import (Completion,
                                                   DEFAULT_TENANT,
                                                   FINISH_REJECTED,
                                                   FINISH_TIMEOUT, Request)
from ray_lightning_tpu_torch.serve.scheduler import (ACTION_CHUNK,
                                                     ACTION_PREFILL,
                                                     ACTION_STEP,
                                                     FifoScheduler,
                                                     QueueFull,
                                                     SchedulerConfig)
from ray_lightning_tpu_torch.serve.tenancy import TenantScheduler

#: the engine's unported arguments plus the client's own
UNPORTED = dict(_ENGINE_UNPORTED, **{
    "retry_policy": "S6 (serving reliability and observability)",
    "journal": "S6 (serving reliability and observability)",
    "clock_epoch": "S6 (serving reliability and observability)",
})


class ServeClient:
    """Synchronous continuous-batching front-end.

    ``ServeClient(model, params, num_slots=8, prefill_len=64)`` builds
    the engine (on ``device``, ``None`` = the card; the dense slot pool
    unless ``page_size=`` asks for the page arena) and a FIFO scheduler;
    ``submit()`` returns a request id, ``run_until_idle()`` drives
    everything to completion, and ``serve_trace([(t, {...}), ...])``
    replays a scripted arrival trace (requests join mid-flight whenever
    ``t`` falls between dispatches). Admission asks the engine
    (``admissible_prefix``): free slots and the prefill width, and on a
    paged engine the free pages too. ``async_dispatch=True`` pipelines
    the decode dispatches (module docstring).
    """

    def __init__(self, model, params, *, num_slots: int = 8,
                 prefill_batch: Optional[int] = None,
                 prefill_len: int = 64, steps_per_dispatch: int = 1,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 seed: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 page_size: Optional[int] = None,
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
                 async_dispatch: bool = False,
                 tenant_classes=None, adapters=None,
                 max_resident_adapters: Optional[int] = None,
                 lora_rank: Optional[int] = None,
                 device=None, **unported):
        refuse_unported(unported, UNPORTED)
        self.engine = ServeEngine(
            model, params, num_slots=num_slots, prefill_batch=prefill_batch,
            prefill_len=prefill_len, steps_per_dispatch=steps_per_dispatch,
            seed=seed, page_size=page_size, num_pages=num_pages,
            kv_dtype=kv_dtype, page_native=page_native,
            attention_kernel=attention_kernel, weight_dtype=weight_dtype,
            weight_group_size=weight_group_size,
            matmul_kernel=matmul_kernel, prefill_chunk=prefill_chunk,
            prefix_cache=prefix_cache, draft_model=draft_model,
            draft_params=draft_params, spec_k=spec_k,
            draft_weight_dtype=draft_weight_dtype,
            tenant_classes=tenant_classes, adapters=adapters,
            max_resident_adapters=max_resident_adapters,
            lora_rank=lora_rank, device=device)
        # tenancy: per-class queues and fair share in place of the FIFO
        # deque (a default-only class list decides as FIFO does)
        if tenant_classes:
            self.scheduler: FifoScheduler = TenantScheduler(
                tenant_classes, scheduler_config)
        else:
            self.scheduler = FifoScheduler(scheduler_config)
        self.async_dispatch = async_dispatch
        # the one outstanding handle of the depth-2 pipeline, synced a
        # tick later; discarded, never synced, at shutdown. (The
        # reference's second seat for a failed two-handle sync,
        # _pending_front, comes with crash supervision.)
        self._pending = None
        self._clock = clock
        self._t0: Optional[float] = None
        self._ops = 0  # engine dispatches so far = the tick clock
        self._next_id = 0
        self.completions: Dict[int, Completion] = {}
        self.num_slots = num_slots

    # ------------------------------------------------------------ clock
    def now(self) -> float:
        if self._clock is None:
            return float(self._ops)
        if self._t0 is None:
            self._t0 = self._clock()
        return self._clock() - self._t0

    # ----------------------------------------------------------- submit
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0, top_k: Optional[int] = None,
               eos_id: Optional[int] = None, seed: Optional[int] = None,
               deadline: Optional[float] = None,
               tenant: Optional[str] = None,
               adapter: Optional[str] = None) -> int:
        """Validate + enqueue one request; returns its id. Raises
        ``ValueError`` for a request that can never fit the engine (or
        names an undeclared tenant, or an adapter that is not resident:
        :class:`~.adapters.UnknownAdapter`) and
        :class:`~.scheduler.QueueFull` at max queue depth (a class at its
        own quota: :class:`~.tenancy.ClassQueueFull`). ``adapter=None``
        decodes under the tenant class's default adapter, if it names
        one, else the base model."""
        req = Request(id=self._next_id, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, eos_id=eos_id,
                      seed=seed, deadline=deadline,
                      tenant=tenant or DEFAULT_TENANT, adapter=adapter)
        self.engine.validate(req)
        now = self.now()
        self.scheduler.submit(req, now)
        if req.arrival_time is None:
            req.arrival_time = now
        self._next_id += 1
        return req.id

    # ----------------------------------------------------- hot adapters
    def load_adapter(self, name: str, adapter) -> Optional[str]:
        """Hot-load a LoRA adapter into the engine's bank (a barrier, like
        admission: the pipeline drains first). Returns the name the load
        evicted, if any."""
        self._drain_for_barrier()
        return self.engine.load_adapter(name, adapter)

    def unload_adapter(self, name: str) -> None:
        """Hot-unload a resident adapter (refused while in-flight rows are
        bound to it)."""
        self._drain_for_barrier()
        self.engine.unload_adapter(name)

    def _drain_for_barrier(self) -> None:
        """Sync the outstanding dispatch before an out-of-band barrier;
        the completions it retires are finalized, not dropped."""
        if self._pending is None:
            return
        done: List[Completion] = []
        self._sync_pending(done)
        self._finalize(done)

    def shutdown(self) -> None:
        """Release the engine's KV arena. With a dispatch in flight the
        handle is discarded, never synced: its tokens were never
        committed."""
        self._pending = None
        self.engine.shutdown()

    # ------------------------------------------------------------- loop
    def tick(self) -> List[Completion]:
        """One scheduling decision + engine dispatch. Returns completions
        retired by this tick (including deadline expirations); under
        ``async_dispatch`` a step tick returns those of the dispatch
        before it."""
        now = self.now()
        done: List[Completion] = []
        # queued requests past deadline never touch the card
        for req in self.scheduler.expire(now):
            done.append(Completion(
                request_id=req.id, prompt=list(req.prompt), tokens=[],
                finish_reason=FINISH_TIMEOUT,
                arrival_time=req.arrival_time, tenant=req.tenant,
                adapter=req.adapter))
        # in-flight requests past deadline free their slot mid-decode.
        # With a dispatch in flight, sync it FIRST: the stale host view
        # cannot tell a row the pending dispatch already retired from one
        # that really ran out of time
        if self._pending is not None and any(
                r.deadline is not None and now >= r.deadline
                for r in self.engine.active_requests.values()):
            self._sync_pending(done)
        for req in list(self.engine.active_requests.values()):
            if req.deadline is not None and now >= req.deadline:
                comp = self.engine.cancel(req.id)
                if comp is not None:
                    done.append(comp)
        action, reqs = self.scheduler.next_action(self.engine)
        if action == ACTION_PREFILL:
            # defer (don't crash on) requests whose seed collides with an
            # in-flight sample stream -- the pool would refuse them; they
            # rejoin the queue head and clear once the other retires
            seen = {r.seed for r in self.engine.active_requests.values()}
            admit: List[Request] = []
            deferred: List[Request] = []
            for req in reqs:
                (deferred if req.seed in seen else admit).append(req)
                seen.add(req.seed)
            if deferred:
                self.scheduler.requeue_front(deferred)
            if admit:
                # admission re-seats rows: a barrier, the pipeline drains
                self._sync_pending(done)
                done.extend(self.engine.prefill(admit))
                self._ops += 1  # count the dispatch before stamping TTFT
                t_first = self.now()
                chunking = self.engine.chunk_pending_ids
                for req in admit:
                    # a chunk-routed request has no first token yet: its
                    # final chunk stamps it (_dispatch_chunk)
                    if req.id not in chunking:
                        req.first_token_time = t_first
            else:
                # every popped request was seed-deferred: advance the
                # engine anyway (the conflicting request may be chunking
                # with nothing decoding), under the same chunk/decode
                # alternation as any other dispatch
                action = self.scheduler.drain_action(self.engine)
        if action == ACTION_CHUNK:
            # a chunk re-seats a row too: barrier
            self._sync_pending(done)
            self._dispatch_chunk(done)
        elif action == ACTION_STEP:
            if self.async_dispatch:
                self._step_pipelined(done)
            else:
                done.extend(self.engine.step())
                self._ops += 1
        elif action != ACTION_PREFILL:
            # idle: a last dispatch may still be pending (its rows all
            # retired inside it) -- drain, then advance the tick clock
            self._sync_pending(done)
            self._ops += 1
        self._finalize(done)
        return done

    def _sync_pending(self, done: List[Completion]) -> None:
        """Drain the pipeline: sync the outstanding dispatch into
        ``done``. The engine is then at its synced frontier and barrier
        dispatches may run."""
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        done.extend(self.engine.step_sync(pending))

    def _step_pipelined(self, done: List[Completion]) -> None:
        """One async step tick: enqueue dispatch N+1 on the device carry,
        THEN sync dispatch N -- its retire loop and the completions'
        stamps run while N+1 computes."""
        eng = self.engine
        if eng.spec_needs_refill or eng.spec_sampled:
            # the refill reads the host's token streams, a sampled round
            # the step numbers: bring the frontier current first
            self._sync_pending(done)
        prev, self._pending = self._pending, eng.step_enqueue()
        self._ops += 1  # one tick = one enqueued dispatch (tick clock)
        if prev is not None:
            done.extend(eng.step_sync(prev))

    @property
    def dispatch_in_flight(self) -> bool:
        """True while an enqueued dispatch awaits its sync."""
        return self._pending is not None

    def _dispatch_chunk(self, done: List[Completion]) -> None:
        """One chunk dispatch, and the TTFT stamp of the request (if any)
        whose final chunk just activated its decode row."""
        done.extend(self.engine.prefill_chunk_step())
        self._ops += 1
        req = self.engine.chunk_activated
        if req is not None and req.first_token_time is None:
            req.first_token_time = self.now()

    def _finalize(self, done: List[Completion]) -> None:
        """Stamp finish times and record completions."""
        t_done = self.now()
        for comp in done:
            comp.finish_time = t_done
            if comp.first_token_time is None and comp.tokens:
                # finished at its own prefill, before the stamping loop
                comp.first_token_time = t_done
            self.completions[comp.request_id] = comp

    @property
    def busy(self) -> bool:
        """True while a tick would do real work: requests queued, rows
        decoding, prompts streaming chunks, or a dispatch awaiting its
        sync."""
        return bool(len(self.scheduler) or self.engine.active_count
                    or self.engine.chunk_pending
                    or self._pending is not None)

    def run_until_idle(self, max_ticks: int = 100_000) \
            -> Dict[int, Completion]:
        """Tick until queue and slots drain; returns all completions."""
        ticks = 0
        while self.busy:
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"serve loop did not drain in {max_ticks} ticks")
        return dict(self.completions)

    def serve_trace(self, trace: Sequence[Tuple[float, dict]],
                    max_ticks: int = 100_000) -> Dict[int, Completion]:
        """Replay a scripted arrival trace ``[(arrival_time,
        submit_kwargs), ...]`` in the client's clock units. Requests are
        submitted the first tick at or after their arrival time; an entry
        admission refuses (queue at depth, prompt that can never fit) is
        shed as a ``finish_reason="rejected"`` completion. Returns
        ``{request_id: Completion}`` with ids in trace order."""
        pending = sorted(trace, key=lambda item: item[0])
        idx = 0
        ticks = 0
        while idx < len(pending) or self.busy:
            now = self.now()
            while idx < len(pending) and pending[idx][0] <= now:
                kwargs = pending[idx][1]
                try:
                    self.submit(**kwargs)
                except (QueueFull, ValueError):
                    rid = self._next_id
                    self._next_id += 1
                    self.completions[rid] = Completion(
                        request_id=rid,
                        prompt=[int(t) for t in kwargs.get("prompt", [])],
                        tokens=[], finish_reason=FINISH_REJECTED,
                        arrival_time=now, finish_time=now,
                        tenant=kwargs.get("tenant") or DEFAULT_TENANT,
                        adapter=kwargs.get("adapter"))
                idx += 1
            if idx < len(pending) and not self.busy:
                # nothing in flight and the next arrival is in the
                # future: fast-forward the tick clock / yield the wall
                # clock instead of spinning
                if self._clock is None:
                    self._ops = max(self._ops, math.ceil(pending[idx][0]))
                else:
                    time.sleep(min(1e-3, max(0.0, pending[idx][0] - now)))
                continue
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"serve trace did not drain in {max_ticks} ticks")
        return dict(self.completions)
