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
  latencies; arrival times are seconds from the first clock read, or
  from ``clock_epoch=`` when one is given (an external origin shared by
  several clients).

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

**Reliability and observability**:

- ``retry_policy=RetryPolicy(...)`` wraps the engine in a
  :class:`~ray_lightning_tpu_torch.reliability.ServeSupervisor`: a
  crashed dispatch rebuilds the engine and replays every in-flight
  request (prompt + emitted tokens) instead of unwinding through the
  loop; a request the replay cannot take, or every in-flight request
  once the policy is exhausted, retires ``"failed"`` with its partial
  tokens. Under async dispatch a rebuild DISCARDS every outstanding
  handle of the dead engine, never syncs it: its rows were regenerated
  by the replay. Replay identity is an f32 contract: the replay rebuilds
  the KV through the prefill or chunk forward, where the run it replaces
  wrote it through decode steps, so bf16 greedy tokens may round the
  other way.
- ``journal=Journal(path)`` writes admissions, the synced frontier and
  retirements ahead to disk (:mod:`~ray_lightning_tpu_torch.serve.journal`);
  :meth:`ServeClient.restore` rebuilds a client from a dead driver's
  journal and replays every unretired request. The ``serve.driver``
  fault site fires at the top of every tick.
- ``telemetry=Telemetry(...)`` (:mod:`~ray_lightning_tpu_torch.obs`)
  arms the request lifecycle events (``serve.submit``, ``serve.admit``,
  ``serve.first_token``, ``serve.retire``, ``serve.reject``), the TTFT,
  TPOT and latency histograms, the queue and occupancy gauges, the
  per-tenant TTFT histograms and SLO-miss counters, and the engine's
  own (the JAX client's names and payloads).

Only a host-side fault (an exception at a dispatch, an out-of-memory
error) recovers in-process; a sticky CUDA error poisons the process's
context and needs a new process: ``ReplicaFleet(backend="process")``
(:mod:`~ray_lightning_tpu_torch.serve.process_fleet`) kills the worker
it happened in and replays its requests on the others.

The fleet's seats (:class:`~ray_lightning_tpu_torch.serve.fleet.ReplicaFleet`):
``ops``, ``load_stats()``, ``gauge_prefix`` (a member client's
occupancy gauges carry ``replica<id>_``) and ``_fire_driver_site`` (a
member client never fires ``serve.driver``). Their defaults leave a
standalone client's events and metrics unchanged.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.reliability import faults
from ray_lightning_tpu_torch.reliability.faults import SITE_SERVE_DRIVER
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

#: the engine's unported arguments plus the client's own (empty: every
#: argument of the JAX client is ported)
UNPORTED: Dict[str, str] = dict(_ENGINE_UNPORTED)


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
    the decode dispatches; ``retry_policy=``, ``journal=`` and
    ``telemetry=`` arm crash supervision, the request journal and
    telemetry (module docstring).
    """

    def __init__(self, model, params, *, num_slots: int = 8,
                 prefill_batch: Optional[int] = None,
                 prefill_len: int = 64, steps_per_dispatch: int = 1,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 seed: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 clock_epoch: Optional[float] = None,
                 retry_policy=None, telemetry=None,
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
                 journal=None, device=None, **unported):
        refuse_unported(unported, UNPORTED)
        engine_kwargs = dict(
            num_slots=num_slots, prefill_batch=prefill_batch,
            prefill_len=prefill_len, steps_per_dispatch=steps_per_dispatch,
            seed=seed, telemetry=telemetry, page_size=page_size,
            num_pages=num_pages, kv_dtype=kv_dtype, page_native=page_native,
            attention_kernel=attention_kernel, weight_dtype=weight_dtype,
            weight_group_size=weight_group_size,
            matmul_kernel=matmul_kernel, prefill_chunk=prefill_chunk,
            prefix_cache=prefix_cache, draft_model=draft_model,
            draft_params=draft_params, spec_k=spec_k,
            draft_weight_dtype=draft_weight_dtype,
            tenant_classes=tenant_classes, adapters=adapters,
            max_resident_adapters=max_resident_adapters,
            lora_rank=lora_rank, device=device)
        if retry_policy is not None:
            # supervised engine: dispatch crashes rebuild + replay under
            # the policy instead of unwinding through the client loop;
            # exhausted requests retire as finish_reason="failed"
            from ray_lightning_tpu_torch.reliability import ServeSupervisor
            self.engine = ServeSupervisor(model, params,
                                          policy=retry_policy,
                                          **engine_kwargs)
        else:
            self.engine = ServeEngine(model, params, **engine_kwargs)
        # tenancy: per-class queues and fair share in place of the FIFO
        # deque (a default-only class list decides as FIFO does); the
        # same list rode engine_kwargs, so rebuilt engines keep it
        if tenant_classes:
            self.scheduler: FifoScheduler = TenantScheduler(
                tenant_classes, scheduler_config)
            self._tenancy: Optional[TenantScheduler] = self.scheduler
        else:
            self.scheduler = FifoScheduler(scheduler_config)
            self._tenancy = None
        self._clock = clock
        self.async_dispatch = async_dispatch
        # the one outstanding handle of the depth-2 pipeline, synced a
        # tick later; discarded, never synced, on an engine rebuild and
        # at shutdown
        self._pending = None
        # the two-live-handles crash seat: when an unsupervised sync of
        # the OLDER handle fails while a newer enqueue is already live,
        # the older handle parks here so a resumed loop re-syncs it in
        # dispatch order instead of wedging on the out-of-order guard.
        # Same discard rules as _pending
        self._pending_front = None
        # discarded handles whose host copy may still be in flight: kept
        # alive until their event has completed, so their pinned buffers
        # never go back to the host allocator mid-copy (never synced)
        self._discarded: List[Any] = []
        # clock_epoch pins t=0 to an external origin instead of this
        # client's first now() call
        self._t0: Optional[float] = clock_epoch
        self._ops = 0  # engine dispatches so far = the tick clock
        self._next_id = 0
        self._seen_rebuilds = 0  # supervised: recovery TTFT sweep
        self.completions: Dict[int, Completion] = {}
        # telemetry is off by default: every armed emission below sits
        # behind `if tel is not None`
        self._tel = telemetry
        # the write-ahead request journal (serve/journal.py); None costs
        # one attribute read + None check per hook
        self._journal = journal
        # armed-only: request id -> enqueue->sync duration of the async
        # dispatch that retired it (client clock units), read by the
        # serve.retire event
        self._sync_durs: Dict[int, float] = {}
        self.num_slots = num_slots
        # the serve.driver site fires on a driver's own tick only: a
        # ReplicaFleet's member client is a replica turn (serve.replica)
        # and turns this off
        self._fire_driver_site = True
        # prefix of this client's occupancy gauges: "" standalone; a
        # ReplicaFleet gives each replica "replica<id>_" so their gauges
        # do not overwrite each other in the shared registry (counters
        # and histograms stay unprefixed: they add up across writers)
        self.gauge_prefix = ""

    # ------------------------------------------------------------ clock
    @property
    def ops(self) -> int:
        """Engine dispatches so far (the tick clock)."""
        return self._ops

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
        rid = self.submit_request(req)
        self._next_id += 1
        return rid

    def submit_request(self, req: Request) -> int:
        """Validate + enqueue an externally built :class:`Request` (a
        journal restore re-admits through here): its arrival and
        first-token stamps and ``replay_tokens`` ride the request
        untouched, and ``arrival_time`` is stamped only when the request
        has never been admitted anywhere."""
        self.engine.validate(req)
        now = self.now()
        tel = self._tel
        try:
            self.scheduler.submit(req, now)
        except QueueFull as exc:
            if tel is not None and self._tenancy is not None:
                tel.event("engine.tenant_shed", id=req.id,
                          tenant=req.tenant, why=type(exc).__name__)
                tel.metrics.counter(
                    f"serve_tenant_shed_total_{req.tenant}",
                    help="admission refusals for this tenant class "
                    "(per-class quota and global-bound sheds)").inc()
            raise
        if req.arrival_time is None:
            req.arrival_time = now
        if self._journal is not None:
            self._journal.admit(req)
        if tel is not None:
            tel.event("serve.submit", id=req.id,
                      prompt_len=req.prompt_len,
                      max_new_tokens=req.max_new_tokens, t=now)
            tel.metrics.counter(
                "serve_requests_total",
                help="requests accepted by admission control").inc()
            tel.metrics.gauge(
                self.gauge_prefix + "serve_queue_depth",
                help="requests waiting in the scheduler queue"
            ).set(len(self.scheduler))
            if self._tenancy is not None:
                depth = self._tenancy.class_depths().get(req.tenant, 0)
                tel.event("engine.tenant_admitted", id=req.id,
                          tenant=req.tenant, class_depth=depth)
                tel.metrics.gauge(
                    self.gauge_prefix
                    + f"serve_tenant_queue_depth_{req.tenant}",
                    help="requests waiting in this tenant class's queue"
                ).set(depth)
        return req.id

    def _stamp_first_token(self, req: Request, t: float) -> None:
        """First-token bookkeeping shared by every stamping path
        (batched admit, final chunk, post-recovery sweep)."""
        req.first_token_time = t
        if self._tel is not None:
            self._tel.event("serve.first_token", id=req.id,
                            ttft=t - req.arrival_time, t=t)

    # ----------------------------------------------------- hot adapters
    def load_adapter(self, name: str, adapter) -> Optional[str]:
        """Hot-load a LoRA adapter into the engine's bank (a barrier, like
        admission: the pipeline drains first). Returns the name the load
        evicted, if any. A supervised engine mirrors the load into its
        rebuild arguments."""
        self._drain_for_barrier()
        return self.engine.load_adapter(name, adapter)

    def unload_adapter(self, name: str) -> None:
        """Hot-unload a resident adapter (refused while in-flight rows are
        bound to it)."""
        self._drain_for_barrier()
        self.engine.unload_adapter(name)

    def _drain_for_barrier(self) -> None:
        """Sync the outstanding dispatch(es) before an out-of-band
        barrier; the completions they retire are finalized, not
        dropped."""
        if self._pending is None and self._pending_front is None:
            return
        done: List[Completion] = []
        self._sync_pending(done)
        self._finalize(done)

    def _discard(self, handle) -> None:
        """Drop a dead engine's handle without syncing it. Its host copy
        may still be in flight into its pinned buffer: the handle stays
        referenced until its event has completed (``query()`` never
        blocks), so the buffer cannot go back to the host allocator and
        be reused mid-copy."""
        if getattr(handle, "event", None) is not None:
            self._discarded.append(handle)
        self._discarded = [h for h in self._discarded
                           if not h.event.query()]

    def shutdown(self) -> None:
        """Release the engine's KV arena and close the journal. With a
        dispatch in flight the handle is discarded, never synced: its
        tokens were never committed."""
        for handle in (self._pending, self._pending_front):
            if handle is not None:
                self._discard(handle)
        self._pending = None
        self._pending_front = None
        for handle in self._discarded:
            # waits for the copy into the pinned buffer, commits nothing
            handle.event.synchronize()
        self._discarded = []
        journal = self._journal
        if journal is not None:
            self._journal = None
            journal.shutdown()
        self.engine.shutdown()

    # ----------------------------------------------------- warm restart
    @classmethod
    def restore(cls, journal_path: str, model, params, *,
                sync_every: int = 8, **kwargs) -> "ServeClient":
        """Rebuild a client from a dead driver's journal and re-admit
        every unretired request with ``replay_tokens`` set from the
        journaled frontier.

        ``kwargs`` are the constructor arguments the dead client was
        built with -- the engine must have the same shapes (and the same
        ``tenant_classes``/``adapters``) for the re-admissions to
        validate. The journal at ``journal_path`` is REOPENED for
        appending with a bumped generation, so the restarted session
        keeps journaling into the same file and a second crash restores
        again. Token identity across the restart: the sampling seeds are
        ``row_seed(engine seed, request seed, step)``, so re-feeding
        ``prompt + frontier`` resumes each stream, and a request whose
        retire record was durable is never re-emitted.
        """
        from ray_lightning_tpu_torch.serve.journal import (
            COUNTER_JOURNAL_REPLAYED, EVENT_JOURNAL_RESTORED, Journal,
            read_journal)
        state = read_journal(journal_path)
        journal = Journal(journal_path, sync_every=sync_every,
                          generation=state.generation + 1,
                          telemetry=kwargs.get("telemetry"))
        client = cls(model, params, journal=journal, **kwargs)
        pending = state.pending()
        for req, toks in pending:
            req.replay_tokens = list(toks) if toks else None
            client.submit_request(req)
        client._next_id = max(client._next_id, state.next_request_id)
        tel = client._tel
        if tel is not None:
            tel.event(EVENT_JOURNAL_RESTORED, path=str(journal_path),
                      generation=journal.generation,
                      replayed=len(pending), retired=len(state.retired),
                      torn_tail=state.torn_tail)
            tel.metrics.counter(
                COUNTER_JOURNAL_REPLAYED,
                help="unretired requests re-admitted by warm restart"
            ).inc(len(pending))
        return client

    # ------------------------------------------------------------- loop
    def tick(self) -> List[Completion]:
        """One scheduling decision + engine dispatch. Returns completions
        retired by this tick (including deadline expirations); under
        ``async_dispatch`` a step tick returns those of the dispatch
        before it."""
        if self._fire_driver_site:
            # the driver-death site: raise mode propagates out of tick(),
            # the deterministic driver kill a journal restore replays
            faults.fire(SITE_SERVE_DRIVER)
        now = self.now()
        done: List[Completion] = []
        # queued requests past deadline never touch the card -- but a
        # re-admission waiting here already streamed tokens
        # (replay_tokens) and keeps them, and its first-token stamp
        for req in self.scheduler.expire(now):
            done.append(Completion(
                request_id=req.id, prompt=list(req.prompt),
                tokens=list(req.replay_tokens or []),
                finish_reason=FINISH_TIMEOUT,
                arrival_time=req.arrival_time,
                first_token_time=req.first_token_time,
                prefix_hit_tokens=req.prefix_hit_tokens,
                tenant=req.tenant, adapter=req.adapter))
        # sync driver: a prior tick's step failed at its host copy and
        # parked the handle in the engine's retry seat -- drain it before
        # anything that needs the synced frontier (deadline cancels,
        # admission), or the loop would wedge behind _require_synced
        if self.engine.retry_pending:
            try:
                # the retry branch syncs the parked dispatch without
                # enqueueing a new one
                done.extend(self.engine.step())
            except Exception:
                self._finalize(done)
                raise
        # in-flight requests past deadline free their slot mid-decode.
        # With a dispatch in flight, sync it FIRST: the stale host view
        # cannot tell a row the pending dispatch already retired from one
        # that really ran out of time
        if ((self._pending is not None
             or self._pending_front is not None) and any(
                r.deadline is not None and now >= r.deadline
                for r in self.engine.active_requests.values())):
            try:
                self._sync_pending(done)
            except Exception:
                self._finalize(done)
                raise
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
                tel = self._tel
                if tel is not None:
                    for req in admit:
                        tel.event("serve.admit", id=req.id,
                                  queue_wait=now - req.arrival_time,
                                  t=now)
                try:
                    # admission re-seats rows: a barrier, the pipeline
                    # drains
                    self._sync_pending(done)
                    done.extend(self.engine.prefill(admit))
                except Exception:
                    # a crashed dispatch must not strand the popped
                    # batch: a crash in the admission loop rolled its
                    # slots back (atomic), leaving the batch in neither
                    # snapshot_in_flight() nor the queue; a crash after
                    # admission leaves it in the engine, where the
                    # snapshot covers it. The expiry/cancel completions
                    # this tick already collected are committed before
                    # the unwind discards `done`
                    seated = {r.id
                              for r in self.engine.active_requests.values()}
                    self.scheduler.requeue_front(
                        [r for r in admit if r.id not in seated])
                    self._finalize(done)
                    raise
                self._ops += 1  # count the dispatch before stamping TTFT
                t_first = self.now()
                chunking = self.engine.chunk_pending_ids
                for req in admit:
                    # a chunk-routed request has no first token yet: its
                    # final chunk stamps it (_dispatch_chunk); a
                    # re-admission that already streamed keeps its stamp
                    if (req.id not in chunking
                            and req.first_token_time is None):
                        self._stamp_first_token(req, t_first)
            else:
                # every popped request was seed-deferred: advance the
                # engine anyway (the conflicting request may be chunking
                # with nothing decoding), under the same chunk/decode
                # alternation as any other dispatch
                action = self.scheduler.drain_action(self.engine)
        try:
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
        except Exception:
            # completions already collected this tick must not vanish
            # with the crash
            self._finalize(done)
            raise
        rebuilds = getattr(self.engine, "rebuilds", 0)
        if rebuilds != self._seen_rebuilds:
            # a recovery may drain chunk prefills internally (prefix
            # replay waves): a request it ACTIVATED got its first token
            # inside the recovery, where _dispatch_chunk never saw the
            # chunk_activated handoff -- stamp TTFT now. Requests the
            # recovery re-queued mid-chunk have no token yet
            self._seen_rebuilds = rebuilds
            t = self.now()
            chunking = self.engine.chunk_pending_ids
            for req in self.engine.active_requests.values():
                if req.first_token_time is None and req.id not in chunking:
                    self._stamp_first_token(req, t)
        self._finalize(done)
        journal = self._journal
        if journal is not None:
            # journal the synced frontier: snapshot_in_flight only ever
            # reports tokens past step_sync, so a restart replays exactly
            # what the driver had observed
            for req, toks in self.engine.snapshot_in_flight():
                journal.note_frontier(req.id, toks, req.first_token_time)
        return done

    def _finalize(self, done: List[Completion]) -> None:
        """Stamp finish times, record completions, journal the
        retirements and (armed) emit their telemetry. Runs on the normal
        tick exit AND on a crashed dispatch's unwind: completions
        collected earlier in the tick already left the scheduler and the
        engine, so dropping them with the stack would lose them."""
        t_done = self.now()
        for comp in done:
            comp.finish_time = t_done
            if comp.first_token_time is None and comp.tokens:
                # finished at its own prefill, before the stamping loop
                comp.first_token_time = t_done
            self.completions[comp.request_id] = comp
        journal = self._journal
        if journal is not None:
            # the exactly-once commit point: a durable retire record is
            # what stops a restore from re-emitting this request
            for comp in done:
                journal.retire(comp)
        tel = self._tel
        if tel is not None:
            self._record_retirements(tel, done)

    def _sync_handle(self, handle, done: List[Completion]) -> None:
        """``step_sync`` one handle into ``done``, plus (armed) record
        the enqueue->sync duration against each completion it retired
        (the ``serve.retire`` event's ``sync`` stamp)."""
        got = self.engine.step_sync(handle)
        if (got and self._tel is not None
                and handle.enqueued_tick is not None):
            dur = self.now() - handle.enqueued_tick
            if dur > 0:
                for comp in got:
                    self._sync_durs[comp.request_id] = dur
        done.extend(got)

    def _sync_front(self, done: List[Completion]) -> None:
        """Drain the parked older handle (two-live-handles crash seat),
        restoring it on failure so the resumed loop retries the same
        sync. A recovery inside this sync rebuilds the engine, so the
        younger outstanding handle is discarded."""
        if self._pending_front is None:
            return
        front, self._pending_front = self._pending_front, None
        before = getattr(self.engine, "rebuilds", 0)
        try:
            self._sync_handle(front, done)
        except Exception:
            self._pending_front = front
            raise
        if getattr(self.engine, "rebuilds", 0) != before \
                and self._pending is not None:
            self._discard(self._pending)
            self._pending = None

    def _sync_pending(self, done: List[Completion]) -> None:
        """Drain the pipeline: sync the outstanding dispatch(es, oldest
        first) into ``done``. The engine is then at its synced frontier
        and barrier dispatches may run."""
        self._sync_front(done)
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        try:
            self._sync_handle(pending, done)
        except Exception:
            # an unsupervised sync failure leaves the engine untouched
            # (step_sync reads everything before its commit point): keep
            # the handle so a resumed loop retries the same sync
            self._pending = pending
            raise

    def _step_pipelined(self, done: List[Completion]) -> None:
        """One async step tick: enqueue dispatch N+1 on the device carry,
        THEN sync dispatch N -- its retire loop and the completions'
        stamps run while N+1 computes. A supervised engine may recover
        inside the enqueue (rebuild + replay of the synced frontier);
        the outstanding handle then belongs to the dead engine and is
        discarded un-synced -- its tokens were regenerated by the
        replay."""
        eng = self.engine
        if self._pending_front is not None:
            # a prior tick's two-live-handles sync failure parked the
            # older handle: re-sync it (dispatch order) before enqueuing
            # a third dispatch
            self._sync_front(done)
        if eng.spec_needs_refill or eng.spec_sampled:
            # the refill reads the host's token streams, a sampled round
            # the step numbers: bring the frontier current first
            self._sync_pending(done)
        prev, self._pending = self._pending, None
        before = getattr(eng, "rebuilds", 0)
        try:
            self._pending = eng.step_enqueue()
        except Exception:
            # unsupervised enqueue crash: fault sites fire BEFORE the
            # dispatch launches, so the engine is untouched -- put the
            # outstanding handle back so it can still be drained
            self._pending = prev
            raise
        self._ops += 1  # one tick = one enqueued dispatch (tick clock)
        if self._tel is not None and self._pending is not None:
            # client-clock enqueue stamp, read by _sync_handle
            self._pending.enqueued_tick = self.now()
        if getattr(eng, "rebuilds", 0) != before:
            # dead engine's dispatch: discard, never sync
            if prev is not None:
                self._discard(prev)
            prev = None
            if self._pending is not None:
                # the recovery's sentinel: surface its completions NOW
                self._sync_pending(done)
        if prev is not None:
            before = getattr(eng, "rebuilds", 0)
            # unsupervised failure here is the two-live-handles case:
            # park prev in the front seat and fail loud -- a resumed loop
            # re-syncs prev in dispatch order
            try:
                self._sync_handle(prev, done)
            except Exception:
                self._pending_front = prev
                raise
            if getattr(eng, "rebuilds", 0) != before \
                    and self._pending is not None:
                # a recovery INSIDE the sync rebuilt the engine too: the
                # handle enqueued above belongs to the dead engine
                self._discard(self._pending)
                self._pending = None

    @property
    def dispatch_in_flight(self) -> bool:
        """True while an enqueued dispatch awaits its sync."""
        return self._pending is not None or self._pending_front is not None

    def _dispatch_chunk(self, done: List[Completion]) -> None:
        """One chunk dispatch, and the TTFT stamp of the request (if any)
        whose final chunk just activated its decode row."""
        done.extend(self.engine.prefill_chunk_step())
        self._ops += 1
        req = self.engine.chunk_activated
        if req is not None and req.first_token_time is None:
            self._stamp_first_token(req, self.now())

    def _record_retirements(self, tel, done: List[Completion]) -> None:
        """Armed bookkeeping for one tick: the ``serve.retire`` events and
        the request lifecycle metrics (TTFT / TPOT / latency histograms,
        per-tenant TTFT and SLO misses, queue and occupancy gauges), in
        the client's clock units."""
        m = tel.metrics
        for comp in done:
            retire: Dict[str, Any] = dict(
                id=comp.request_id, finish_reason=comp.finish_reason,
                tokens=len(comp.tokens), tenant=comp.tenant,
                t=comp.finish_time)
            sync_dur = self._sync_durs.pop(comp.request_id, None)
            if sync_dur:
                retire["sync"] = sync_dur
            tel.event("serve.retire", **retire)
            m.counter("serve_completions_total",
                      help="requests retired, any finish reason").inc()
            m.counter(f"serve_finish_{comp.finish_reason}_total",
                      help=f"requests retired with finish_reason="
                      f"{comp.finish_reason}").inc()
            m.counter("serve_tokens_total",
                      help="generated tokens across all requests"
                      ).inc(len(comp.tokens))
            if comp.latency is not None:
                m.histogram("serve_latency",
                            help="arrival -> completion (client clock "
                            "units)").observe(comp.latency)
            ttft = comp.time_to_first_token
            if self._tenancy is not None:
                if ttft is not None:
                    m.histogram(
                        f"serve_tenant_ttft_ms_{comp.tenant}",
                        help="arrival -> first token for this tenant "
                        "class (client clock units — ticks under the "
                        "tick clock)").observe(ttft)
                    slo = self._tenancy.classes[comp.tenant].ttft_slo
                    if slo is not None and ttft > slo:
                        m.counter(
                            f"serve_tenant_slo_miss_total_{comp.tenant}",
                            help="retirements whose TTFT exceeded this "
                            "tenant class's ttft_slo target").inc()
            if ttft is not None:
                m.histogram("serve_ttft",
                            help="arrival -> first token (client clock "
                            "units)").observe(ttft)
                if (len(comp.tokens) > 1
                        and comp.finish_time is not None):
                    m.histogram(
                        "serve_tpot",
                        help="per-token decode time after the first "
                        "(client clock units)").observe(
                        (comp.finish_time - comp.first_token_time)
                        / (len(comp.tokens) - 1))
        gp = self.gauge_prefix
        m.gauge(gp + "serve_queue_depth",
                help="requests waiting in the scheduler queue"
                ).set(len(self.scheduler))
        if self._tenancy is not None:
            for name, depth in self._tenancy.class_depths().items():
                m.gauge(
                    gp + f"serve_tenant_queue_depth_{name}",
                    help="requests waiting in this tenant class's queue"
                ).set(depth)
        m.gauge(gp + "serve_slot_occupancy",
                help="fraction of KV slots holding an in-flight request"
                ).set(self.engine.active_count / self.num_slots)
        pages_free = self.engine.free_pages
        if pages_free is not None:
            num_pages = self.engine.pool.num_pages
            m.gauge(gp + "serve_pages_free",
                    help="free KV pages in the paged arena"
                    ).set(pages_free)
            m.gauge(gp + "serve_page_occupancy",
                    help="fraction of arena pages held (slots + prefix "
                    "cache)").set(1.0 - pages_free / num_pages)

    def _engine_busy(self) -> bool:
        """Decode rows active, prompts streaming chunks, or a dispatch
        awaiting its sync."""
        return bool(self.engine.active_count or self.engine.chunk_pending
                    or self._pending is not None
                    or self._pending_front is not None)

    @property
    def busy(self) -> bool:
        """True while a tick would do real work: requests queued, rows
        decoding, prompts streaming chunks, or a dispatch awaiting its
        sync."""
        return bool(len(self.scheduler) or self._engine_busy())

    def load_stats(self) -> Dict[str, Any]:
        """One host-side occupancy snapshot: every signal the fleet
        router scores (:class:`~ray_lightning_tpu_torch.serve.fleet.Router`)
        in one dict of plain values."""
        sched = self.scheduler
        stats: Dict[str, Any] = {
            "queue_depth": len(sched),
            "oldest_age": sched.oldest_age(self.now()),
            "dispatch_in_flight": self.dispatch_in_flight,
            "ops": self._ops,
        }
        stats.update(self.engine.occupancy())
        if self._tenancy is not None:
            stats["class_depths"] = self._tenancy.class_depths()
            stats["class_oldest"] = self._tenancy.class_oldest(self.now())
        return stats

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
                except (QueueFull, ValueError) as exc:
                    rid = self._next_id
                    self._next_id += 1
                    self.completions[rid] = Completion(
                        request_id=rid,
                        prompt=[int(t) for t in kwargs.get("prompt", [])],
                        tokens=[], finish_reason=FINISH_REJECTED,
                        arrival_time=now, finish_time=now,
                        tenant=kwargs.get("tenant") or DEFAULT_TENANT,
                        adapter=kwargs.get("adapter"))
                    if self._tel is not None:
                        self._tel.event("serve.reject", id=rid,
                                        why=type(exc).__name__)
                        self._tel.metrics.counter(
                            "serve_rejected_total",
                            help="requests shed at admission").inc()
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
