"""Crash-recovering serving supervisor (counterpart of ``ray_lightning_tpu/reliability/supervisor.py``).

**ServeSupervisor** sits between :class:`ServeClient` and
:class:`ServeEngine` with the engine's exact interface (everything it
doesn't override is delegated to the live engine). On a dispatch crash
it rebuilds the engine from its constructor arguments and *re-admits
every in-flight request by replay*: each request's prompt +
already-emitted tokens go back through the batched prefill (or, on a
chunked engine, through chunk dispatches), which rebuilds the KV the
crashed engine held and samples the next token with the seed the
original stream would have used (``row_seed(engine seed, request seed,
step)`` at step ``len(replay_tokens)``). Greedy outputs are therefore
token-identical with and without faults, and sampled outputs are
replay-exact inside the port. A spec engine replays through the same
path, ``serve.verify`` crashes included: the engine discards the replay
prefill's own draw and the next spec round regenerates step ``k``
through the accept rule off the same seeds; the rebuilt engine's draft
rows refill because every replay activation marks its slot stale. After
the retry policy is exhausted the in-flight requests retire as
``finish_reason="failed"`` completions, and the client loop and the
waiting queue keep running.

What recovers in-process: a host exception at a dispatch (every fault
site fires on the host before the dispatch launches anything) and an
out-of-memory error. A sticky CUDA error (an illegal address, a device
assert) poisons the process's CUDA context, and no engine rebuilt in
that process can run; that case needs a fresh process (the process
fleet, ``ReplicaFleet(backend="process")``).

A rebuild releases the dead engine's device state (its
:meth:`~ray_lightning_tpu_torch.serve.engine.ServeEngine.shutdown`: the
KV arena, the draft's cache, the cached device inputs) and drops the
supervisor's reference to it before the new engine allocates, so the
card never holds two engines. With ``weight_dtype=`` the new engine
quantizes again from the caller's f32 ``params``, to the same codes.

**FitSupervisor** runs ``Trainer.fit`` to completion under a retry
policy: a fresh trainer and a fresh module per attempt, every attempt
resuming with ``ckpt_path="auto"`` from the newest checkpoint the failed
one committed. :class:`~ray_lightning_tpu_torch.reliability.gang.
GangSupervisor` extends it to a distributed fit.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.reliability import log_suppressed, logger
from ray_lightning_tpu_torch.reliability.retry import (RetriesExhausted,
                                                       RetryPolicy,
                                                       call_with_retry)
from ray_lightning_tpu_torch.serve.request import (Completion, FINISH_FAILED,
                                                   Request)


def failed_completion(req: Request, tokens) -> Completion:
    """The FINISH_FAILED retirement every recovery dead-end shares
    (retries exhausted, unreplayable entry, shed replay wave): partial
    tokens kept, timing carried over."""
    return Completion(
        request_id=req.id, prompt=list(req.prompt), tokens=list(tokens),
        finish_reason=FINISH_FAILED, arrival_time=req.arrival_time,
        first_token_time=req.first_token_time,
        prefix_hit_tokens=req.prefix_hit_tokens,
        tenant=req.tenant, adapter=req.adapter)


class _RecoveredDispatch:
    """Sentinel a crashed ``step_enqueue``/``step_sync`` returns in
    place of a live :class:`~ray_lightning_tpu_torch.serve.engine.
    PendingDispatch`: the recovery already rebuilt the engine and
    replayed the SYNCED frontier, so there is nothing left to sync --
    ``step_sync`` on this handle just surfaces the recovery's
    completions. The async client detects the rebuild (``rebuilds``
    bumped) and discards any OLDER outstanding handle without syncing
    it: the in-flight dispatch's tokens were regenerated by replay and
    must never commit twice."""

    __slots__ = ("done", "enqueued_tick")

    def __init__(self, done: List[Completion]):
        self.done = done
        self.enqueued_tick = None


class ServeSupervisor:
    """Engine proxy: same dispatch surface, plus rebuild-and-replay.

    ``ServeSupervisor(model, params, policy=RetryPolicy(...),
    **engine_kwargs)`` -- or let :class:`ServeClient` build one by
    passing ``retry_policy=``. Attribute access falls through to the
    live engine, so scheduler probes (``free_slots``,
    ``decode_substeps``, ...) keep working; engine counters reset when a
    crash forces a rebuild -- use the supervisor's own ``rebuilds`` /
    ``recoveries`` / ``failed_requests`` / ``recovery_s_total`` for
    reliability accounting.
    """

    def __init__(self, model, params, *,
                 policy: Optional[RetryPolicy] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 **engine_kwargs: Any):
        from ray_lightning_tpu_torch.serve.engine import ServeEngine
        self._engine_cls = ServeEngine
        self.policy = policy or RetryPolicy()
        self._model = model
        self._params = params
        self._engine_kwargs = dict(engine_kwargs)
        self._sleep = sleep
        self.engine = ServeEngine(model, params, **engine_kwargs)
        # the same handle the engine got (rebuilt engines inherit it via
        # engine_kwargs); None = disarmed, nothing below allocates
        self._tel = self._engine_kwargs.get("telemetry")
        self.rebuilds = 0
        self.recoveries = 0
        self.failed_requests = 0
        self.recovery_s_total = 0.0

    def __getattr__(self, name: str) -> Any:
        # only reached for names not set on the supervisor itself
        return getattr(self.engine, name)

    # ------------------------------------------------------- dispatches
    def prefill(self, requests: List[Request]) -> List[Completion]:
        return self._dispatch("prefill", requests)

    def step(self) -> List[Completion]:
        return self._dispatch("step")

    def prefill_chunk_step(self) -> List[Completion]:
        # a crash mid-chunk enters the same rebuild-and-replay path (the
        # half-prefilled prompt is in snapshot_in_flight with its replay
        # tokens, or none, and re-feeds from its start)
        return self._dispatch("chunk")

    # ------------------------------------------------------ hot adapters
    def load_adapter(self, name: str, adapter) -> Optional[str]:
        """Forward a hot adapter load to the live engine AND mirror it
        into the rebuild kwargs: a rebuilt engine holds the same
        resident *names* (replay re-binds by name at admission, so bank
        indices are free to differ). The evicted name (if any) is
        dropped for the same reason."""
        evicted = self.engine.load_adapter(name, adapter)
        resident = dict(self._engine_kwargs.get("adapters") or {})
        if evicted is not None:
            resident.pop(evicted, None)
        resident[name] = adapter
        self._engine_kwargs["adapters"] = resident
        return evicted

    def unload_adapter(self, name: str) -> None:
        """Forward a hot unload and drop the name from the rebuild
        kwargs (a rebuilt engine must not resurrect it)."""
        self.engine.unload_adapter(name)
        resident = dict(self._engine_kwargs.get("adapters") or {})
        resident.pop(name, None)
        self._engine_kwargs["adapters"] = resident

    # ---------------------------------------------- async dispatch seat
    def step_enqueue(self):
        """Async seat of :meth:`step`: a crash at enqueue (fault sites
        fire host-side, before the dispatch launches) recovers exactly
        like a sync crash -- rebuild + replay of the SYNCED frontier;
        the pending dispatch the caller may still hold belongs to the
        dead engine and is discarded, its tokens regenerated by the
        replay. Returns a live ``PendingDispatch`` (or ``None``) on the
        happy path, a :class:`_RecoveredDispatch` carrying the
        recovery's completions after a crash."""
        try:
            return self.engine.step_enqueue()
        except Exception as exc:  # noqa: BLE001 — routed to recovery
            log_suppressed("serve.dispatch", exc,
                           "step_enqueue crashed; entering recovery")
        # recovery runs after the except block: the exception's traceback
        # (whose frames hold the dead engine) is gone before the rebuild
        return _RecoveredDispatch(
            self._recover(self.engine.snapshot_in_flight()))

    def step_sync(self, pending) -> List[Completion]:
        if isinstance(pending, _RecoveredDispatch):
            return pending.done
        try:
            return self.engine.step_sync(pending)
        except Exception as exc:  # noqa: BLE001 — routed to recovery
            # a sync crash lands before the retire loop committed
            # anything: the snapshot below is still the pre-dispatch
            # truth and the pending dispatch is discarded with the dead
            # engine
            log_suppressed("serve.dispatch", exc,
                           "step_sync crashed; entering recovery")
        return self._recover(self.engine.snapshot_in_flight())

    def _dispatch(self, op: str,
                  requests: Sequence[Request] = ()) -> List[Completion]:
        from ray_lightning_tpu_torch.serve.engine import SlotPoolFull
        try:
            if op == "prefill":
                return self.engine.prefill(list(requests))
            if op == "chunk":
                return self.engine.prefill_chunk_step()
            return self.engine.step()
        except (SlotPoolFull, ValueError):
            # admission-contract errors (pool full, seed collision, shape
            # that can never fit): the caller's scheduler handles these --
            # they are refusals, not crashes
            raise
        except Exception as exc:  # noqa: BLE001 — routed to recovery
            log_suppressed("serve.dispatch", exc,
                           f"{op} crashed; entering recovery")
        # reached only after a crash, outside the except block (its
        # traceback holds the dead engine's frames). Snapshot only now --
        # the crash-free hot path never pays the per-dispatch token copy.
        # A failed dispatch records no tokens, so the snapshot is the
        # pre-dispatch truth; a crashed prefill may have already acquired
        # slots for the incoming batch (tokens: none), so dedupe by
        # request id before adding the batch with an empty replay.
        snapshot = self.engine.snapshot_in_flight()
        seen = {req.id for req, _toks in snapshot}
        entries = snapshot + [(req, []) for req in requests
                              if req.id not in seen]
        return self._recover(entries)

    # ---------------------------------------------------------- recovery
    def _recover(self, entries: List[Tuple[Request, List[int]]]
                 ) -> List[Completion]:
        """Rebuild + replay under the policy (attempt count AND deadline
        both honored via call_with_retry); fail the batch after it."""
        t0 = time.perf_counter()
        self.recoveries += 1
        # engine-level crashes implicate their co-batched requests too
        # (one bump per recovery episode, not per retry attempt)
        for req, _toks in entries:
            req.crash_implications += 1
        try:
            done = call_with_retry(
                lambda attempt: self._rebuild_and_replay(entries),
                self.policy, site="serve.recovery", sleep=self._sleep)
            # failed completions produced by a SUCCESSFUL replay pass
            # (unreplayable prompt+emitted overflow) count exactly once
            self.failed_requests += sum(
                1 for c in done if c.finish_reason == FINISH_FAILED)
            self.recovery_s_total += time.perf_counter() - t0
            return done
        except RetriesExhausted as exc:
            # exhausted: a clean empty engine, and every entry retires
            # as a "failed" completion carrying the tokens it did
            # produce -- the client loop and queued requests continue
            logger.error(
                "serve recovery exhausted (%s); retiring %d request(s) "
                "as failed", exc, len(entries))
            if self._tel is not None:
                self._tel.event("recovery.exhausted",
                                failed=len(entries),
                                attempts=exc.attempts)
            self._new_engine()
            self.rebuilds += 1
            if self._tel is not None:
                # the clean-slate rebuild is a rebuild too: keep the
                # event log and reliability_rebuilds_total in lockstep
                # with the supervisor's own `rebuilds` counter
                self._tel.event("engine.rebuild", rebuilds=self.rebuilds,
                                in_flight=0)
                self._tel.metrics.counter(
                    "reliability_rebuilds_total",
                    help="serve engines rebuilt after a dispatch crash"
                ).inc()
            self.failed_requests += len(entries)
            self.recovery_s_total += time.perf_counter() - t0
            return [failed_completion(req, toks)
                    for req, toks in entries]

    def _new_engine(self) -> None:
        """Replace the live engine by a fresh one: the dead engine's
        device state is released and its last reference dropped BEFORE
        the new engine allocates (the card never holds two engines)."""
        dead, self.engine = self.engine, None
        if dead is not None:
            dead.shutdown()
            del dead
        self.engine = self._engine_cls(self._model, self._params,
                                       **self._engine_kwargs)

    def _rebuild_and_replay(self, entries: List[Tuple[Request, List[int]]]
                            ) -> List[Completion]:
        from ray_lightning_tpu_torch.serve.engine import SlotPoolFull
        self._new_engine()
        self.rebuilds += 1
        tel = self._tel
        if tel is not None:
            tel.event("engine.rebuild", rebuilds=self.rebuilds,
                      in_flight=len(entries))
            tel.metrics.counter(
                "reliability_rebuilds_total",
                help="serve engines rebuilt after a dispatch crash").inc()
            for req, toks in entries:
                tel.event("recovery.replay", id=req.id,
                          replayed_tokens=len(toks))
        done: List[Completion] = []
        pending: List[Request] = []
        for req, toks in entries:
            if req.prompt_len + len(toks) > self.engine.max_replay_len:
                # prompt + emitted no longer fits the engine's replay
                # path -- one prefill pass without chunking, the whole
                # sequence axis with it; counted by _recover iff this
                # attempt commits
                done.append(failed_completion(req, toks))
                continue
            req.replay_tokens = list(toks)
            pending.append(req)
        # prefix-sharing engines replay ONE request per wave, draining
        # its chunk prefill before the next admits: each completed
        # replay republishes its prompt-prefix pages so the next wave
        # adopts them as the dead engine's tenants did -- an all-at-once
        # admission would demand every request's FULL page count and
        # could overflow an arena the snapshot only fit by sharing.
        # (Without a prefix cache the snapshot's page/slot demand is its
        # pre-crash demand, so batch waves fit, and their chunk queues
        # are deliberately NOT drained here: the driving loop's
        # chunk/decode alternation resumes them.)
        prefix_replay = self.engine.prefix is not None
        step = 1 if prefix_replay else self.engine.prefill_batch
        for i in range(0, len(pending), step):
            wave = pending[i:i + step]
            try:
                done.extend(self.engine.prefill(wave))
            except SlotPoolFull:
                # genuinely unseatable on the fresh engine (the dead
                # engine's co-residency leaned on cache-held pages a
                # drained replay cannot reconstruct): shed THIS wave,
                # keep replaying the rest instead of exhausting retries
                # on a deterministic refusal
                done.extend(failed_completion(req, req.replay_tokens or ())
                            for req in wave)
                continue
            while prefix_replay and self.engine.chunk_pending:
                done.extend(self.engine.prefill_chunk_step())
        return done


class FitSupervisor:
    """Run ``Trainer.fit`` to completion under a retry policy.

    ``make_trainer`` builds a *fresh* trainer per attempt (never reuse a
    crashed one — its device state may be poisoned); ``module`` may be an
    instance or a zero-arg factory. The same poisoning argument applies
    to the module itself: a crashed attempt may leave mutated state
    behind, so each attempt fits a **deep copy** of the caller's
    instance (the original is never attached or mutated). A module that
    cannot be deep-copied is reused with a one-time logged warning —
    pass a zero-arg factory for the guaranteed-clean spelling. Every attempt
    fits with ``ckpt_path="auto"``, so attempt N+1 resumes from the
    newest valid checkpoint attempt N managed to commit. Raises
    :class:`RetriesExhausted` when the policy runs out.
    """

    def __init__(self, make_trainer: Callable[[], Any],
                 policy: Optional[RetryPolicy] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.make_trainer = make_trainer
        self.policy = policy or RetryPolicy()
        self._sleep = sleep
        self.attempts = 0

    def fit(self, module: Any, datamodule: Any = None):
        """Returns the trainer whose fit completed."""
        import copy

        warned = False

        def fresh_module():
            # every attempt fits a deep copy of the caller's instance:
            # the original is never attached/mutated, so attempt-1 state
            # can't leak into attempt 2 (factories are simply called)
            nonlocal warned
            if callable(module):
                return module()
            try:
                return copy.deepcopy(module)
            except Exception as exc:  # noqa: BLE001 — degraded, logged
                if not warned:
                    warned = True
                    log_suppressed(
                        "supervisor.module_copy", exc,
                        "module instance is not deep-copyable; attempts "
                        "will reuse it as-is (a crashed attempt may leave "
                        "poisoned state) — pass a zero-arg module factory "
                        "for guaranteed-clean attempts")
                return module

        def attempt(i: int):
            self.attempts = i
            if i > 1:
                self._on_retry(i)
            trainer = self._prepare_trainer(self.make_trainer())
            try:
                trainer.fit(fresh_module(), datamodule=datamodule,
                            ckpt_path="auto")
            except BaseException as exc:
                self._record_failure(exc)
                raise
            return trainer
        return call_with_retry(attempt, self.policy, site="trainer.fit",
                               sleep=self._sleep)

    # subclass hooks (GangSupervisor) ------------------------------------
    def _prepare_trainer(self, trainer: Any) -> Any:
        """Adjust each attempt's freshly built trainer before it fits
        (GangSupervisor's elastic world-size seat). Default: identity."""
        return trainer

    def _on_retry(self, attempt: int) -> None:
        """Called before each retry attempt (attempt >= 2) starts."""

    def _record_failure(self, exc: BaseException) -> None:
        """Called with each failed attempt's exception before re-raise."""
