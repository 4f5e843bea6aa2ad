"""Serve-replica worker: one ServeClient dispatch loop per OS process (counterpart of ``ray_lightning_tpu/launchers/serve_worker.py``).

The in-process :class:`~ray_lightning_tpu_torch.serve.fleet.ReplicaFleet`
interleaves every replica's dispatch turns on ONE driver thread and one
CUDA context. This module is the replica body of the **process backend**
(``ReplicaFleet(backend="process")``): the actor machinery the training
gangs use (:class:`~ray_lightning_tpu_torch.launchers.process_backend.
ProcessRay` spawned actors) hosts one
:class:`~ray_lightning_tpu_torch.serve.client.ServeClient` per process,
each driving its own dispatch loop, on its own host thread and in its own
CUDA context. A sticky CUDA error (an illegal address, a device-side
assert) poisons only the context of the process it happened in.

Control-message schema (worker -> driver, over the shared manager-hosted
out-queue; every message carries the replica id so all replicas share
one channel):

- ``(MSG_BATCH, replica_id, [msg, ...], generation)`` -- the only thing
  put on the queue: one per dispatch turn, batching everything below (a
  manager-queue put is a proxy round trip). The trailing generation id
  is the driver-death fence: a warm-restarted driver bumped it, so
  batches raced over from the dead driver's workers are refused
  (``journal.stale_dropped``).
- ``(MSG_COMPLETION, replica_id, Completion)`` -- a retired request.
- ``(MSG_PROGRESS, replica_id, {request_id: {"tokens": [...],
  "first_token_time": t | None}})`` -- cumulative emitted tokens of the
  in-flight requests whose streams advanced this turn: the driver-side
  failover ledger's feed. A kill -9 leaves no snapshot RPC to call, so
  the driver re-admits from the last flushed progress and the replay
  contract regenerates anything still unflushed.
- ``(MSG_STATUS, replica_id, stats_dict)`` -- the occupancy mirror the
  driver's router scores (:meth:`ServeClient.load_stats`).
- ``(MSG_EVENT, replica_id, site, payload)`` /
  ``(MSG_METRIC, replica_id, kind, name, help, op, value)`` -- obs
  forwarding: events and metric updates re-emitted verbatim into the
  driver's Telemetry by the fleet (per-replica gauges keep their
  ``replica<id>_`` prefix, stamped worker-side).
- ``(MSG_SPAN, replica_id, name, ts_us, dur_us, depth, args)`` -- one
  closed worker-side span on the shared fleet timeline (µs since the
  driver's epoch), shipped only when the driver armed telemetry at spawn
  (``forward_spans=True``); the driver imports it seat-tagged
  (``record_closed``). A dead replica's last flushed spans ride the
  death-surviving manager queue like everything else.
- ``(MSG_CRASH, replica_id, "ExcType: detail", implicated_ids)`` -- the
  dispatch loop raised; the engine state is unknown and the driver fails
  the replica over (``replica.error`` unless the process also died: the
  ``_dead`` latch is consulted first, see
  ``process_fleet._classify_failure``). ``implicated_ids`` is the
  engine-resident request-id set at crash time (``None`` if even that
  enumeration failed): the containment layer's exact implication set. A
  messageless death (kill -9) implicates every displaced request
  instead. The set is read from host-side state only, so a worker whose
  CUDA context a sticky error poisoned still names its resident rows.

Heartbeats do NOT ride the out-queue: the fleet clock rides the
dedicated heartbeat channel through the gang layer's
:class:`~ray_lightning_tpu_torch.reliability.gang.HeartbeatEmitter` --
``(replica_id, ops, worker_monotonic, generation)`` beats, re-stamped
with the driver's clock on receipt, as a training rank's are. Beats come
from the dispatch-loop thread itself (idle turns included), so a wedged
dispatch stops beating and the driver's
:class:`~ray_lightning_tpu_torch.reliability.gang.GangMonitor` declares
the replica hung in bounded time.

**Kernel launches** are counted per process (each wrapper's counter is a
module global), so the driver cannot see a worker's. :meth:`stop`'s
stats carry them: ``kernel_launches`` (K1 by query tokens a row, K5 and
K2's forward by route) and ``decode_steps`` (the engine's decode
dispatches' substeps), two fields the JAX worker does not have;
:meth:`ServeReplicaWorker.launch_counts`, an RPC the JAX worker does not
have either, reads the same two at any time.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_lightning_tpu_torch.reliability import log_suppressed

MSG_BATCH = "batch"
MSG_COMPLETION = "completion"
MSG_PROGRESS = "progress"
MSG_STATUS = "status"
MSG_EVENT = "event"
MSG_METRIC = "metric"
MSG_SPAN = "span"
MSG_CRASH = "crash"

#: env var stamped into every serve worker: which spawn seat this
#: process fills (per-seat device env hangs off it: on a multi-card
#: host, ``per_seat_env`` maps a seat to its ``CUDA_VISIBLE_DEVICES``)
SEAT_ENV_VAR = "TL_SERVE_SEAT"


class _FencedChannel:
    """Generation-stamped, bounded-put wrapper over a manager queue: the
    worker half of the driver-death fence.

    Every tuple put through it grows the worker's spawn-time
    **generation id** as its last element, so a restarted driver (which
    bumped the generation through the journal) can refuse messages that
    raced over from the dead driver's workers. Every put is **bounded**
    by a timeout derived from the orphan grace window: a dead manager's
    proxy raises promptly, but a full queue under a dying manager would
    block a bare ``put`` forever, and a worker wedged inside a queue op
    never reaches its pipe EOF. Failures never propagate into the
    dispatch loop (a dying channel must not crash a healthy replica);
    the wrapper tracks how long the channel has been dead instead and
    hard-exits the process once the silence outlives the grace window:
    the channel-silence leg of orphan self-reaping (the ppid watchdog in
    ``process_backend`` is the other leg)."""

    __slots__ = ("_q", "_gen", "_grace_s", "_timeout", "_first_fail")

    def __init__(self, queue: Any, generation: int,
                 grace_s: Optional[float] = None):
        self._q = queue
        self._gen = int(generation)
        self._grace_s = grace_s
        if grace_s is not None and grace_s > 0:
            self._timeout = max(0.05, min(1.0, grace_s / 4))
        else:
            self._timeout = 5.0
        self._first_fail: Optional[float] = None

    def put(self, item: tuple) -> None:
        try:
            self._q.put(tuple(item) + (self._gen,), True, self._timeout)
        except Exception as exc:  # noqa: BLE001 — worker must outlive the channel
            now = time.time()
            if self._first_fail is None:
                self._first_fail = now
            log_suppressed("serve_worker.channel", exc,
                           "queue put failed; message dropped")
            if (self._grace_s is not None
                    and now - self._first_fail >= self._grace_s
                    and os.environ.get("TL_WORKER_PROCESS")):
                # the driver (or its manager) has been unreachable for a
                # whole grace window: this worker is an orphan -- reap
                # ourselves rather than decode into the void forever
                os._exit(3)
        else:
            self._first_fail = None


class _ForwardMetric:
    """One buffered metric handle: ``inc``/``set``/``observe`` append a
    message to the worker's flush buffer instead of touching a local
    registry; the driver replays them into ITS registry, so counters
    aggregate across replicas and gauges keep their worker-stamped
    per-replica name prefix."""

    __slots__ = ("_buf", "_rid", "_kind", "_name", "_help")

    def __init__(self, buf: List, rid: int, kind: str, name: str,
                 help: Optional[str]):
        self._buf = buf
        self._rid = rid
        self._kind = kind
        self._name = name
        self._help = help

    def _push(self, op: str, value: float) -> None:
        self._buf.append((MSG_METRIC, self._rid, self._kind, self._name,
                          self._help, op, float(value)))

    def inc(self, value: float = 1.0) -> None:
        self._push("inc", value)

    def set(self, value: float) -> None:
        self._push("set", value)

    def observe(self, value: float) -> None:
        self._push("observe", value)


class _ForwardMetrics:
    """Duck-typed MetricsRegistry façade over the flush buffer."""

    def __init__(self, buf: List, rid: int):
        self._buf = buf
        self._rid = rid

    def counter(self, name: str, help: Optional[str] = None,
                **_kw: Any) -> _ForwardMetric:
        return _ForwardMetric(self._buf, self._rid, "counter", name, help)

    def gauge(self, name: str, help: Optional[str] = None,
              **_kw: Any) -> _ForwardMetric:
        return _ForwardMetric(self._buf, self._rid, "gauge", name, help)

    def histogram(self, name: str, help: Optional[str] = None,
                  **_kw: Any) -> _ForwardMetric:
        return _ForwardMetric(self._buf, self._rid, "histogram", name,
                              help)


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        return False


class _ForwardSpan:
    """One worker-side real span: measures ``[ts, ts+dur]`` on the
    shared fleet timeline (µs since the driver's epoch, the origin the
    worker's request stamps use) and appends the closed span as one
    ``MSG_SPAN`` message when it exits, so it rides the next turn's
    flush batch. Depth comes from the façade's own open-span counter
    (the dispatch loop is single-threaded, LIFO by construction)."""

    __slots__ = ("_tel", "_name", "_args", "_t0", "_depth")

    def __init__(self, tel: "_ForwardTelemetry", name: str,
                 args: Dict[str, Any]):
        self._tel = tel
        self._name = name
        self._args = args

    def __enter__(self) -> "_ForwardSpan":
        self._depth = self._tel._depth
        self._tel._depth += 1
        self._t0 = time.time()
        return self

    def __exit__(self, *exc_info) -> bool:
        t1 = time.time()
        tel = self._tel
        tel._depth -= 1
        tel._buf.append((MSG_SPAN, tel._rid, self._name,
                         (self._t0 - tel._epoch) * 1e6,
                         (t1 - self._t0) * 1e6, self._depth,
                         self._args))
        return False


class _ForwardTelemetry:
    """Telemetry façade handed to the worker's ServeClient: events and
    metric updates buffer locally and flush to the driver once per
    dispatch turn. Spans are real only when the driver armed telemetry
    at spawn (``forward_spans=True``); a disarmed fleet's workers keep
    the no-op span, the zero-cost contract."""

    def __init__(self, buf: List, rid: int, epoch: float = 0.0,
                 forward_spans: bool = False):
        self._buf = buf
        self.metrics = _ForwardMetrics(buf, rid)
        self._rid = rid
        self._epoch = epoch
        self._forward_spans = forward_spans
        self._depth = 0

    def event(self, site: str, /, **payload: Any) -> None:
        self._buf.append((MSG_EVENT, self._rid, site, payload))

    def span(self, name: str, **args: Any):
        if not self._forward_spans:
            return _NullSpan()
        return _ForwardSpan(self, name, args)

    def flush(self) -> None:
        pass


def _launch_counts() -> Dict[str, Dict]:
    """This process's kernel launches by wrapper: K1 by query tokens a
    row (T), K5 by route, K2's forward by route."""
    from ray_lightning_tpu_torch.models import paged_attention as pa
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    return {"paged_attention": pa.launches_by_t(),
            "quantized_matmul": qmm.route_launches(),
            "flash_fwd": cf.route_launches("flash_fwd")}


class ServeReplicaWorker:
    """Actor body of one process-backend serve replica.

    Constructed warm inside its spawned process (engine built on its
    device, weights and KV storage allocated, every kernel library that
    is already built loaded, drive loop parked), so a standby promotes
    by one :meth:`set_replica` RPC instead of a cold spawn. ``model``
    arrives as a module on the meta device (the engine reads only its
    config) and ``params`` as a state dict of host tensors, through the
    construct pickle; the engine puts them on ``engine_kwargs["device"]``
    (``None``: the card; ``"cpu"``: a test's CPU run), quantizing them
    when ``weight_dtype=`` is set, so every replica holds the same codes.

    RPC surface (served FIFO by the actor's pipe loop, which runs on
    another thread than the dispatch loop: every client touch is
    lock-guarded):

    - ``set_replica(replica_id)`` -- adopt a fleet seat: stamp the
      per-replica gauge prefix, arm the heartbeat emitter, start the
      dispatch loop. Returns the replica's static description
      (``max_replay_len``, tenancy arming) for the driver's mirror.
    - ``submit(request)`` -- admission. Returns a structured verdict
      dict instead of raising: admission-control exceptions
      (``QueueFull``/``ClassQueueFull``) carry occupancy context as
      keyword arguments that default exception pickling drops, so a
      raise would cross the pipe context-stripped. ``{"ok": True,
      "stats": ...}`` on admit (the stats ride back so the driver's
      router mirror is fresh the moment the submit resolves), ``{"ok":
      False, "kind": ..., "msg": ..., "ctx": {...}}`` on refusal.
    - ``inject(mode)`` -- test chaos: ``"stall"`` wedges the dispatch
      loop (it stops beating; the driver's silence verdict takes it
      out), ``"exit"`` hard-exits the process (``os._exit``, a kill -9
      from inside).
    - ``launch_counts()`` -- this process's kernel launches and decode
      steps so far (module docstring).
    - ``stop()`` -- graceful teardown: stop the loop, flush, release the
      engine. Returns the final stats, with this process's kernel
      launches (module docstring).
    """

    def __init__(self, model: Any, params: Any, engine_kwargs: Dict,
                 out_queue: Any, heartbeat_channel: Any,
                 epoch: float, poll_s: float = 0.002,
                 heartbeat_interval: float = 0.02,
                 fault_plan: Any = None,
                 forward_spans: bool = False,
                 generation: int = 0,
                 orphan_grace_s: Optional[float] = None):
        from ray_lightning_tpu_torch.serve.client import ServeClient
        if fault_plan is not None:
            # the driver's armed FaultPlan crosses the construct pickle
            # so worker-side engines fire the same sites; arming here is
            # per process, it cannot leak into other workers
            from ray_lightning_tpu_torch.reliability import faults
            faults.ensure_armed(fault_plan)
        # every channel put is generation-stamped and timeout-bounded: a
        # restarted driver refuses this worker's messages by generation,
        # and a dead manager cannot wedge the dispatch loop inside a put
        self._out = _FencedChannel(out_queue, generation,
                                   grace_s=orphan_grace_s)
        self._hb_channel = _FencedChannel(heartbeat_channel, generation,
                                          grace_s=orphan_grace_s)
        self._poll_s = float(poll_s)
        self._hb_interval = float(heartbeat_interval)
        self._lock = threading.Lock()
        # an RPC queues for the lock behind this turnstile, and the
        # dispatch loop passes through it before every turn: a waiting
        # RPC takes the lock between two turns. Without it the loop,
        # which re-takes the lock right after releasing it, starves a
        # submit until the replica goes idle (a busy replica admits
        # nothing, and a burst never builds a queue the router sees)
        self._turnstile = threading.Lock()
        self._id: Optional[int] = None
        self._buf: List = []
        # wall clock with the DRIVER's epoch: every replica (and the
        # driver) computes now() as time.time() - epoch, so deadlines,
        # arrival times and TTFT stamps mean the same thing fleet-wide
        self._tel = _ForwardTelemetry(self._buf, -1, epoch=epoch,
                                      forward_spans=forward_spans)
        self.client = ServeClient(model, params, clock=time.time,
                                  clock_epoch=epoch, telemetry=self._tel,
                                  **engine_kwargs)
        if self.client.engine.device.type == "cuda":
            # the first dispatch then finds every built kernel library in
            # this process's cache: a worker compiles nothing (the fleet
            # built what was missing before it spawned anyone)
            from ray_lightning_tpu_torch import _build
            _build.load_built()
        # worker ticks are serve.replica territory: only the DRIVER's
        # tick boundary fires serve.driver (a worker-side fire would be
        # misread by the fleet as a replica crash)
        self.client._fire_driver_site = False
        self._beat = None
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = False
        self._stall_flag = False
        self._crashed = False
        self._progress_sent: Dict[int, int] = {}

    @contextlib.contextmanager
    def _rpc_lock(self):
        with self._turnstile:
            self._lock.acquire()
        try:
            yield
        finally:
            self._lock.release()

    # ------------------------------------------------------------- RPCs
    def set_replica(self, replica_id: int) -> Dict[str, Any]:
        """Adopt a fleet seat and start dispatching. A worker serves
        exactly one seat for its whole life (seat churn is what standby
        promotion is for)."""
        from ray_lightning_tpu_torch.reliability.gang import HeartbeatEmitter
        if self._thread is not None:
            raise RuntimeError(
                f"worker already serving replica {self._id}")
        self._id = int(replica_id)
        self._tel._rid = self._id
        self._tel.metrics._rid = self._id
        self.client.gauge_prefix = f"replica{self._id}_"
        self._beat = HeartbeatEmitter(self._hb_channel, self._id,
                                      interval=self._hb_interval)
        self._thread = threading.Thread(target=self._drive_loop,
                                        name=f"tl-serve-replica-{self._id}",
                                        daemon=True)
        self._thread.start()
        sched = self.client.scheduler
        return {
            "replica_id": self._id,
            "max_replay_len": self.client.engine.max_replay_len,
            "tenancy": getattr(sched, "class_depths", None) is not None,
        }

    def submit(self, request: Any) -> Dict[str, Any]:
        from ray_lightning_tpu_torch.serve.scheduler import QueueFull
        with self._rpc_lock():
            try:
                self.client.submit_request(request)
            except QueueFull as exc:
                verdict = {
                    "ok": False, "kind": type(exc).__name__,
                    "msg": str(exc),
                    "ctx": {
                        k: v for k, v in vars(exc).items()
                        if not k.startswith("_")
                    },
                }
            else:
                verdict = {"ok": True, "stats": self.client.load_stats()}
            self._flush()
        return verdict

    def inject(self, mode: str) -> None:
        """Deterministic chaos for the process-fleet tests (a fault plan
        is armed per process, so a driver-side FaultPlan cannot reach a
        spawned replica's dispatch loop)."""
        if mode == "stall":
            self._stall_flag = True
        elif mode == "exit":
            os._exit(1)
        else:
            raise ValueError(f"unknown injection mode {mode!r}")

    def launch_counts(self) -> Dict[str, Any]:
        """This process's kernel launches so far and the engine's decode
        steps (module docstring): a caller subtracts a reading taken
        after a warm-up from :meth:`stop`'s to count one run's."""
        with self._rpc_lock():
            return {"kernel_launches": _launch_counts(),
                    "decode_steps": self.client.engine.decode_substeps}

    def stop(self) -> Dict[str, Any]:
        self._stop_flag = True
        thread = self._thread
        if thread is not None:
            thread.join(timeout=10)
        counts = self.launch_counts()
        with self._rpc_lock():
            stats = (self.client.load_stats()
                     if self._id is not None else {})
            stats.update(counts)
            self._flush()
            self.client.shutdown()
        return stats

    # ------------------------------------------------------- drive loop
    def _drive_loop(self) -> None:
        client = self.client
        while not self._stop_flag:
            if self._stall_flag:
                # injected wedge: no dispatch, no beat -- the driver's
                # silence verdict fails this replica over
                time.sleep(self._poll_s)  # tl-lint: allow-sleep — injected test wedge; beats stop by design
                continue
            worked = False
            with self._turnstile:
                pass    # behind any RPC already waiting for the lock
            with self._lock:
                try:
                    if client.busy:
                        done = client.tick()
                        worked = True
                        for comp in done:
                            self._buf.append(
                                (MSG_COMPLETION, self._id, comp))
                            self._progress_sent.pop(comp.request_id,
                                                    None)
                        self._collect_progress()
                        self._buf.append((MSG_STATUS, self._id,
                                          client.load_stats()))
                except Exception as exc:  # tl-lint: allow-broad-except — crash must cross to the driver as MSG_CRASH, not kill the thread silently
                    self._crashed = True
                    self._buf.append(
                        (MSG_CRASH, self._id,
                         f"{type(exc).__name__}: {exc}",
                         self._implicated()))
                    self._flush()
                    return  # engine state unknown: stop driving; the
                    #         driver kills this replica and replays
                self._flush()
            # the dispatch-loop thread itself beats: a wedged tick stops
            # the beats, which is the hang signal
            self._beat.beat(client.ops)
            if not worked:
                time.sleep(self._poll_s)  # tl-lint: allow-sleep — idle poll quantum of a wall-clock dispatch process
        # final flush: completions retired on the very last turn must
        # not die in the buffer
        with self._lock:
            self._flush()

    def _implicated(self) -> Optional[List[int]]:
        """Request ids in the engine when the dispatch loop crashed: the
        driver's exact-implication set (MSG_CRASH 4th field). A dispatch
        crash leaves every engine-resident request co-batched with the
        failure: active decode rows plus the chunked-prefill queue. Host
        state only, so a poisoned CUDA context still answers; an engine
        too broken to enumerate returns None and the driver implicates
        every displaced request."""
        try:
            eng = self.client.engine
            ids = {int(r.id) for r in eng.active_requests.values()}
            ids.update(int(st.request.id) for st in eng._chunk_queue)
            return sorted(ids)
        except Exception:  # tl-lint: allow-broad-except — best-effort enumeration of a crashed engine; must not mask the original crash
            return None

    def _collect_progress(self) -> None:
        """Ship cumulative emitted tokens for streams that advanced: the
        driver-side failover ledger's only feed."""
        entries = self.client.engine.snapshot_in_flight()
        progress: Dict[int, Dict[str, Any]] = {}
        for req, toks in entries:
            if len(toks) > self._progress_sent.get(req.id, 0):
                progress[req.id] = {
                    "tokens": list(toks),
                    "first_token_time": req.first_token_time,
                }
                self._progress_sent[req.id] = len(toks)
        if progress:
            self._buf.append((MSG_PROGRESS, self._id, progress))

    def _flush(self) -> None:
        """One queue put per dispatch turn. Never raises: a dying
        channel (driver mid-teardown) must not take the loop down."""
        if not self._buf:
            return
        batch, self._buf[:] = list(self._buf), []
        try:
            self._out.put((MSG_BATCH, self._id, batch))
        except Exception as exc:  # noqa: BLE001 — worker must outlive the channel
            log_suppressed("serve_worker.flush", exc,
                           "out-queue unavailable; batch dropped")


def default_worker_env(seat: int,
                       per_seat_env: Optional[Callable[[int],
                                                       Dict[str, str]]]
                       = None) -> Dict[str, str]:
    """Per-replica env for one spawn seat.

    Only the seat stamp: a worker drives the card by default, the port's
    device rule (the JAX package's default pins its workers to one CPU
    device instead). A test asks for the CPU through the engine's
    ``device="cpu"``. On a host with several cards, ``per_seat_env``
    maps seats onto cards (``lambda s: {"CUDA_VISIBLE_DEVICES":
    str(s)}``); without it every worker shares the first visible card.
    """
    env = {SEAT_ENV_VAR: str(seat)}
    if per_seat_env is not None:
        env.update(per_seat_env(seat))
    return env
