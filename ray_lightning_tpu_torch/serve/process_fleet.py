"""Process-backend replica fleet: one dispatch process per replica (counterpart of ``ray_lightning_tpu/serve/process_fleet.py``).

:class:`ProcessReplicaFleet` is what ``ReplicaFleet(backend="process")``
constructs: the in-process fleet's contract (``serve/fleet.py``: router
affinity, snapshot+replay failover, tenancy class preservation,
watchdog/hung-dispatch verdicts, standby promotion, autoscaling,
containment) re-seated on the actor machinery the training gangs use:

- every replica is a :class:`~ray_lightning_tpu_torch.launchers.
  serve_worker.ServeReplicaWorker` inside a spawned
  :class:`~ray_lightning_tpu_torch.launchers.process_backend.ProcessRay`
  actor, driving its OWN dispatch loop on its own host thread and in its
  own CUDA context (on the card by default; ``device="cpu"`` in the
  engine kwargs is a test's CPU run). A sticky CUDA error (an illegal
  address, a device-side assert) poisons one worker's context: that
  worker is killed, which frees its context and its memory, and its
  requests replay on the others;
- submits are RPCs returning structured verdicts; completions, token
  progress, occupancy mirrors and obs events flow back over ONE
  manager-hosted queue (it pickles by reference and **survives worker
  death**, so a kill -9's last flushed batch is still drainable);
- the fleet clock rides the heartbeat channel: workers beat
  ``(replica_id, ops, t)`` from their dispatch-loop thread through a
  dedicated queue, the driver re-stamps on receipt and runs the
  :class:`~ray_lightning_tpu_torch.reliability.gang.GangMonitor` silence
  arithmetic a training gang runs: a wedged dispatch loop stops beating
  and is failed over in bounded wall time;
- the router is the in-process :class:`~ray_lightning_tpu_torch.serve.
  fleet.Router`, unmodified: each seat exposes a duck-typed
  scheduler/engine mirror fed by per-turn status messages (and refreshed
  inside every submit verdict), so scoring reads the signals it would
  read off live objects.

**Failover** has no snapshot RPC to call (a kill -9 answers nothing), so
the driver keeps its own ledger: every admitted request's object plus
the cumulative tokens its replica last flushed. On a death verdict the
ledger entries re-admit to survivors with ``replay_tokens`` set to the
flushed stream; the replay contract (a sampled stream's seeds are a
function of the engine seed, the request seed and the step) regenerates
whatever was emitted but unflushed, so greedy AND sampled outputs stay
token-identical (an f32 contract: a replay writes the KV through the
prefill, the run it replaces through decode steps). Death classification
consults the process backend's ``_dead`` latch first
(:func:`~ray_lightning_tpu_torch.reliability.gang.actor_alive`): a
hard-killed replica is reported ``replica.dead`` even when the first
symptom was a failed submit RPC under load, never a dispatch error.

**Shipping the model.** The fleet ships a module on the meta device
(the engine reads only its config) and one host copy of the state dict,
taken once at construction; a CUDA tensor never crosses into a worker.
Every worker puts the same values on its device (and, with
``weight_dtype=``, quantizes them to the same codes), so a replay on a
sibling is token-identical. A state dict above the backend's
``INLINE_BYTES`` crosses through a temporary file. On the card the fleet
builds every kernel library that is missing before it spawns anyone, and
each worker loads them at construction: no worker runs ``nvcc``. The
workers fork from a fork server that imported torch and the serving
stack once (:data:`FORKSERVER_PRELOAD`): a worker starts in the time its
engine takes to build, not in the seconds a spawned interpreter spends
re-importing torch (the JAX fleet spawns).

Clock: wall seconds only (``clock=`` is rejected): the driver stamps
``epoch = time.time()`` at construction and every worker computes
``now() = time.time() - epoch``, so deadlines, arrival times and TTFT
stamps mean the same thing in every process (one host, one clock).
Autoscaler hysteresis counts **evaluations** (at most one per
``scale_eval_interval`` wall seconds), not ticks: the pump loop spins far
faster than the in-process fleet's dispatch rounds.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as _queue
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ray_lightning_tpu_torch.launchers.process_backend import ProcessRay
from ray_lightning_tpu_torch.reliability import faults, log_suppressed
from ray_lightning_tpu_torch.reliability.faults import SITE_SERVE_DRIVER
from ray_lightning_tpu_torch.serve.containment import SeatTable
from ray_lightning_tpu_torch.serve.fleet import (COUNTER_FAILOVERS,
                                                 COUNTER_SHED,
                                                 EVENT_DEGRADED,
                                                 EVENT_FAILOVER,
                                                 EVENT_PROBATION,
                                                 EVENT_PROBATION_CLEARED,
                                                 EVENT_QUARANTINE,
                                                 EVENT_REPLICA_DRAINING,
                                                 EVENT_REPLICA_PROMOTED,
                                                 EVENT_RESTORED,
                                                 EVENT_SCALE_IN,
                                                 EVENT_SCALE_OUT,
                                                 EVENT_SHED, FleetConfig,
                                                 FleetDegraded,
                                                 FleetSaturated,
                                                 GAUGE_QUARANTINED,
                                                 GAUGE_QUEUE_DEPTH,
                                                 GAUGE_REPLICAS_LIVE,
                                                 ReplicaFleet, Router,
                                                 RouterConfig)
from ray_lightning_tpu_torch.serve.journal import (COUNTER_JOURNAL_STALE,
                                                   EVENT_JOURNAL_STALE)
from ray_lightning_tpu_torch.serve.request import (Completion,
                                                   DEFAULT_TENANT,
                                                   FINISH_REJECTED,
                                                   FINISH_TIMEOUT, Request)
from ray_lightning_tpu_torch.serve.scheduler import QueueFull

__all__ = ["ProcessReplicaFleet"]

#: what the fork server imports once, before it forks any worker: the
#: main script (as spawn would import it into every worker), torch and
#: the serving stack, so a worker starts in milliseconds instead of
#: re-importing torch as a spawned interpreter does
FORKSERVER_PRELOAD = ["__main__", "ray_lightning_tpu_torch.serve.client",
                      "ray_lightning_tpu_torch.launchers.serve_worker"]


def start_fork_server() -> None:
    """Start the fork server the fleets' workers fork from, with
    :data:`FORKSERVER_PRELOAD`, unless it runs already (a script may call
    this early, so the server's imports overlap other work). It never
    touches CUDA, and it exits once this process and all it forked are
    gone."""
    import multiprocessing.forkserver as forkserver
    mp.get_context("forkserver").set_forkserver_preload(FORKSERVER_PRELOAD)
    forkserver.ensure_running()

#: process-backend death classification events.
#: ``replica.dead``: the worker PROCESS is gone (kill -9, OOM, exit) —
#: the ``_dead``-latch-first rule guarantees this verdict wins over a
#: concurrent RPC/dispatch error. ``replica.error``: the process is
#: alive but its dispatch loop crashed (MSG_CRASH). A live-but-silent
#: replica keeps the in-process fleet's hang verdict (``fleet.failover``
#: with ``dead=False``).
EVENT_REPLICA_DEAD = "replica.dead"
EVENT_REPLICA_ERROR = "replica.error"


def _classify_failure(actor: Any, crashed: bool) -> str:
    """``"dead"`` | ``"error"`` | ``"hung"`` for a failed replica.

    The ``_dead`` latch is consulted FIRST (via
    :func:`~ray_lightning_tpu_torch.reliability.gang.actor_alive`): the
    process backend's reader thread latches it on pipe EOF *before*
    failing any in-flight future, and ``Process.is_alive()`` can report
    a just-killed child as running in the teardown window — so under
    load a hard-killed replica's first symptom is often a dispatch
    error, and classifying on the symptom would report
    ``replica.error``. The gang layer's ``worker.dead`` rule, the same
    probe."""
    from ray_lightning_tpu_torch.reliability.gang import actor_alive
    if not actor_alive(actor):
        return "dead"
    return "error" if crashed else "hung"


class _MirrorPages:
    __slots__ = ("num_pages",)

    def __init__(self) -> None:
        self.num_pages = 1


class _MirrorEngine:
    """Engine occupancy mirror the unmodified Router scores: updated
    from MSG_STATUS payloads (and submit verdicts)."""

    __slots__ = ("active_count", "chunk_pending", "free_pages", "pool")

    def __init__(self) -> None:
        self.active_count = 0
        self.chunk_pending = 0
        self.free_pages: Optional[int] = None
        self.pool = _MirrorPages()


class _MirrorScheduler:
    """Scheduler depth mirror. ``class_depths()`` is always present and
    empty when the fleet is untenanted — ``Router.class_load`` then
    scores 0 for every request, byte-identical to the in-process
    untenanted order."""

    __slots__ = ("depth", "oldest", "_class_depths", "_class_oldest")

    def __init__(self) -> None:
        self.depth = 0
        self.oldest: Optional[float] = None
        self._class_depths: Dict[str, int] = {}
        self._class_oldest: Dict[str, float] = {}

    def __len__(self) -> int:
        return self.depth

    def oldest_age(self, now: float) -> Optional[float]:
        return self.oldest

    def class_depths(self) -> Dict[str, int]:
        return dict(self._class_depths)

    def class_oldest(self, now: float) -> Dict[str, float]:
        return dict(self._class_oldest)


class _ForkServerRay(ProcessRay):
    """The fleet's process backend: every worker and the queue manager
    fork from the fork server (:func:`start_fork_server`), never from
    this process (CUDA and threads), in the time their engine takes to
    build instead of a spawned interpreter's ~8 s of imports. A forked
    process's orphan guard watches the driver's pid, its parent being
    the server. The backend's other callers keep spawn: a forked process
    has the server's environment, not the driver's at the fork."""

    _start_method = "forkserver"


class _MirrorClient:
    __slots__ = ("scheduler", "engine", "dispatch_in_flight")

    def __init__(self) -> None:
        self.scheduler = _MirrorScheduler()
        self.engine = _MirrorEngine()
        self.dispatch_in_flight = False


class _ProcessReplica:
    """One process-backed replica seat: actor handle + routing mirror +
    carried watchdog beat state. Duck-compatible with the in-process
    ``_Replica`` everywhere the Router touches it (``.id``,
    ``.admitting``, ``.client.scheduler``, ``.client.engine``)."""

    __slots__ = ("id", "actor", "info", "client", "draining", "crashed",
                 "crash_msg", "crash_implicated", "last_beat", "last_step",
                 "beats")

    def __init__(self, replica_id: int, actor: Any, info: Dict[str, Any]):
        self.id = replica_id
        self.actor = actor
        self.info = dict(info)
        self.client = _MirrorClient()
        self.draining = False
        self.crashed = False
        self.crash_msg: Optional[str] = None
        #: request ids the dying worker reported as in its engine when
        #: the dispatch loop crashed (MSG_CRASH 4th field) — None when
        #: the crash predates the field or the process died messageless
        #: (kill -9), in which case implication falls back to ALL
        #: displaced (conservative; probation exonerates innocents)
        self.crash_implicated: Optional[List[int]] = None
        self.last_beat: Optional[float] = None
        self.last_step = -1
        self.beats = 0

    @property
    def admitting(self) -> bool:
        return not self.draining and not self.crashed

    @property
    def busy(self) -> bool:
        eng = self.client.engine
        return bool(self.client.scheduler.depth or eng.active_count
                    or eng.chunk_pending
                    or self.client.dispatch_in_flight)

    def apply_stats(self, stats: Dict[str, Any]) -> None:
        sched = self.client.scheduler
        eng = self.client.engine
        sched.depth = int(stats.get("queue_depth", 0))
        sched.oldest = stats.get("oldest_age")
        sched._class_depths = dict(stats.get("class_depths") or {})
        sched._class_oldest = dict(stats.get("class_oldest") or {})
        eng.active_count = int(stats.get("active", 0))
        eng.chunk_pending = int(stats.get("chunk_pending", 0))
        eng.free_pages = stats.get("free_pages")
        eng.pool.num_pages = int(stats.get("num_pages") or 1)
        self.client.dispatch_in_flight = bool(
            stats.get("dispatch_in_flight", False))


class _Tracked:
    """Driver-side ledger entry: the admitted request object plus the
    cumulative tokens its replica last flushed — everything failover
    needs when the replica can no longer answer a snapshot RPC."""

    __slots__ = ("req", "replica", "tokens")

    def __init__(self, req: Request, replica: int):
        self.req = req
        self.replica = replica
        self.tokens: List[int] = []


class ProcessReplicaFleet(ReplicaFleet):
    """N :class:`~ray_lightning_tpu_torch.serve.client.ServeClient` replicas,
    each in its own spawned worker process — the ``backend="process"``
    face of :class:`~ray_lightning_tpu_torch.serve.fleet.ReplicaFleet` (the
    switch in ``ReplicaFleet.__new__`` lands here; ``isinstance(fleet,
    ReplicaFleet)`` holds). Same public surface: ``submit`` /
    ``serve_trace`` / ``run_until_idle`` / ``tick`` / ``shutdown`` plus
    the reliability counters (``failovers``, ``readmitted``,
    ``readmit_failed``, ``scale_outs``, ``scale_ins``,
    ``poison_failed``, ``failover_s_total``, ``stale_dropped``). See the
    module docstring for the transport and failover design.

    ``ReplicaFleet(model, state_dict, backend="process", num_replicas=2,
    num_standby=1, page_size=16, page_native=True,
    attention_kernel="cuda", ...)`` serves on the card;
    ``device="cpu"`` among the engine kwargs serves on the CPU (the
    tests). Each worker runs torch with this process's
    ``torch.get_num_threads()``.

    Extra knobs over the in-process fleet: ``worker_env`` (static env
    for every replica process, merged over the seat stamp),
    ``per_seat_env`` (callable mapping a spawn seat to device-pinning
    env: how a host with several cards gives each replica its own),
    ``submit_timeout`` (seconds one admission RPC may take),
    ``scale_eval_interval`` (autoscaler evaluation cadence, wall
    seconds), ``orphan_grace_s`` (arm driver-death orphan reaping:
    workers that lose the driver self-terminate within this window, and
    every worker-side queue op is timeout-bounded by it — set it
    whenever a :class:`~ray_lightning_tpu_torch.serve.journal.Journal` is
    armed for warm restart). ``clock=`` is rejected: the process
    backend is wall-clock by construction (trace times and deadlines
    are in seconds).
    """

    def __init__(self, model, params, *, backend: str = "process",
                 num_replicas: int = 2, num_standby: int = 0,
                 fleet_config: Optional[FleetConfig] = None,
                 router_config: Optional[RouterConfig] = None,
                 telemetry: Any = None,
                 clock: Optional[Callable[[], float]] = None,
                 worker_env: Optional[Dict[str, str]] = None,
                 per_seat_env: Optional[Callable[[int], Dict[str, str]]]
                 = None,
                 submit_timeout: float = 60.0,
                 scale_eval_interval: float = 0.05,
                 journal: Any = None,
                 orphan_grace_s: Optional[float] = None,
                 **engine_kwargs: Any):
        if num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {num_replicas}")
        if num_standby < 0:
            raise ValueError(
                f"num_standby must be >= 0, got {num_standby}")
        if clock is not None:
            raise ValueError(
                "backend='process' is wall-clock only (workers stamp "
                "time.time() against the fleet's shared epoch) — drop "
                "clock= or use backend='inproc' for tick-clock traces")
        self.backend = "process"
        # ship what rebuilds the model (a meta module: the engine reads
        # its config only) and one host copy of the weights: every
        # worker puts (and, for quantized fleets, quantizes) the SAME
        # values, so failover replay across replicas stays exact, and no
        # CUDA tensor is ever pickled into a worker
        self._model = _shippable(model)
        self._params_host = _shippable(params)
        self._engine_kwargs = _shippable(dict(engine_kwargs))
        self._cfg = fleet_config or FleetConfig()
        self._tel = telemetry
        self._worker_env = dict(worker_env or {})
        self._per_seat_env = per_seat_env
        self._submit_timeout = float(submit_timeout)
        self.scale_eval_interval = float(scale_eval_interval)
        self._epoch = time.time()
        self._ticks = 0
        self._next_id = 0
        self._next_replica_id = 0
        self._next_seat = 0
        self.completions: Dict[int, Completion] = {}
        #: request id -> _Tracked for everything admitted somewhere and
        #: not yet retired — the failover ledger AND the busy probe
        self._inflight: Dict[int, _Tracked] = {}
        # driver-death survival: the journal records
        # admissions/frontiers/retirements; its generation is the
        # split-brain fence — stamped into every spawned worker's
        # messages and beats, and checked in both queue drains, so a
        # warm-restarted driver (generation+1) refuses anything raced
        # over from the dead driver's workers. journal=None keeps the
        # repo-wide zero-cost contract.
        self._journal = journal
        self._generation = (journal.generation
                            if journal is not None else 0)
        self._orphan_grace_s = (float(orphan_grace_s)
                                if orphan_grace_s is not None else None)
        self.stale_dropped = 0

        if _on_card(self._engine_kwargs.get("device")):
            # build what is missing (one nvcc per source, all started
            # together) before any worker exists: N workers never race
            # a cold build, and each loads the libraries at construction
            from ray_lightning_tpu_torch import _build
            _build.build(_build.SOURCES)

        start_fork_server()
        self._ray = _ForkServerRay(orphan_grace_s=self._orphan_grace_s,
                                   num_threads=torch.get_num_threads())
        self._ray.init()
        self._out = self._ray.make_queue()
        self._hb = self._ray.make_queue()

        rcfg = router_config or RouterConfig()
        affinity = rcfg.affinity_tokens
        if affinity is None:
            affinity = (engine_kwargs.get("prefill_chunk") or 0
                        if engine_kwargs.get("prefix_cache") else 0)
        self.router = Router(rcfg, affinity_tokens=affinity,
                             telemetry=telemetry)

        self._replicas: List[_ProcessReplica] = []
        self._shutdown_done = False
        try:
            for _ in range(num_replicas):
                self._activate(self._spawn_actor())
            if num_standby:
                from ray_lightning_tpu_torch.reliability.elastic import \
                    StandbyPool
                self.standby = StandbyPool(self._ray,
                                           num_standby=num_standby,
                                           warmup=None,
                                           telemetry=telemetry)
                self.standby.fill(self._spawn_actor)
            else:
                self.standby = None
        except BaseException:
            # a failed spawn mid-construction must not leak the ones
            # that already started (no fleet object = no shutdown())
            self._ray.shutdown()
            raise

        from ray_lightning_tpu_torch.reliability.gang import GangConfig
        grace = self._cfg.startup_grace
        if grace is None:
            # the in-process default (grace = timeout) assumes dispatch
            # turns are driver-ticked; a fresh PROCESS legitimately goes
            # quiet through its first dispatch (the CUDA modules load
            # lazily at first use)
            grace = max(self._cfg.heartbeat_timeout, 60.0)
        self._gang_cfg = GangConfig(
            heartbeat_timeout=self._cfg.heartbeat_timeout,
            startup_grace=grace, clock=self.now)
        self._monitor = None
        self._rebuild_monitor()

        self._pressure_ticks = 0
        self._idle_ticks = 0
        self._last_scale_eval = 0.0
        self._ttft_ewma: Optional[float] = None
        self._target_replicas = num_replicas

        #: replica id -> the stats its worker's graceful ``stop()``
        #: returned (scale-in and shutdown), with the worker process's
        #: kernel launches (``kernel_launches``, ``decode_steps``): the
        #: wrappers count per process, so only the worker can report
        #: what the card ran there. A replica that died reports nothing.
        self.final_stats: Dict[int, Dict[str, Any]] = {}
        self.failovers = 0
        self.readmitted = 0
        self.readmit_failed = 0
        self.scale_outs = 0
        self.scale_ins = 0
        self.failover_s_total = 0.0

        # failure containment (same inert-by-default contract as the
        # in-process fleet: nothing here changes a decision until
        # max_request_failovers / flap_window are set)
        self.poison_failed = 0
        self._parked: List[Request] = []
        self._probation: List[Request] = []
        self._probation_rep: Optional[int] = None
        self._probation_obj: Optional[Request] = None
        self._degraded = False
        self._seats: Optional[SeatTable] = None
        if self._cfg.flap_window is not None:
            from ray_lightning_tpu_torch.reliability.retry import RetryPolicy
            policy = self._cfg.quarantine_backoff or RetryPolicy(
                max_attempts=8, base_delay=1.0, max_delay=60.0,
                multiplier=2.0, jitter=0.1)
            self._seats = SeatTable(self._cfg.flap_window,
                                    self._cfg.flap_threshold, policy)
            for rep in self._replicas:
                self._seats.occupy(rep.id, self.now(), grow=True)

    # ------------------------------------------------------------ clock
    @property
    def ops(self) -> int:
        """Pump rounds so far (NOT dispatch turns — those happen in the
        worker processes; per-replica dispatch counts ride the
        heartbeats into ``replica_steps``)."""
        return self._ticks

    def now(self) -> float:
        return time.time() - self._epoch

    # --------------------------------------------------------- replicas
    @property
    def replicas_live(self) -> int:
        return len(self._replicas)

    @property
    def replica_ids(self) -> List[int]:
        return [rep.id for rep in self._replicas]

    @property
    def replica_steps(self) -> Dict[int, int]:
        """Per-replica dispatch-turn counts from the latest beats (each
        replica's utilization source)."""
        return {rep.id: rep.last_step for rep in self._replicas}

    @property
    def process_backend(self):
        """The owning :class:`ProcessRay` module (tests assert
        ``live_actor_count() == 0`` after :meth:`shutdown`)."""
        return self._ray

    def _spawn_actor(self) -> Any:
        from ray_lightning_tpu_torch.launchers.serve_worker import (
            ServeReplicaWorker, default_worker_env)
        seat = self._next_seat
        self._next_seat += 1
        env = default_worker_env(seat)
        env.update(self._worker_env)
        if self._per_seat_env is not None:
            env.update(self._per_seat_env(seat))
        if self._orphan_grace_s is not None:
            # arms the worker's ppid watchdog (process_backend): a
            # SIGKILLed driver's workers self-reap within the grace
            # window instead of decoding into the void forever
            from ray_lightning_tpu_torch.launchers.process_backend import \
                ORPHAN_GRACE_ENV
            env[ORPHAN_GRACE_ENV] = repr(self._orphan_grace_s)
        hb_interval = min(0.25, max(0.005,
                                    self._cfg.heartbeat_timeout / 8.0))
        # construct crosses a fresh interpreter (torch and the port's
        # import, the weights' copy, the engine build on the device);
        # the backend's 60 s default is tight on a loaded host
        return self._ray.remote(ServeReplicaWorker).options(
            worker_env=env, construct_timeout=300.0).remote(
            self._model, self._params_host, self._engine_kwargs,
            self._out, self._hb, self._epoch,
            heartbeat_interval=hb_interval,
            # ship the driver's armed fault plan (if any) so worker-side
            # engines fire the same sites: chaos drills (the poison
            # request among them) hold identically on this backend
            fault_plan=faults.get_armed(),
            # real worker-side spans (MSG_SPAN) only when the driver is
            # armed: a disarmed fleet's workers keep the no-op span
            forward_spans=self._tel is not None,
            # the split-brain fence stamp: every message/beat this
            # worker puts carries the spawning driver's generation
            generation=self._generation,
            orphan_grace_s=self._orphan_grace_s)

    def _activate(self, handle: Any) -> _ProcessReplica:
        rid = self._next_replica_id
        self._next_replica_id += 1
        info = self._ray.get(handle.set_replica.remote(rid), timeout=120)
        rep = _ProcessReplica(rid, handle, info)
        self._replicas.append(rep)
        return rep

    def _rebuild_monitor(self) -> None:
        """Same carried-beat contract as the in-process fleet: a
        rebuild must not reset a wedged replica's silence clock."""
        from ray_lightning_tpu_torch.reliability.gang import GangMonitor
        self._monitor = GangMonitor(len(self._replicas), self._gang_cfg)
        self._monitor.start()
        for idx, rep in enumerate(self._replicas):
            if rep.last_beat is not None:
                self._monitor.seed(idx, last_beat=rep.last_beat,
                                   last_step=rep.last_step,
                                   beats=rep.beats)

    # ------------------------------------------------------- submission
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0, top_k: Optional[int] = None,
               eos_id: Optional[int] = None, seed: Optional[int] = None,
               deadline: Optional[float] = None,
               tenant: Optional[str] = None,
               adapter: Optional[str] = None) -> int:
        """Route + enqueue one request; same contract as the in-process
        fleet (``ValueError`` for never-fits, :class:`FleetSaturated`
        when every replica refuses). ``adapter=`` rides the request
        across the transport — every worker's engine was built with the
        fleet's ``adapters=`` kwargs, so binding happens worker-side."""
        req = Request(id=self._next_id, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, eos_id=eos_id,
                      seed=seed, deadline=deadline,
                      tenant=tenant or DEFAULT_TENANT,
                      adapter=adapter)
        self._admit(req)
        self._next_id += 1
        return req.id

    # ---------------------------------------------------- hot adapters
    def load_adapter(self, name: str, adapter) -> Optional[str]:
        """Hot adapter churn needs a broadcast RPC the process
        transport does not carry yet — declare the resident set up
        front via ``adapters=`` (every worker engine builds with it),
        or use the in-process backend for hot load/unload."""
        raise NotImplementedError(
            "hot adapter load/unload is not supported on the process "
            "backend — pass the resident set via adapters= at fleet "
            "build, or use backend='inproc'")

    def unload_adapter(self, name: str) -> None:
        raise NotImplementedError(
            "hot adapter load/unload is not supported on the process "
            "backend — pass the resident set via adapters= at fleet "
            "build, or use backend='inproc'")

    def _admit(self, req: Request) -> _ProcessReplica:
        """Offer ``req`` down the router's preference order via submit
        RPCs. A refusal verdict sheds to the next candidate; a dead
        actor mid-RPC triggers its failover and the offer continues
        down the survivors."""
        if req.arrival_time is None:
            # stamped driver-side so the ledger copy used for failover
            # replay carries it; the worker's submit_request keeps an
            # existing stamp (the router-seat contract)
            req.arrival_time = self.now()
        ranked = self.router.order(self._replicas, req)
        if self._probation_rep is not None:
            # the probation replica is reserved for its solo suspect —
            # regular traffic routes around it until the run clears
            ranked = [r for r in ranked if r.id != self._probation_rep]
        affine_target = self.router.affine_target(req)
        for rep in ranked:
            if rep not in self._replicas:
                continue  # failed over by an earlier candidate's RPC
            load = self.router.load(rep)
            try:
                verdict = self._ray.get(
                    rep.actor.submit.remote(req),
                    timeout=self._submit_timeout)
            except ValueError:
                # engine.validate: the request can never fit any
                # replica's shapes (all engines are identical)
                raise
            except Exception as exc:  # noqa: BLE001 — an actor dying mid-RPC enters failover
                log_suppressed(
                    "fleet.submit", exc,
                    f"replica {rep.id} unreachable during admission; "
                    "failing it over and continuing down the order")
                for comp in self._fail_replica(rep):
                    self.completions[comp.request_id] = comp
                    if self._journal is not None:
                        self._journal.retire(comp)
                continue
            if not verdict["ok"]:
                continue  # QueueFull/ClassQueueFull: shed to the next
            rep.apply_stats(verdict["stats"])
            self.router.note_admission(
                rep, req, load=load,
                affine=(affine_target is not None
                        and rep.id == affine_target))
            self._inflight[req.id] = _Tracked(req, rep.id)
            if self._journal is not None:
                # journaled AFTER the seat is won (a fleet-wide refusal
                # never journals — rejected requests are not admissions)
                # and with replay_tokens as-fed: a failover re-admission
                # re-journals with its binding, resetting the reader's
                # frontier to the replayed prefix
                self._journal.admit(req)
            return rep
        now = self.now()
        total = sum(r.client.scheduler.depth for r in self._replicas)
        oldest = [r.client.scheduler.oldest for r in self._replicas]
        oldest = [a for a in oldest if a is not None]
        class_depths: Dict[str, int] = {}
        class_oldest: Dict[str, float] = {}
        for r in self._replicas:
            for name, depth in r.client.scheduler.class_depths().items():
                class_depths[name] = class_depths.get(name, 0) + depth
            for name, age in r.client.scheduler.class_oldest(now).items():
                class_oldest[name] = max(class_oldest.get(name, age), age)
        if self._degraded and self._seats is not None:
            raise FleetDegraded(
                "fleet degraded (quarantined seats below min_replicas); "
                "every survivor's admission control refused the request",
                quarantined=self._seats.gated(now),
                live=len(self._replicas),
                queue_depth=total,
                oldest_age=max(oldest) if oldest else None,
                replicas=len(ranked),
                class_depths=class_depths or None,
                class_oldest=class_oldest or None)
        raise FleetSaturated(
            "every replica's admission control refused the request",
            queue_depth=total, oldest_age=max(oldest) if oldest else None,
            replicas=len(ranked),
            class_depths=class_depths or None,
            class_oldest=class_oldest or None)

    # ------------------------------------------------------------- loop
    def tick(self) -> List[Completion]:
        """One pump round: drain worker messages + heartbeats, apply
        liveness and silence verdicts, restore capacity toward the
        target, run the (throttled) autoscaler. Non-blocking — workers
        dispatch continuously regardless; this only moves results and
        supervision forward. Returns completions recorded this round
        (failover casualties included)."""
        # the driver tick boundary — the serve.driver chaos site (a
        # raise here IS the driver death the warm-restart tests replay)
        faults.fire(SITE_SERVE_DRIVER)
        done: List[Completion] = []
        self._pump_parked(done)
        self._drain_messages(done)
        self._drain_beats()
        for rep in list(self._replicas):
            if rep.crashed or not _alive(rep.actor):
                done.extend(self._fail_replica(rep))
        # a failover can hold this thread for seconds (a cold build, a
        # standby refill, a slow admission RPC) while the survivors keep
        # beating into the channel; the rebuilt monitor carries their
        # beats from before it, so judge silence only on what has been
        # drained since (the JAX fleet checks right away and can fail a
        # healthy survivor over as hung)
        self._drain_beats()
        idx_map = dict(enumerate(self._replicas))
        for i in self._monitor.silent_ranks():
            rep = idx_map.get(i)
            if rep is not None and rep in self._replicas:
                done.extend(self._fail_replica(rep))
        if len(self._replicas) < self._target_replicas and (
                self._seats is None
                or self._seats.allow_build(self.now())):
            # quarantined seats gate this catch-up: a crash-looping
            # seat rebuilds on its backoff schedule, not every pump
            rep, source = self._adopt_standby_or_build(cold_ok=True)
            self._rebuild_monitor()
            if self._tel is not None and rep is not None:
                self._tel.event(EVENT_REPLICA_PROMOTED,
                                replica=rep.id, source=source,
                                replicas_live=len(self._replicas))
        if self._cfg.autoscale:
            self._autoscale()
        self._pump_probation(done)
        self._ticks += 1
        tel = self._tel
        if self._seats is not None:
            gated = self._seats.gated(self.now())
            deg = (gated > 0
                   and len(self._replicas) < self._cfg.min_replicas)
            if deg != self._degraded:
                self._degraded = deg
                if tel is not None:
                    tel.event(EVENT_DEGRADED if deg else EVENT_RESTORED,
                              quarantined=gated,
                              replicas_live=len(self._replicas))
            if tel is not None:
                tel.metrics.gauge(
                    GAUGE_QUARANTINED,
                    help="empty replica seats inside their quarantine "
                         "backoff window").set(gated)
        if tel is not None:
            tel.metrics.gauge(
                GAUGE_REPLICAS_LIVE,
                help="serving replicas currently live (draining "
                     "included)").set(len(self._replicas))
            tel.metrics.gauge(
                GAUGE_QUEUE_DEPTH,
                help="requests waiting across every replica's queue"
            ).set(sum(r.client.scheduler.depth for r in self._replicas))
        for comp in done:
            self.completions[comp.request_id] = comp
            if self._journal is not None:
                self._journal.retire(comp)
        return done

    # -------------------------------------------------- message pumping
    def _drain_messages(self, done: List[Completion]) -> None:
        from ray_lightning_tpu_torch.launchers.serve_worker import (
            MSG_COMPLETION, MSG_CRASH, MSG_EVENT, MSG_METRIC,
            MSG_PROGRESS, MSG_SPAN, MSG_STATUS)
        by_id = {rep.id: rep for rep in self._replicas}
        while True:
            try:
                item = self._out.get(block=False)
            except (_queue.Empty, EOFError, OSError):
                return
            if not (isinstance(item, tuple) and len(item) == 4):
                continue
            _kind, rid, batch, gen = item
            if gen != self._generation:
                # split-brain fence: a batch raced over from a dead
                # driver's worker (its generation predates our restart)
                self._note_stale(gen)
                continue
            rep = by_id.get(rid)
            for msg in batch:
                mk = msg[0]
                if mk == MSG_COMPLETION:
                    comp = msg[2]
                    self._inflight.pop(comp.request_id, None)
                    done.append(comp)
                    self._note_ttft(rid, comp)
                elif mk == MSG_PROGRESS:
                    for req_id, prog in msg[2].items():
                        t = self._inflight.get(req_id)
                        if t is not None and t.replica == rid:
                            t.tokens = list(prog["tokens"])
                            ft = prog.get("first_token_time")
                            if ft is not None:
                                # ride the ledger's request object: a
                                # re-admission must not restamp TTFT
                                t.req.first_token_time = ft
                            if self._journal is not None:
                                # the flushed stream IS this backend's
                                # synced frontier: exactly what failover
                                # (and warm restart) would replay
                                self._journal.note_frontier(
                                    req_id, t.tokens,
                                    t.req.first_token_time)
                elif mk == MSG_STATUS:
                    if rep is not None:
                        rep.apply_stats(msg[2])
                elif mk == MSG_EVENT:
                    if self._tel is not None:
                        self._tel.event(msg[2], **msg[3])
                elif mk == MSG_METRIC:
                    if self._tel is not None:
                        self._apply_metric(msg)
                elif mk == MSG_SPAN:
                    if self._tel is not None:
                        # a worker's closed span (fleet-timeline µs):
                        # import seat-tagged so the stitched Chrome
                        # trace puts each replica on its own pid track.
                        # A dead replica's last flushed spans land here
                        # too — _fail_replica drains before teardown.
                        _mk, srid, name, ts, dur, depth, args = msg
                        self._tel.spans.record_closed(
                            name, ts, dur, depth,
                            dict(args, seat=srid))
                elif mk == MSG_CRASH:
                    if rep is not None:
                        rep.crashed = True
                        rep.crash_msg = msg[2]
                        rep.crash_implicated = (
                            list(msg[3]) if len(msg) > 3 else None)

    def _apply_metric(self, msg: Tuple) -> None:
        _mk, _rid, kind, name, help_, op, value = msg
        m = self._tel.metrics
        handle = getattr(m, kind)(name, help=help_)
        getattr(handle, op)(value)

    def _drain_beats(self) -> None:
        """The fleet clock riding the heartbeat channel: fold worker
        beats into the gang monitor (driver-stamped, like a training
        rank's) and the replicas' carried beat state."""
        idx_of = {rep.id: i for i, rep in enumerate(self._replicas)}
        while True:
            try:
                item = self._hb.get(block=False)
            except (_queue.Empty, EOFError, OSError):
                return
            if not (isinstance(item, tuple) and len(item) == 4):
                continue
            rid, step, _worker_t, gen = item
            if gen != self._generation:
                self._note_stale(gen)
                continue
            i = idx_of.get(rid)
            if i is None:
                continue  # beat from a replica failed over mid-flight
            self._monitor.observe(i, int(step))
            rep = self._replicas[i]
            rep.last_beat = self.now()
            rep.last_step = max(rep.last_step, int(step))
            rep.beats += 1

    def _note_stale(self, gen: Any) -> None:
        """One fenced-off message: wrong-generation traffic from a dead
        driver's worker (or a malformed item). Counted, evented, and
        dropped — never folded into the ledger or the monitor."""
        self.stale_dropped += 1
        if self._tel is not None:
            self._tel.event(EVENT_JOURNAL_STALE, generation=gen,
                            expected=self._generation)
            self._tel.metrics.counter(
                COUNTER_JOURNAL_STALE,
                help="wrong-generation worker messages refused by the "
                     "driver's split-brain fence").inc()

    def _note_ttft(self, replica_id: int, comp: Completion) -> None:
        ttft = comp.time_to_first_token
        if ttft is not None:
            self.router.record_ttft(replica_id, ttft)
            a = self.router.config.ttft_alpha
            self._ttft_ewma = (ttft if self._ttft_ewma is None
                               else (1.0 - a) * self._ttft_ewma
                               + a * ttft)

    # --------------------------------------------------------- failover
    def _fail_replica(self, rep: _ProcessReplica) -> List[Completion]:
        """Tear down a dead/crashed/hung replica and re-admit its
        ledger entries to survivors via replay. The manager-hosted
        out-queue survives the death, so one final drain first harvests
        everything the worker managed to flush — completions recorded
        there never replay, and the freshest token progress tightens
        what does."""
        if rep not in self._replicas:
            return []
        t0 = time.perf_counter()
        self.failovers += 1
        done: List[Completion] = []
        self._drain_messages(done)
        self._drain_beats()
        verdict = _classify_failure(rep.actor, rep.crashed)
        tel = self._tel
        idx = self._replicas.index(rep)
        post = self._monitor.postmortems(
            silent=(idx,) if verdict == "hung" else (),
            dead=(idx,) if verdict != "hung" else ()).get(idx)
        displaced = sorted(
            (t for t in self._inflight.values() if t.replica == rep.id),
            key=lambda t: t.req.id)
        in_flight = sum(1 for t in displaced
                        if t.tokens or t.req.first_token_time is not None)
        # implication across the process boundary: an "error" verdict
        # ships the crashing engine's exact in-flight set (MSG_CRASH),
        # so only those ids are implicated. A messageless death
        # (kill -9 → "dead", wedge → "hung") names nobody — every
        # displaced request is implicated conservatively; probation
        # exonerates innocents (the implication-vs-proof caveat,
        # as in the in-process fleet).
        if verdict == "error" and rep.crash_implicated is not None:
            guilty = set(rep.crash_implicated)
            for t in displaced:
                if t.req.id in guilty:
                    t.req.crash_implications += 1
        else:
            for t in displaced:
                t.req.crash_implications += 1
        if self._probation_rep == rep.id:
            # the probation replica died — almost certainly the suspect
            # crashed it. Release the reservation; the suspect rides
            # the normal re-admission path below with its bumped count
            # (back to probation, or out at the budget).
            self._probation_rep = None
            self._probation_obj = None
        if tel is not None:
            if verdict == "dead":
                tel.event(EVENT_REPLICA_DEAD, replica=rep.id,
                          last_dispatch=(post.last_step if post else -1))
            elif verdict == "error":
                tel.event(EVENT_REPLICA_ERROR, replica=rep.id,
                          detail=rep.crash_msg)
            tel.event(EVENT_FAILOVER, replica=rep.id,
                      dead=(verdict != "hung"),
                      in_flight=in_flight,
                      queued=len(displaced) - in_flight,
                      chunking=rep.client.engine.chunk_pending,
                      last_dispatch=(post.last_step if post else -1),
                      beat_age=(round(post.last_beat_age_s, 3)
                                if post else None))
            tel.metrics.counter(
                COUNTER_FAILOVERS,
                help="replicas drained after death or hang").inc()
        try:
            self._ray.kill(rep.actor)
        except Exception as exc:  # noqa: BLE001 — teardown is best-effort
            log_suppressed("fleet.teardown", exc,
                           f"replica {rep.id} kill failed")
        self._replicas.remove(rep)
        self.router.forget(rep.id)
        if self._seats is not None:
            next_build = self._seats.record_death(rep.id, self.now())
            if next_build is not None and tel is not None:
                tel.event(EVENT_QUARANTINE, replica=rep.id,
                          next_build=round(next_build, 6))
        for t in displaced:
            self._inflight.pop(t.req.id, None)
        promoted_early = False
        if not self._replicas:
            self._promote()
            promoted_early = True
        for t in displaced:
            done.extend(self._readmit(t.req, t.tokens or None))
        if not promoted_early:
            self._promote()
        self._rebuild_monitor()
        self.failover_s_total += time.perf_counter() - t0
        return done

    def _readmit(self, req: Request,
                 toks: Optional[List[int]]) -> List[Completion]:
        """Replay re-admission across the process boundary: the
        ledger's request object (original arrival/deadline/first-token
        stamps, tenant class) re-feeds with ``replay_tokens`` set to
        the last flushed stream: the survivor's prefill resumes the
        sampled stream at the same step (its seeds are
        ``row_seed(engine seed, request seed, step)``).

        Containment semantics match the in-process fleet exactly:
        budget-spent requests retire ``failed``, twice-implicated ones
        queue for solo probation, transiently-refused ones park for
        bounded retry instead of insta-failing."""
        tel = self._tel
        if toks is not None:
            req.replay_tokens = list(toks)
            if tel is not None:
                tel.event("recovery.replay", id=req.id,
                          replayed_tokens=len(toks))
        budget = self._cfg.max_request_failovers
        if budget is not None and req.crash_implications >= budget:
            return self._retire_poison(req)
        if (budget is not None
                and req.crash_implications >= self._cfg.probation_after):
            self._probation.append(req)
            if tel is not None:
                tel.event(EVENT_PROBATION, id=req.id, phase="queued",
                          implications=req.crash_implications)
            return []
        fed = req.prompt_len + len(req.replay_tokens or ())
        survivors = self._replicas
        if survivors:
            if fed <= survivors[0].info["max_replay_len"]:
                try:
                    self._admit(req)
                except QueueFull as exc:
                    # FleetSaturated (the RPC admission path's refusal)
                    # subclasses QueueFull — transiently full, not
                    # unseatable: park for bounded re-admission
                    log_suppressed("fleet.readmit", exc,
                                   f"request {req.id} refused by every "
                                   "survivor; parked for retry")
                    self._park(req)
                    return []
                except ValueError as exc:
                    log_suppressed("fleet.readmit", exc,
                                   f"request {req.id} unseatable after "
                                   "failover; retiring as failed")
                else:
                    self._count_readmitted()
                    return []
        elif self._seats is not None:
            # degraded: no survivor YET, but quarantine backoff will
            # rebuild one — park rather than insta-fail (the fit check
            # happens against the rebuilt replica at pump time)
            self._park(req)
            return []
        return [self._fail_request(req)]

    def _pump_parked(self, done: List[Completion]) -> None:
        """Process-backend parked-retry pump: same contract as the
        in-process fleet (deadline expiries retire ``timeout``, fits
        re-admit through the router, still-full stays parked) with the
        fit check against the replica info dict and refusals arriving
        as :class:`FleetSaturated` from the RPC admission path."""
        if not self._parked:
            return
        still: List[Request] = []
        now = self.now()
        for req in self._parked:
            if req.deadline is not None and now >= req.deadline:
                comp = Completion(
                    request_id=req.id, prompt=list(req.prompt),
                    tokens=list(req.replay_tokens or []),
                    finish_reason=FINISH_TIMEOUT,
                    arrival_time=req.arrival_time,
                    first_token_time=req.first_token_time,
                    finish_time=now,
                    prefix_hit_tokens=req.prefix_hit_tokens,
                    tenant=req.tenant, adapter=req.adapter)
                self.completions[comp.request_id] = comp
                done.append(comp)
                continue
            survivors = self._replicas
            if not survivors:
                still.append(req)
                continue
            fed = req.prompt_len + len(req.replay_tokens or ())
            if fed > survivors[0].info["max_replay_len"]:
                done.append(self._fail_request(req))
                continue
            try:
                self._admit(req)
            except QueueFull:
                still.append(req)
            except ValueError as exc:
                log_suppressed("fleet.readmit", exc,
                               f"parked request {req.id} permanently "
                               "unseatable; retiring as failed")
                done.append(self._fail_request(req))
            else:
                self._count_readmitted()
        self._parked = still

    def _pump_probation(self, done: List[Completion]) -> None:
        """Process-backend probation lane: identical policy to the
        in-process fleet; the solo seat rides a submit RPC plus a
        ledger entry (the suspect must stay failover-tracked — its
        probation replica dying IS the strongest poison signal), and
        the reserved replica's idleness reads the mirror stats plus
        the driver ledger."""
        obj = self._probation_obj
        if obj is not None:
            comp = self.completions.get(obj.id)
            if comp is None:
                return  # suspect still running solo
            obj.crash_implications = 0
            rep_id, self._probation_rep = self._probation_rep, None
            self._probation_obj = None
            if self._tel is not None:
                self._tel.event(EVENT_PROBATION_CLEARED, id=obj.id,
                                replica=rep_id,
                                finish_reason=comp.finish_reason)
        if not self._probation:
            return
        if self._probation_rep is None:
            admitting = sorted(
                (r for r in self._replicas if r.admitting),
                key=lambda r: r.id)
            if not admitting:
                return
            if len(admitting) < 2 and self._target_replicas > 1:
                return  # a second replica is coming; keep traffic moving
            self._probation_rep = admitting[0].id
        rep = next((r for r in self._replicas
                    if r.id == self._probation_rep), None)
        if rep is None or not rep.admitting:
            self._probation_rep = None
            return
        if rep.busy or any(t.replica == rep.id
                           for t in self._inflight.values()):
            return  # let the reserved replica drain its regular work
        req = self._probation[0]
        fed = req.prompt_len + len(req.replay_tokens or ())
        if fed > rep.info["max_replay_len"]:
            self._probation.pop(0)
            done.append(self._fail_request(req))
            return
        try:
            verdict = self._ray.get(rep.actor.submit.remote(req),
                                    timeout=self._submit_timeout)
        except ValueError:
            self._probation.pop(0)
            done.append(self._fail_request(req))
            return
        except Exception as exc:  # noqa: BLE001 — a dying probation seat fails over on the next pump
            log_suppressed("fleet.probation", exc,
                           f"probation replica {rep.id} unreachable; "
                           "retrying the suspect next pump")
            return
        if not verdict["ok"]:
            return  # idle replica refused (quota edge); retry next pump
        rep.apply_stats(verdict["stats"])
        self._probation.pop(0)
        self._inflight[req.id] = _Tracked(req, rep.id)
        if self._journal is not None:
            # the probation seat is an admission too — a driver death
            # mid-probation must still replay the suspect
            self._journal.admit(req)
        self._probation_obj = req
        if self._tel is not None:
            self._tel.event(EVENT_PROBATION, id=req.id, phase="seated",
                            replica=rep.id,
                            implications=req.crash_implications)

    def _adopt_standby_or_build(self, *, cold_ok: bool,
                                grow: bool = False) \
            -> Tuple[Optional[_ProcessReplica], Optional[str]]:
        handle = self.standby.take() if self.standby is not None else None
        source = "standby" if handle is not None else None
        if handle is None:
            if not cold_ok:
                return None, None
            handle = self._spawn_actor()
            source = "cold"
        try:
            rep = self._activate(handle)
        except Exception as exc:  # noqa: BLE001 — a corpse standby must not wedge the promotion path
            log_suppressed("fleet.promote", exc,
                           "standby activation failed; cold-building")
            try:
                self._ray.kill(handle)
            except Exception as kill_exc:  # noqa: BLE001 — best-effort
                log_suppressed("fleet.teardown", kill_exc,
                               "could not kill failed standby")
            rep = self._activate(self._spawn_actor())
            source = "cold"
        if self._seats is not None:
            self._seats.occupy(rep.id, self.now(), grow=grow)
        if self.standby is not None:
            self.standby.refill_async(self._spawn_actor)
        return rep, source

    def _promote(self) -> None:
        if self._seats is not None and not self._seats.allow_build(
                self.now()):
            # every empty seat is quarantined: the failover path must
            # not hot-rebuild into a crash-looping seat — degraded
            # mode (shed + survivors) covers the gap until the
            # backoff elapses and the catch-up path rebuilds
            return
        rep, source = self._adopt_standby_or_build(
            cold_ok=len(self._replicas) < self._cfg.min_replicas)
        if rep is None:
            return
        if self._tel is not None:
            self._tel.event(EVENT_REPLICA_PROMOTED, replica=rep.id,
                            source=source,
                            replicas_live=len(self._replicas))

    # ------------------------------------------------------- autoscaler
    def _autoscale(self) -> None:
        """Same hysteresis policy as the in-process fleet, counted in
        **evaluations** throttled to one per ``scale_eval_interval``
        wall seconds (the pump spins far faster than a dispatch
        round would)."""
        now = self.now()
        if now - self._last_scale_eval < self.scale_eval_interval:
            self._drain_drained()
            return
        self._last_scale_eval = now
        cfg = self._cfg
        admitting = [r for r in self._replicas if r.admitting]
        total_q = sum(r.client.scheduler.depth for r in self._replicas)
        pressured = (
            total_q > cfg.scale_out_queue_depth * max(1, len(admitting))
            or (cfg.ttft_slo is not None and self._ttft_ewma is not None
                and self._ttft_ewma > cfg.ttft_slo))
        if pressured:
            self._pressure_ticks += 1
            self._idle_ticks = 0
        elif total_q == 0:
            self._idle_ticks += 1
            self._pressure_ticks = 0
        else:
            self._pressure_ticks = 0
            self._idle_ticks = 0
        if (self._pressure_ticks >= cfg.hysteresis
                and len(self._replicas) < cfg.max_replicas):
            self._scale_out()
            self._pressure_ticks = 0
        elif (self._idle_ticks >= cfg.hysteresis
                and len(admitting) > cfg.min_replicas):
            self._drain_one(admitting)
            self._idle_ticks = 0
        self._drain_drained()

    def _drain_drained(self) -> None:
        for rep in [r for r in self._replicas if r.draining]:
            if not rep.busy and not any(
                    t.replica == rep.id for t in self._inflight.values()):
                self._retire_replica(rep)

    def _scale_out(self) -> None:
        rep, source = self._adopt_standby_or_build(cold_ok=True,
                                                   grow=True)
        self.scale_outs += 1
        self._target_replicas = len(self._replicas)
        self._rebuild_monitor()
        if self._tel is not None:
            self._tel.event(EVENT_SCALE_OUT, replica=rep.id,
                            source=source,
                            replicas_live=len(self._replicas))

    def _drain_one(self, admitting: List[_ProcessReplica]) -> None:
        candidates = [r for r in admitting
                      if r.id != self._probation_rep] or admitting
        rep = max(candidates, key=lambda r: r.id)
        rep.draining = True
        if self._tel is not None:
            self._tel.event(EVENT_REPLICA_DRAINING, replica=rep.id,
                            in_flight=rep.client.engine.active_count,
                            queued=rep.client.scheduler.depth)

    def _retire_replica(self, rep: _ProcessReplica) -> None:
        """Scale-in completion: the drained worker stops gracefully
        (its engine releases device memory) before the actor dies."""
        try:
            self.final_stats[rep.id] = self._ray.get(
                rep.actor.stop.remote(), timeout=30)
        except Exception as exc:  # noqa: BLE001 — teardown is best-effort
            log_suppressed("fleet.teardown", exc,
                           f"replica {rep.id} graceful stop failed")
        try:
            self._ray.kill(rep.actor)
        except Exception as exc:  # noqa: BLE001 — teardown is best-effort
            log_suppressed("fleet.teardown", exc,
                           f"replica {rep.id} kill failed")
        self._replicas.remove(rep)
        self.router.forget(rep.id)
        if self._seats is not None:
            self._seats.vacate(rep.id)  # deliberate drain, not a death
        self.scale_ins += 1
        self._target_replicas = len(self._replicas)
        self._rebuild_monitor()
        if self._tel is not None:
            self._tel.event(EVENT_SCALE_IN, replica=rep.id,
                            replicas_live=len(self._replicas))

    # ---------------------------------------------------------- driving
    def _busy(self) -> bool:
        return (bool(self._inflight) or bool(self._parked)
                or bool(self._probation)
                or self._probation_obj is not None)

    def run_until_idle(self, max_ticks: int = 100_000) \
            -> Dict[int, Completion]:
        """Pump until every admitted request has retired somewhere."""
        ticks = 0
        while self._busy():
            got = self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"fleet loop did not drain in {max_ticks} pump "
                    f"rounds ({len(self._inflight)} requests still "
                    "tracked)")
            if not got and self._busy():
                time.sleep(0.002)  # tl-lint: allow-sleep — pump idle quantum; dispatch runs in the worker processes regardless
        return dict(self.completions)

    def serve_trace(self, trace: Sequence[Tuple[float, dict]],
                    max_ticks: int = 100_000) -> Dict[int, Completion]:
        """Replay a scripted arrival trace (times in WALL SECONDS from
        fleet construction — the process backend has no tick clock).
        Same shed contract as the in-process fleet: entries the whole
        fleet refuses retire as ``finish_reason="rejected"``."""
        tel = self._tel
        pending = sorted(trace, key=lambda item: item[0])
        idx = 0
        ticks = 0
        while idx < len(pending) or self._busy():
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
                        tenant=kwargs.get("tenant") or DEFAULT_TENANT)
                    if tel is not None:
                        tel.event(EVENT_SHED, id=rid,
                                  why=type(exc).__name__,
                                  context=str(exc))
                        tel.metrics.counter(
                            COUNTER_SHED,
                            help="requests shed fleet-wide at admission"
                        ).inc()
                idx += 1
            got = self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"fleet trace did not drain in {max_ticks} pump "
                    "rounds")
            if idx < len(pending) and not self._busy():
                # idle gap before the next arrival: yield the driver
                # core to the workers. No watchdog restamp needed —
                # process replicas beat through idle time on their own
                time.sleep(  # tl-lint: allow-sleep — wall-clock idle yield between trace arrivals
                    min(1e-3, max(0.0, pending[idx][0] - self.now())))
            elif not got and self._busy():
                time.sleep(0.002)  # tl-lint: allow-sleep — pump idle quantum; dispatch runs in the worker processes regardless
        return dict(self.completions)

    # ---------------------------------------------------------- teardown
    def shutdown(self) -> None:
        """Graceful worker stops, then the whole process backend (every
        actor process + the queue manager). Idempotent."""
        if self._shutdown_done:
            return
        self._shutdown_done = True
        for rep in self._replicas:
            try:
                self.final_stats[rep.id] = self._ray.get(
                    rep.actor.stop.remote(), timeout=15)
            except Exception as exc:  # noqa: BLE001 — teardown is best-effort
                log_suppressed("fleet.teardown", exc,
                               f"replica {rep.id} graceful stop failed")
        self._replicas = []
        if self.standby is not None:
            self.standby.shutdown()
        self.router.shutdown()
        self._monitor = None
        self._inflight.clear()
        journal = self._journal
        if journal is not None:
            self._journal = None
            journal.shutdown()
        self._ray.shutdown()
        self._out = None
        self._hb = None


def _alive(actor: Any) -> bool:
    from ray_lightning_tpu_torch.reliability.gang import actor_alive
    return actor_alive(actor)


def _on_card(device: Any) -> bool:
    """Whether the engines run on a CUDA device (``None`` is the card)."""
    return device is None or torch.device(device).type == "cuda"


def _shippable(obj: Any) -> Any:
    """``obj`` as it may cross the construct pickle: a module becomes a
    module of the same config on the meta device (the engine rebuilds
    from the config), a tensor a detached host copy, a device its name;
    dicts, lists and tuples are mapped through."""
    if isinstance(obj, torch.nn.Module):
        return type(obj)(obj.cfg, device="meta")
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, torch.device):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _shippable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_shippable(v) for v in obj)
    return obj
