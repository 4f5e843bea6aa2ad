"""Replica-fleet serving: supervised engine replicas behind a router (counterpart of ``ray_lightning_tpu/serve/fleet.py``).

One :class:`~ray_lightning_tpu_torch.serve.client.ServeClient` caps
throughput at one engine's KV slots, and a replica whose dispatch dies
takes its in-flight requests with it. The fleet puts several replicas
behind a router and supervises them, built from the port's own pieces:

- **Replicas**: ``num_replicas`` engine and scheduler loops (each a
  :class:`ServeClient`) on ONE fleet clock (``clock_epoch=0.0``), so
  deadlines, arrival times and TTFT stamps mean the same on every
  replica and keep meaning it when a request moves. Every replica has
  the same engine ``seed``: a sampled stream's seeds are
  ``row_seed(engine seed, request seed, step)``, a function of no
  replica state, which makes failover replay exact.
- **Router**: admission picks the admitting replica with the least load
  (queue depth + decoding rows + streaming chunks, then the tenant
  class's queue, then page occupancy, then the TTFT EWMA; the lowest id
  breaks ties, so traces are deterministic), with optional **prefix
  affinity**: a request sharing a prompt prefix prefers the replica that
  published those KV pages. A refusal sheds to the next candidate;
  only when every replica refuses does the fleet raise
  :class:`FleetSaturated`.
- **Supervision**: every dispatch turn beats a ledger on the fleet clock
  (:class:`~ray_lightning_tpu_torch.reliability.gang.GangMonitor`), so a
  wedged replica (``serve.replica`` ``stall``) is declared hung within
  ``heartbeat_timeout``. A dead or hung replica is drained: its
  ``snapshot_in_flight()`` and its queue re-admit to the survivors
  through the crash-replay path (prompt + emitted tokens re-feed through
  a prefill or chunks), and a warm standby
  (:class:`~ray_lightning_tpu_torch.reliability.elastic.StandbyPool`) is
  promoted, the pool refilled in the background. Event order is pinned:
  ``fleet.failover`` -> ``recovery.replay`` (each re-admitted request)
  -> ``fleet.replica_promoted``.
- **Autoscaler**: scale out when queue depth or TTFT pressure persists
  past a hysteresis window (a warm standby first, a cold build after);
  scale in by *draining*: the victim admits nothing more, its work
  retires normally, and only then is it shut down.
- **Containment** (off by default): per-request failover budgets with a
  solo probation lane, and crash-loop quarantine of replica seats
  (:class:`~ray_lightning_tpu_torch.serve.containment.SeatTable`).

Everything is synchronous and single-threaded: ``fleet.tick()`` gives
each live replica one dispatch turn, then runs the watchdog and the
autoscaler, so tick-clock traces replay exactly and every chaos scenario
is a seedable ``serve.replica`` fault plan. ``telemetry=None`` (the
default) allocates nothing.

**What this in-process fleet survives.** Every replica runs in this
process and shares its one CUDA context. A host-side replica death
fails over: an exception out of a replica's dispatch (an injected
``serve.dispatch`` fault, an out-of-memory error, a bug on one request's
path) or a ``serve.replica`` fault. A sticky CUDA error (an illegal
address, a device-side assert) poisons the context of every replica at
once, and nothing in one process recovers from it: that needs replicas
in processes of their own, ``backend="process"``
(:class:`~ray_lightning_tpu_torch.serve.process_fleet.ProcessReplicaFleet`,
one worker process and one CUDA context per replica).

**Weights.** Every replica builds its own engine from the one state
dict the fleet was given: its own copy of the weights on the device
(quantized to the same codes when ``weight_dtype=`` is set, so a replay
on a sibling is token-identical) and its own KV pool or arena. A
replica's device bytes are its engine's ``param_bytes()`` plus its KV
storage; a failed-over replica's engine is released before its
replacement is built, so a failover never holds a dead replica's bytes
beside the new ones.
"""
from __future__ import annotations

import dataclasses
import math
import re
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.reliability import faults, log_suppressed
from ray_lightning_tpu_torch.reliability.faults import (InjectedFault,
                                                        MODE_STALL,
                                                        SITE_SERVE_DRIVER,
                                                        SITE_SERVE_REPLICA)
# reliability.gang, .elastic and .supervisor are imported inside
# ReplicaFleet: importing them here closes a cycle (supervisor -> serve
# package -> this module -> gang -> supervisor) when the first import
# enters through the reliability package
from ray_lightning_tpu_torch.serve.client import ServeClient
from ray_lightning_tpu_torch.serve.containment import SeatTable
from ray_lightning_tpu_torch.serve.request import (Completion,
                                                   DEFAULT_TENANT,
                                                   FINISH_REJECTED,
                                                   FINISH_TIMEOUT,
                                                   OccupancyError, Request)
from ray_lightning_tpu_torch.serve.scheduler import ACTION_IDLE, QueueFull

__all__ = ["ReplicaFleet", "Router", "RouterConfig", "FleetConfig",
           "FleetSaturated", "FleetDegraded"]

#: the fleet's telemetry sites, gauges and counters (the JAX fleet's names)
EVENT_ROUTE = "fleet.route"
EVENT_SHED = "fleet.shed"
EVENT_FAILOVER = "fleet.failover"
EVENT_REPLICA_PROMOTED = "fleet.replica_promoted"
EVENT_SCALE_OUT = "fleet.scale_out"
EVENT_REPLICA_DRAINING = "fleet.replica_draining"
EVENT_SCALE_IN = "fleet.scale_in"
# failure containment
EVENT_DEGRADED = "fleet.degraded"
EVENT_RESTORED = "fleet.restored"
EVENT_QUARANTINE = "fleet.quarantine"
EVENT_PROBATION = "fleet.probation"
EVENT_PROBATION_CLEARED = "fleet.probation_cleared"
EVENT_POISON_FAILED = "fleet.poison_failed"
EVENT_READMIT_PARKED = "fleet.readmit_parked"

GAUGE_REPLICAS_LIVE = "serve_fleet_replicas_live"
GAUGE_QUEUE_DEPTH = "serve_fleet_queue_depth"
GAUGE_QUARANTINED = "serve_fleet_quarantined"
COUNTER_FAILOVERS = "serve_fleet_failovers_total"
COUNTER_READMITTED = "serve_fleet_readmitted_requests_total"
COUNTER_SHED = "serve_fleet_shed_total"
COUNTER_POISON_FAILED = "serve_fleet_poison_failed_total"
HISTOGRAM_ROUTER_LOAD = "serve_fleet_router_load"


class FleetSaturated(QueueFull):
    """Every replica refused admission: the *global* shed verdict.

    Raised only after the router has offered the request to every
    admitting replica and each one's own admission control said no.
    Aggregates the per-replica occupancy context the refusals carried:
    ``queue_depth`` is the fleet-wide
    waiting total, ``oldest_age`` the staleness of the oldest queue head
    anywhere, ``replicas`` how many replicas were offered the request.
    """

    def __init__(self, message: str, *,
                 queue_depth: Optional[int] = None,
                 oldest_age: Optional[float] = None,
                 replicas: Optional[int] = None,
                 class_depths: Optional[dict] = None,
                 class_oldest: Optional[dict] = None):
        # skip QueueFull.__init__ (narrower kwargs): the OccupancyError
        # base renders any context. Tenancy armed, ``class_depths`` /
        # ``class_oldest`` aggregate the per-class queue depths and
        # oldest head ages across every offered replica, so shed
        # logging names the saturated CLASS, not just the fleet totals.
        OccupancyError.__init__(self, message, queue_depth=queue_depth,
                                oldest_age=oldest_age, replicas=replicas,
                                class_depths=class_depths,
                                class_oldest=class_oldest)


class FleetDegraded(FleetSaturated):
    """Shed while the fleet is *degraded*: quarantined seats hold it
    below ``min_replicas`` and the survivors' admission control said no.

    A subclass of :class:`FleetSaturated` so every existing shed path
    (``serve_trace``'s ``QueueFull`` catch, caller backoff) handles it
    unchanged — the distinct type is the operator signal that capacity
    is gone to quarantine, not to load: retrying harder will not help
    until a backoff elapses. Carries ``quarantined`` (gated seats) and
    ``live`` (surviving replicas) on top of the saturation context.
    """

    def __init__(self, message: str, *, quarantined: Optional[int] = None,
                 live: Optional[int] = None, **ctx):
        super().__init__(message, **ctx)
        self.quarantined = quarantined
        self.live = live


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Routing policy knobs.

    ``affinity_tokens``: prompt-prefix length (in tokens) keying the
    prefix-affinity map — requests whose first ``affinity_tokens``
    tokens match prefer the replica that last admitted that prefix
    (its prefix cache holds the pages). ``None`` (default) resolves
    automatically: ``prefill_chunk`` on prefix-cache engines (the
    smallest publishable unit), affinity off otherwise. ``0`` forces it
    off. ``affinity_capacity`` bounds the map (LRU).

    ``ttft_alpha``: EWMA smoothing for the per-replica TTFT signal the
    scoring falls back to on load ties.
    """
    affinity_tokens: Optional[int] = None
    affinity_capacity: int = 1024
    ttft_alpha: float = 0.25

    def __post_init__(self):
        if self.affinity_tokens is not None and self.affinity_tokens < 0:
            raise ValueError(
                f"affinity_tokens must be >= 0 or None, got "
                f"{self.affinity_tokens}")
        if self.affinity_capacity < 1:
            raise ValueError(
                f"affinity_capacity must be >= 1, got "
                f"{self.affinity_capacity}")
        if not 0.0 < self.ttft_alpha <= 1.0:
            raise ValueError(
                f"ttft_alpha must be in (0, 1], got {self.ttft_alpha}")


class Router:
    """Load- and affinity-aware replica choice, deterministic by design.

    Scoring reads only live signals the obs layer already exports per
    replica: scheduler queue depth, occupied KV slots, streaming chunk
    prefills, paged-arena occupancy, and a TTFT EWMA folded in from
    retirements. Ties break on the stable replica id, so identical
    fleet states route identically — the property every pinned trace
    test leans on.
    """

    def __init__(self, config: Optional[RouterConfig] = None,
                 affinity_tokens: Optional[int] = None,
                 telemetry: Any = None):
        self.config = config or RouterConfig()
        if affinity_tokens is None:
            # standalone construction: the config field is the source
            # of truth (its None-auto resolution needs engine context,
            # which only ReplicaFleet has — it passes the resolved
            # count explicitly)
            affinity_tokens = self.config.affinity_tokens or 0
        self.affinity_tokens = int(affinity_tokens)
        self._tel = telemetry
        self._affinity: "OrderedDict[Tuple[int, ...], int]" = OrderedDict()
        self._ttft: Dict[int, float] = {}
        self.decisions = 0
        self.affinity_hits = 0

    # --------------------------------------------------------- scoring
    @staticmethod
    def load(replica: "_Replica") -> int:
        """Work parked on a replica: waiting + decoding + chunking."""
        engine = replica.client.engine
        return (len(replica.client.scheduler) + engine.active_count
                + engine.chunk_pending)

    @staticmethod
    def class_load(replica: "_Replica", request: Request) -> int:
        """Waiting requests of ``request``'s own tenant class on this
        replica (0 without a tenant scheduler — untenanted routing is
        byte-identical to the pre-tenancy order). The tenant-aware
        tiebreak: among equally loaded replicas, a class's requests
        steer away from the replica where THAT class is backed up
        (and closest to its per-class quota shedding them)."""
        depths = getattr(replica.client.scheduler, "class_depths", None)
        if depths is None:
            return 0
        return depths().get(request.tenant, 0)

    @staticmethod
    def occupancy(replica: "_Replica") -> float:
        """Paged-arena page occupancy in [0, 1] (0.0 on dense engines):
        the tiebreak that steers work away from arenas running out of
        pages before their slots run out."""
        engine = replica.client.engine
        free = engine.free_pages
        if free is None:
            return 0.0
        return 1.0 - free / engine.pool.num_pages

    def _key(self, request: Request) -> Optional[Tuple[int, ...]]:
        n = self.affinity_tokens
        if n <= 0 or len(request.prompt) < n:
            return None
        return tuple(request.prompt[:n])

    def affine_target(self, request: Request) -> Optional[int]:
        """The replica id holding ``request``'s prompt-prefix pages, or
        ``None`` (affinity off / prefix unseen). The one affinity
        lookup — :meth:`order` promotes this replica and the fleet's
        admission reports a hit against it."""
        key = self._key(request)
        return self._affinity.get(key) if key is not None else None

    def order(self, replicas: Sequence["_Replica"],
              request: Request) -> List["_Replica"]:
        """Admitting replicas in preference order: the affine replica
        (if any, and still admitting) first, then ascending
        (load, occupancy, TTFT EWMA, id). The caller offers the request
        down this list — a refusal sheds to the next candidate."""
        ranked = sorted(
            (r for r in replicas if r.admitting),
            key=lambda r: (self.load(r), self.class_load(r, request),
                           self.occupancy(r),
                           self._ttft.get(r.id, 0.0), r.id))
        rid = self.affine_target(request)
        if rid is not None:
            for i, rep in enumerate(ranked):
                if rep.id == rid:
                    if i:
                        ranked.insert(0, ranked.pop(i))
                    break
        return ranked

    # ------------------------------------------------------ bookkeeping
    def note_admission(self, replica: "_Replica", request: Request,
                       load: int, affine: bool) -> None:
        """One routing decision committed: refresh the affinity map and
        record the decision histogram (how loaded the chosen replica
        was — a skewed histogram means the balancer is failing)."""
        self.decisions += 1
        if affine:
            self.affinity_hits += 1
        key = self._key(request)
        if key is not None:
            self._affinity.pop(key, None)
            self._affinity[key] = replica.id
            while len(self._affinity) > self.config.affinity_capacity:
                self._affinity.popitem(last=False)
        tel = self._tel
        if tel is not None:
            tel.event(EVENT_ROUTE, id=request.id, replica=replica.id,
                      load=load, affinity=affine)
            tel.metrics.histogram(
                HISTOGRAM_ROUTER_LOAD,
                help="chosen replica's load at each routing decision"
            ).observe(float(load))

    def record_ttft(self, replica_id: int, ttft: float) -> None:
        a = self.config.ttft_alpha
        prev = self._ttft.get(replica_id)
        self._ttft[replica_id] = (ttft if prev is None
                                  else (1.0 - a) * prev + a * ttft)

    def forget(self, replica_id: int) -> None:
        """Drop a dead/retired replica's affinity entries and TTFT state
        — new prefixes must not chase a ghost."""
        self._ttft.pop(replica_id, None)
        stale = [k for k, rid in self._affinity.items()
                 if rid == replica_id]
        for k in stale:
            del self._affinity[k]

    def shutdown(self) -> None:
        """Release routing state (affinity map, EWMA ledger)."""
        self._affinity.clear()
        self._ttft.clear()


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Supervision + autoscaling knobs, in the fleet's clock units
    (ticks by default, seconds under a wall clock).

    ``heartbeat_timeout``: how long a replica may go without completing
    a dispatch turn before the watchdog declares it hung and fails it
    over (``startup_grace``, ``None`` = same, covers a fresh replica's
    first dispatch). The ledger and verdicts reuse
    :class:`~ray_lightning_tpu_torch.reliability.gang.GangMonitor` on the
    fleet clock, so hang detection is bounded-time AND deterministic in
    tick mode.

    Autoscaling (``autoscale=True``): scale OUT one replica when the
    fleet-wide queue depth exceeds ``scale_out_queue_depth`` per
    admitting replica — or the fleet TTFT EWMA exceeds ``ttft_slo`` —
    for ``hysteresis`` consecutive ticks (warm standby first, cold
    build otherwise, never past ``max_replicas``); scale IN by draining
    the newest admitting replica after ``hysteresis`` consecutive
    pressure-free ticks with an empty fleet queue, never below
    ``min_replicas``. ``min_replicas`` is also the failover floor: a
    failover that would drop the fleet below it cold-builds a
    replacement even with the standby pool empty.

    Failure containment (all OFF by default: a default config decides
    exactly as a fleet without containment does):

    ``max_request_failovers``: per-request failover budget. Every
    replica death implicates its co-batched in-flight requests
    (``Request.crash_implications``); a request re-admitting at the
    budget retires ``failed`` with its partial tokens instead of
    consuming another replica. Setting it also arms **probation**:
    a request implicated ``probation_after``+ times re-admits solo on a
    router-excluded replica, so a poison request stops taking innocent
    batchmates down with it — a clean probation run resets the count.

    ``flap_window`` / ``flap_threshold``: replica crash-loop
    quarantine. A seat accumulating ``flap_threshold`` deaths inside a
    sliding ``flap_window`` (fleet clock units) quarantines: catch-up
    rebuilds into it follow ``quarantine_backoff`` (a
    :class:`~ray_lightning_tpu_torch.reliability.RetryPolicy`; a
    deterministic-jitter default when None) instead of hot-looping
    build→die→build. While quarantine holds the fleet below
    ``min_replicas`` it is *degraded*: survivors keep serving, sheds
    raise :class:`FleetDegraded`, and ``fleet.degraded`` /
    ``fleet.restored`` bracket the episode.
    """
    heartbeat_timeout: float = 8.0
    startup_grace: Optional[float] = None
    autoscale: bool = False
    min_replicas: int = 1
    max_replicas: int = 8
    scale_out_queue_depth: float = 4.0
    ttft_slo: Optional[float] = None
    hysteresis: int = 3
    max_request_failovers: Optional[int] = None
    probation_after: int = 2
    flap_window: Optional[float] = None
    flap_threshold: int = 3
    quarantine_backoff: Optional[Any] = None  # RetryPolicy

    def __post_init__(self):
        if self.heartbeat_timeout <= 0:
            raise ValueError(
                f"heartbeat_timeout must be > 0, got "
                f"{self.heartbeat_timeout}")
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) < min_replicas "
                f"({self.min_replicas})")
        if self.hysteresis < 1:
            raise ValueError(
                f"hysteresis must be >= 1, got {self.hysteresis}")
        if (self.max_request_failovers is not None
                and self.max_request_failovers < 1):
            raise ValueError(
                f"max_request_failovers must be >= 1 or None, got "
                f"{self.max_request_failovers}")
        if self.probation_after < 1:
            raise ValueError(
                f"probation_after must be >= 1, got "
                f"{self.probation_after}")
        if self.flap_window is not None and self.flap_window <= 0:
            raise ValueError(
                f"flap_window must be > 0 or None, got "
                f"{self.flap_window}")
        if self.flap_threshold < 1:
            raise ValueError(
                f"flap_threshold must be >= 1, got {self.flap_threshold}")
        if (self.quarantine_backoff is not None
                and self.flap_window is None):
            raise ValueError(
                "quarantine_backoff requires flap_window (the sliding "
                "death window is what arms quarantine)")


class _Replica:
    """One supervised replica seat: a ServeClient plus its lifecycle
    flags. ``id`` is stable for the replica's whole life (fault specs
    and affinity entries address it); list position is not."""

    __slots__ = ("id", "client", "draining", "stalled",
                 "last_beat", "last_step", "beats")

    def __init__(self, replica_id: int, client: ServeClient):
        self.id = replica_id
        self.client = client
        # per-replica gauge keying: every replica writes its occupancy
        # gauges into the ONE shared name-keyed registry, so without a
        # replica-id prefix they overwrite each other. The id is stable
        # for the replica's whole life, so `replica<id>_serve_*` series
        # stay coherent across failovers; a standby promoted here gets
        # its prefix at adoption time, before its first dispatch.
        client.gauge_prefix = f"replica{replica_id}_"
        # seat-tag engine spans so the stitched fleet Chrome trace
        # (obs/tracing.py) puts this replica on its own pid track (a
        # supervised engine takes the tag on its wrapper, as in JAX)
        engine = getattr(client, "engine", None)
        if engine is not None and hasattr(engine, "_span_extra"):
            engine._span_extra = {"seat": replica_id}
        self.draining = False   # scale-in: finish in-flight, admit nothing
        self.stalled = False    # latched wedge (serve.replica stall fault)
        # carried beat state: the monitor is rebuilt on membership
        # changes, and this is what re-seeds it so a surviving
        # replica's silence clock survives the rebuild
        self.last_beat: Optional[float] = None
        self.last_step = -1
        self.beats = 0

    @property
    def admitting(self) -> bool:
        return not self.draining and not self.stalled

    @property
    def busy(self) -> bool:
        engine = self.client.engine
        return bool(len(self.client.scheduler) or engine.active_count
                    or engine.chunk_pending)


class _ClientRay:
    """Duck-typed stand-in for the ray module a
    :class:`~ray_lightning_tpu_torch.reliability.elastic.StandbyPool` drives:
    fleet standbys are warm in-process :class:`ServeClient` replicas
    (KV arena allocated, object graph built), not remote actors, so
    "kill" releases the engine and "get" resolves the (absent) warm-up
    future trivially. ``actor_alive``'s duck-probe reports a plain
    client alive, which is exactly right — an in-process standby dies
    with the fleet or not at all."""

    @staticmethod
    def kill(actor: Any, no_restart: bool = True) -> None:
        actor.shutdown()

    @staticmethod
    def get(ref: Any, timeout: Optional[float] = None) -> Any:
        return ref


class ReplicaFleet:
    """N supervised :class:`ServeClient` replicas behind a
    :class:`Router`, driven by one deterministic loop.

    ``ReplicaFleet(model, state_dict, num_replicas=3, num_standby=1,
    num_slots=4, ..., device=None)``: engine keyword arguments go to
    every replica and every warm standby, so any replica can seat any
    request, including the kernel and layout options
    (``page_native=True``, ``attention_kernel="cuda"``,
    ``weight_dtype="int8"`` with ``matmul_kernel="cuda"``,
    ``prefill_chunk=``, ``prefix_cache=True``, ``draft_model=`` with
    ``spec_k=``, ``kv_dtype="int8"``, ``async_dispatch=True``, adapters
    and tenant classes). ``submit()`` routes one request;
    ``serve_trace()`` and ``run_until_idle()`` mirror the client's
    surface. :meth:`shutdown` releases every replica's engine, the
    standby pool and the router.

    ``backend="process"`` constructs the process-backed variant
    (:class:`~ray_lightning_tpu_torch.serve.process_fleet.
    ProcessReplicaFleet`, same contract and ``isinstance`` identity):
    each replica dispatches in its own worker process, on its own host
    thread and in its own CUDA context. The default ``"inproc"`` backend
    stays the deterministic tick-clock harness.

    Failure semantics: a replica whose dispatch raises (or that a
    ``serve.replica`` fault kills) or that stops completing dispatch
    turns past ``heartbeat_timeout`` is torn down, and its in-flight
    snapshot and queued backlog re-admit to the survivors through crash
    replay; requests keep their ids, arrival times, deadlines, emitted
    tokens and first-token stamps. With ``retry_policy=`` forwarded to
    the engines, each replica also heals its own dispatch crashes in
    place (:class:`~ray_lightning_tpu_torch.reliability.ServeSupervisor`)
    and the fleet sees only whole-replica deaths. Host-side deaths only:
    a sticky CUDA error takes every replica of the process (module
    docstring).
    """

    def __new__(cls, *args: Any, **kwargs: Any) -> "ReplicaFleet":
        # the backend switch: ``ReplicaFleet(..., backend="process")``
        # constructs a ProcessReplicaFleet (same contract, replicas in
        # worker processes of their own: serve/process_fleet.py), so
        # callers hold ONE fleet type and ``isinstance(fleet,
        # ReplicaFleet)`` holds either way
        backend = kwargs.get("backend", "inproc")
        if backend not in ("inproc", "process"):
            raise ValueError(
                f"backend must be 'inproc' or 'process', got {backend!r}")
        if cls is ReplicaFleet and backend == "process":
            from ray_lightning_tpu_torch.serve.process_fleet import \
                ProcessReplicaFleet
            return object.__new__(ProcessReplicaFleet)
        return object.__new__(cls)

    def __init__(self, model, params, *, backend: str = "inproc",
                 num_replicas: int = 2,
                 num_standby: int = 0,
                 fleet_config: Optional[FleetConfig] = None,
                 router_config: Optional[RouterConfig] = None,
                 telemetry: Any = None,
                 clock: Optional[Callable[[], float]] = None,
                 journal=None,
                 **engine_kwargs: Any):
        self.backend = "inproc"
        if num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {num_replicas}")
        if num_standby < 0:
            raise ValueError(
                f"num_standby must be >= 0, got {num_standby}")
        self._model = model
        self._params = params
        self._engine_kwargs = dict(engine_kwargs)
        self._cfg = fleet_config or FleetConfig()
        self._tel = telemetry
        self._clock = clock
        self._t0: Optional[float] = None
        self._ticks = 0
        self._next_id = 0
        self._next_replica_id = 0
        self.completions: Dict[int, Completion] = {}
        # write-ahead request journal (serve/journal.py): the FLEET owns
        # it -- member clients are built with journal=None, so one record
        # stream covers every replica and failover re-admissions are
        # re-journaled with their replay binding
        self._journal = journal

        rcfg = router_config or RouterConfig()
        affinity = rcfg.affinity_tokens
        if affinity is None:
            # auto: the chunk is the smallest unit the prefix cache
            # publishes, so prompts sharing one are the ones with pages
            # to adopt; without a prefix cache affinity buys nothing
            affinity = (engine_kwargs.get("prefill_chunk") or 0
                        if engine_kwargs.get("prefix_cache") else 0)
        self.router = Router(rcfg, affinity_tokens=affinity,
                             telemetry=telemetry)

        self._replicas: List[_Replica] = [
            self._new_replica() for _ in range(num_replicas)]

        if num_standby:
            from ray_lightning_tpu_torch.reliability.elastic import StandbyPool
            self.standby = StandbyPool(_ClientRay, num_standby=num_standby,
                                       warmup=None, telemetry=telemetry)
            self.standby.fill(self._build_client)
        else:
            self.standby = None

        from ray_lightning_tpu_torch.reliability.gang import GangConfig
        self._gang_cfg = GangConfig(
            heartbeat_timeout=self._cfg.heartbeat_timeout,
            startup_grace=self._cfg.startup_grace, clock=self.now)
        self._monitor = None
        self._rebuild_monitor()

        # autoscaler hysteresis state + fleet-wide TTFT EWMA
        self._pressure_ticks = 0
        self._idle_ticks = 0
        self._ttft_ewma: Optional[float] = None
        # how many replicas the fleet is SUPPOSED to run: failovers
        # restore toward it (a promotion that raced an in-flight
        # standby refill is caught up at tick time), scale events move
        # it
        self._target_replicas = num_replicas

        # reliability accounting
        self.failovers = 0
        self.readmitted = 0
        self.readmit_failed = 0
        self.scale_outs = 0
        self.scale_ins = 0
        self.failover_s_total = 0.0

        # failure containment. All state below is inert under a default
        # config: nothing reads crash_implications without
        # max_request_failovers, the parked list only fills where a
        # re-admission found every survivor full, and the seat table is
        # None without flap_window.
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
        """Fleet ticks so far — the tick clock."""
        return self._ticks

    def now(self) -> float:
        if self._clock is None:
            return float(self._ticks)
        if self._t0 is None:
            self._t0 = self._clock()
        return self._clock() - self._t0

    # --------------------------------------------------------- replicas
    @property
    def replicas_live(self) -> int:
        return len(self._replicas)

    @property
    def replica_ids(self) -> List[int]:
        return [rep.id for rep in self._replicas]

    def _build_client(self) -> ServeClient:
        # clock_epoch=0.0 pins every replica — including ones built
        # mid-run for promotion/scale-out — to the fleet's own t=0
        client = ServeClient(self._model, self._params, clock=self.now,
                             clock_epoch=0.0, telemetry=self._tel,
                             **self._engine_kwargs)
        # a member client's tick is a replica turn (serve.replica
        # territory) — it must never fire the serve.driver site, whose
        # raise mode means "the DRIVER died", not "this replica died"
        client._fire_driver_site = False
        return client

    def _new_replica(self) -> _Replica:
        rep = _Replica(self._next_replica_id, self._build_client())
        self._next_replica_id += 1
        return rep

    def _adopt(self, client: ServeClient) -> _Replica:
        rep = _Replica(self._next_replica_id, client)
        self._next_replica_id += 1
        self._replicas.append(rep)
        return rep

    def _rebuild_monitor(self) -> None:
        """Membership changed: fresh ledger over the new replica list
        (indices are ranks), re-seeded with every surviving replica's
        carried beat state — a rebuild must NOT reset a wedged
        replica's silence clock (membership churn recurring faster
        than ``heartbeat_timeout`` would defer its hang verdict
        forever), and a second same-tick failover's postmortem keeps
        its real beat ages. Fresh promotions have no carried state and
        start at the stamp, under startup grace."""
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
        """Route + enqueue one request; returns its fleet-wide id.
        Raises ``ValueError`` for requests no replica could ever fit
        (or that name an undeclared tenant, or an ``adapter`` not
        resident fleet-wide) and
        :class:`FleetSaturated` when every replica refuses — a class at
        its per-replica quota sheds ``ClassQueueFull`` to the next
        candidate exactly like any other refusal."""
        req = Request(id=self._next_id, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, eos_id=eos_id,
                      seed=seed, deadline=deadline,
                      tenant=tenant or DEFAULT_TENANT,
                      adapter=adapter)
        self._admit(req)
        self._next_id += 1
        return req.id

    def _admit(self, req: Request) -> _Replica:
        """Offer ``req`` down the router's preference order; first
        replica whose admission control accepts wins. Raises
        :class:`FleetSaturated` (aggregated context) when all refuse."""
        ranked = self.router.order(self._replicas, req)
        if self._probation_rep is not None:
            # the probation replica is reserved for its solo suspect —
            # regular traffic routes around it until the run clears
            ranked = [r for r in ranked if r.id != self._probation_rep]
        affine_target = self.router.affine_target(req)
        for rep in ranked:
            load = self.router.load(rep)
            try:
                rep.client.submit_request(req)
            except QueueFull:
                continue
            self.router.note_admission(
                rep, req, load=load,
                affine=(affine_target is not None
                        and rep.id == affine_target))
            if self._journal is not None:
                self._journal.admit(req)
            return rep
        now = self.now()
        total = sum(len(r.client.scheduler) for r in self._replicas)
        oldest = [r.client.scheduler.oldest_age(now)
                  for r in self._replicas]
        oldest = [a for a in oldest if a is not None]
        # tenancy armed: aggregate the per-class breakdown across every
        # replica so the shed log names the saturated class
        class_depths: Dict[str, int] = {}
        class_oldest: Dict[str, float] = {}
        for r in self._replicas:
            sched = r.client.scheduler
            if getattr(sched, "class_depths", None) is None:
                continue
            for name, depth in sched.class_depths().items():
                class_depths[name] = class_depths.get(name, 0) + depth
            for name, age in sched.class_oldest(now).items():
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

    # ----------------------------------------------------- warm restart
    @classmethod
    def restore(cls, journal_path: str, model, params, *,
                journal_sync_every: int = 8,
                **build_kwargs: Any) -> "ReplicaFleet":
        """Rebuild a fleet from a dead driver's journal and re-admit
        every unretired request through the router's replay lane.

        ``build_kwargs`` are the constructor arguments the dead fleet was
        built with (``backend="process"`` included: the ``__new__``
        switch applies here too, so a process fleet restores as a process
        fleet). The journal is reopened with a bumped generation, so the
        restarted fleet keeps journaling into the same file; on the
        process backend that generation is stamped into every fresh
        worker, and the driver's queue drains refuse messages still
        carrying the dead driver's generation (the split-brain fence),
        while the dead driver's orphaned workers self-reap within the
        grace window.
        Re-admissions ride :meth:`_readmit` (fit-checked against the
        replay window, parked when every replica is transiently full,
        failover budget and probation honored) with ``replay_tokens`` set
        from the journaled frontier, so greedy tokens continue exactly
        and a retired request is never re-emitted.
        """
        from ray_lightning_tpu_torch.serve.journal import (
            COUNTER_JOURNAL_REPLAYED, EVENT_JOURNAL_RESTORED, Journal,
            read_journal)
        state = read_journal(journal_path)
        journal = Journal(journal_path, sync_every=journal_sync_every,
                          generation=state.generation + 1,
                          telemetry=build_kwargs.get("telemetry"))
        fleet = cls(model, params, journal=journal, **build_kwargs)
        pending = state.pending()
        for req, toks in pending:
            fleet._readmit(req, list(toks) if toks else None)
        fleet._next_id = max(fleet._next_id, state.next_request_id)
        tel = fleet._tel
        if tel is not None:
            tel.event(EVENT_JOURNAL_RESTORED, path=str(journal_path),
                      generation=journal.generation,
                      replayed=len(pending), retired=len(state.retired),
                      torn_tail=state.torn_tail)
            tel.metrics.counter(
                COUNTER_JOURNAL_REPLAYED,
                help="unretired requests re-admitted by warm restart"
            ).inc(len(pending))
        return fleet

    # ---------------------------------------------------- hot adapters
    def load_adapter(self, name: str, adapter) -> Optional[str]:
        """Broadcast a hot adapter load to every live replica, keeping
        the whole fleet's resident set in lockstep (any replica can
        seat any request — including a failover re-admission bound to
        this adapter). Every replica holds the SAME resident names by
        construction (identical initial ``adapters=`` kwargs, then only
        lockstep broadcasts), so when the bank is full the fleet evicts
        ONE fleet-chosen victim — the oldest fleet-level load — via an
        explicit unload broadcast first; per-replica LRU eviction
        (which could diverge across replicas whose bind recencies
        differ with routing) never triggers under fleet ops. Returns
        the evicted name, or ``None``. Refuses
        (:class:`~ray_lightning_tpu_torch.serve.request.OccupancyError`) when
        the would-be victim is pinned by in-flight rows anywhere."""
        resident = dict(self._engine_kwargs.get("adapters") or {})
        cap = self._engine_kwargs.get("max_resident_adapters")
        evicted: Optional[str] = None
        if (name not in resident and cap is not None
                and len(resident) >= int(cap)):
            evicted = next(iter(resident))
            self.unload_adapter(evicted)
            resident = dict(self._engine_kwargs.get("adapters") or {})
        for rep in self._replicas:
            rep.client.load_adapter(name, adapter)
        self._sweep_barrier_completions()
        resident[name] = adapter
        self._engine_kwargs["adapters"] = resident
        return evicted

    def unload_adapter(self, name: str) -> None:
        """Broadcast a hot unload. Atomic fleet-wide: every replica's
        pipeline is drained and its refcount checked BEFORE any replica
        unloads, so a pinned adapter refuses without leaving the fleet's
        resident sets diverged."""
        for rep in self._replicas:
            rep.client._drain_for_barrier()
            refs = rep.client.engine.adapter_refcount(name)
            if refs:
                self._sweep_barrier_completions()
                raise OccupancyError(
                    f"cannot unload adapter {name!r}: {refs} in-flight "
                    f"request(s) on replica {rep.id} still bound to it",
                    adapter=name, replica=rep.id, refcount=refs)
        for rep in self._replicas:
            rep.client.unload_adapter(name)
        self._sweep_barrier_completions()
        resident = dict(self._engine_kwargs.get("adapters") or {})
        resident.pop(name, None)
        self._engine_kwargs["adapters"] = resident

    def _sweep_barrier_completions(self) -> None:
        """Adapter barriers drain each replica's pipelined dispatch
        inside the client, so completions the drain retires land in the
        client's ledger without passing through a ``tick()`` return —
        sweep them into the fleet's (same contract as the failover
        ledger sweep)."""
        for rep in self._replicas:
            for rid, comp in rep.client.completions.items():
                if rid not in self.completions:
                    self._note_completion(rep, comp)

    # ------------------------------------------------------------- loop
    def tick(self) -> List[Completion]:
        """One fleet scheduling round: every live replica gets one
        dispatch turn (firing the ``serve.replica`` fault site with its
        id — runnable replicas first, idle ones after, stable
        replica-id tiebreak within each group, so pinned fault ticks
        must be aimed with that order in mind), then the watchdog
        applies its silence verdicts and the autoscaler runs. Returns
        the completions this round retired (failover casualties
        included)."""
        # the driver-death site: raise mode propagates out of the
        # fleet's own tick — the whole fleet state machine dies, which
        # is exactly what ReplicaFleet.restore exists to survive
        faults.fire(SITE_SERVE_DRIVER)
        done: List[Completion] = []
        # parked failover re-admissions (every survivor transiently
        # full at failover time) retry BEFORE the dispatch turns, so a
        # re-seated request joins this very tick's prefill action
        self._pump_parked(done)
        # drive order: replicas with a runnable action (a dispatch to
        # enqueue, or an async dispatch to reconcile) go FIRST, idle
        # replicas after — strict list order used to park queued work
        # on replica 2 behind replica 0's idle turn, and under async
        # dispatch the early enqueues now compute while the later
        # replicas' host work runs. Deterministic: stable (runnable,
        # replica-id) sort, pinned by tests/test_async_dispatch.py.
        order = sorted(self._replicas,
                       key=lambda rep: (not self._runnable(rep), rep.id))
        for rep in order:
            if rep not in self._replicas:
                continue  # removed by an earlier failover this round
            done.extend(self._tick_replica(rep))
        self._ticks += 1
        silent = [self._replicas[i]
                  for i in self._monitor.silent_ranks()
                  if i < len(self._replicas)]
        for rep in silent:
            if rep in self._replicas:
                done.extend(self._fail_replica(rep, dead=False))
        if len(self._replicas) < self._target_replicas and (
                self._seats is None
                or self._seats.allow_build(self.now())):
            # catch-up restoration: a failover that found the standby
            # pool empty (raced refill — or no pool at all) must not
            # leave the fleet serving short forever. Warm-promote if a
            # standby landed, cold-build otherwise: the construction
            # cost lands on THIS tick, off the failover critical path.
            # Quarantined seats gate this path: a crash-looping seat
            # rebuilds on its backoff schedule, not every tick.
            rep, source = self._adopt_standby_or_build(cold_ok=True)
            self._rebuild_monitor()
            if self._tel is not None:
                self._tel.event(EVENT_REPLICA_PROMOTED,
                                replica=rep.id, source=source,
                                replicas_live=len(self._replicas))
        if self._cfg.autoscale:
            self._autoscale()
        self._pump_probation(done)
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
            ).set(sum(len(r.client.scheduler) for r in self._replicas))
        journal = self._journal
        if journal is not None:
            # journal every replica's synced frontier (the same
            # snapshot failover replays from) so a driver death loses
            # at most the records inside the fsync window
            for rep in self._replicas:
                for req, toks in rep.client.engine.snapshot_in_flight():
                    journal.note_frontier(req.id, toks,
                                          req.first_token_time)
        return done

    def _runnable(self, rep: _Replica) -> bool:
        """Will this replica's tick actually dispatch (or reconcile)
        something? Reads the scheduler's non-mutating lookahead against
        the replica's synced engine state — a wedged replica is not
        runnable (its turn is skipped anyway), an idle one only
        advances its clock."""
        if rep.stalled:
            return False
        client = rep.client
        if client.dispatch_in_flight:
            return True
        return client.scheduler.peek_action(client.engine) != ACTION_IDLE

    def _tick_replica(self, rep: _Replica) -> List[Completion]:
        if rep.stalled:
            # wedged dispatch loop: no dispatch, no beat — the silence
            # verdict fails it over within heartbeat_timeout
            return []
        try:
            verdict = faults.fire(SITE_SERVE_REPLICA, rank=rep.id)
        except InjectedFault as exc:
            log_suppressed("fleet.replica", exc,
                           f"replica {rep.id} killed; failing over")
            return self._fail_replica(rep, dead=True)
        if verdict == MODE_STALL:
            # a latched wedge, not a one-dispatch hiccup: a stalled
            # collective/host callback never comes back on its own —
            # the replica stops beating and supervision takes it out
            rep.stalled = True
            return []
        try:
            out = rep.client.tick()
        except Exception as exc:  # noqa: BLE001 — replica crash enters failover
            log_suppressed("fleet.replica", exc,
                           f"replica {rep.id} dispatch crashed; "
                           "failing over")
            out = None
        if out is None:
            # failed over outside the except block: the exception's
            # traceback holds the dead engine's frames, which would keep
            # its weights and KV alive beside the replacement's
            return self._fail_replica(rep, dead=True)
        self._monitor.observe(self._replicas.index(rep), rep.client.ops)
        rep.last_beat = self.now()
        rep.last_step = rep.client.ops
        rep.beats += 1
        for comp in out:
            self._note_completion(rep, comp)
        return out

    def _note_completion(self, rep: _Replica, comp: Completion) -> None:
        self.completions[comp.request_id] = comp
        if self._journal is not None:
            self._journal.retire(comp)
        ttft = comp.time_to_first_token
        if ttft is not None:
            self.router.record_ttft(rep.id, ttft)
            a = self.router.config.ttft_alpha
            self._ttft_ewma = (ttft if self._ttft_ewma is None
                               else (1.0 - a) * self._ttft_ewma + a * ttft)

    # --------------------------------------------------------- failover
    def _fail_replica(self, rep: _Replica, *,
                      dead: bool) -> List[Completion]:
        """Drain a dead (``dead=True``) or hung replica: snapshot its
        work, tear it down, re-admit everything to survivors via
        replay, then promote a standby. Returns the FINISH_FAILED
        completions of requests nothing could re-seat."""
        t0 = time.perf_counter()
        self.failovers += 1
        tel = self._tel
        idx = self._replicas.index(rep)
        post = self._monitor.postmortems(
            silent=() if dead else (idx,),
            dead=(idx,) if dead else ()).get(idx)
        # no local reference to the engine: it must be released when the
        # seat drops its client (_remove_replica)
        entries = rep.client.engine.snapshot_in_flight()
        chunking = rep.client.engine.chunk_pending
        queued = rep.client.scheduler.waiting
        # every co-batched in-flight request is IMPLICATED by this
        # death (queued requests never touched the engine and are not);
        # the counter rides the request object through re-admission,
        # like replay_tokens. Implication is not proof -- probation
        # sorts innocents from poison.
        for _req, _toks in entries:
            _req.crash_implications += 1
        if self._probation_rep == rep.id:
            # the probation replica died — almost certainly the suspect
            # crashed it. Release the reservation; the suspect rides
            # the normal re-admission path below with its bumped count
            # (back to probation, or out at the budget).
            self._probation_rep = None
            self._probation_obj = None
        if tel is not None:
            tel.event(EVENT_FAILOVER, replica=rep.id, dead=dead,
                      in_flight=len(entries), queued=len(queued),
                      chunking=chunking,
                      last_dispatch=(post.last_step if post else -1),
                      beat_age=(round(post.last_beat_age_s, 3)
                                if post else None))
            tel.metrics.counter(
                COUNTER_FAILOVERS,
                help="replicas drained after death or hang").inc()
        ledger = rep.client.completions
        # remove BEFORE re-admission: the router must never route the
        # dead replica's own work back onto it
        self._remove_replica(rep)
        if self._seats is not None:
            next_build = self._seats.record_death(rep.id, self.now())
            if next_build is not None and tel is not None:
                tel.event(EVENT_QUARANTINE, replica=rep.id,
                          next_build=round(next_build, 6))
        # sweep the dead client's completion ledger: a crashing tick
        # commits its already-collected expiry/cancel completions
        # client-side before unwinding (ServeClient._finalize) — they
        # never came back through a tick() return, and the requests are
        # in neither the snapshot nor the queue, so this is their only
        # way into the fleet's results
        done: List[Completion] = [
            comp for rid, comp in ledger.items()
            if rid not in self.completions]
        for comp in done:
            self.completions[comp.request_id] = comp
            if self._journal is not None:
                self._journal.retire(comp)
        promoted_early = False
        if not self._replicas:
            # sole-replica fleet: with no survivor to replay onto,
            # promotion must come first or every request would fail —
            # the pinned failover→replay→promoted order applies to
            # fleets with survivors
            self._promote()
            promoted_early = True
        for req, toks in entries:
            done.extend(self._readmit(req, toks))
        for req in queued:
            done.extend(self._readmit(req, None))
        if not promoted_early:
            self._promote()
        self._rebuild_monitor()
        self.failover_s_total += time.perf_counter() - t0
        return done

    def _readmit(self, req: Request,
                 toks: Optional[List[int]]) -> List[Completion]:
        """Crash-replay re-admission of one displaced request: prompt +
        already-emitted tokens re-feed through a survivor's prefill, so
        its token stream continues at the same step --
        deadline, arrival time and any first-token stamp ride the
        request object unchanged.

        Containment armed (``max_request_failovers``), the request's
        implication count gates the path: at the budget it retires
        ``failed`` instead of consuming another replica; at
        ``probation_after`` it queues for a solo probation run. A
        *transient* refusal (every survivor QueueFull) parks the
        request for retry on later ticks — only a permanent misfit
        (outgrew the replay window, undeclared tenant/adapter) still
        fails it here."""
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
            if fed <= survivors[0].client.engine.max_replay_len:
                try:
                    self._admit(req)
                except QueueFull as exc:
                    # transiently full, not unseatable: park for
                    # bounded re-admission (deadline still enforced,
                    # _pump_parked) instead of instant failure
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
        # outgrew the replay window / permanently unseatable / no
        # survivor and no rebuild coming: the request fails with the
        # tokens it already has — the fleet keeps serving everything
        # else
        return [self._fail_request(req)]

    def _count_readmitted(self) -> None:
        self.readmitted += 1
        if self._tel is not None:
            self._tel.metrics.counter(
                COUNTER_READMITTED,
                help="requests re-admitted to surviving "
                     "replicas after a failover").inc()

    def _fail_request(self, req: Request) -> Completion:
        from ray_lightning_tpu_torch.reliability.supervisor import \
            failed_completion
        self.readmit_failed += 1
        comp = failed_completion(req, req.replay_tokens or ())
        comp.finish_time = self.now()
        self.completions[comp.request_id] = comp
        if self._journal is not None:
            self._journal.retire(comp)
        return comp

    def _retire_poison(self, req: Request) -> List[Completion]:
        """The request spent its failover budget: retire it ``failed``
        with its partial tokens instead of feeding it another replica."""
        self.poison_failed += 1
        tel = self._tel
        if tel is not None:
            tel.event(EVENT_POISON_FAILED, id=req.id,
                      implications=req.crash_implications,
                      tokens=len(req.replay_tokens or ()))
            tel.metrics.counter(
                COUNTER_POISON_FAILED,
                help="requests retired failed at their failover "
                     "budget (suspected poison)").inc()
        return [self._fail_request(req)]

    def _park(self, req: Request) -> None:
        self._parked.append(req)
        if self._tel is not None:
            self._tel.event(EVENT_READMIT_PARKED, id=req.id,
                            parked=len(self._parked))

    def _pump_parked(self, done: List[Completion]) -> None:
        """Retry every parked failover re-admission: deadline expiries
        retire ``timeout`` with their partial tokens (the client-side
        expiry contract), fits re-admit through the router, still-full
        stays parked for the next tick."""
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
                if self._journal is not None:
                    self._journal.retire(comp)
                done.append(comp)
                continue
            survivors = self._replicas
            if not survivors:
                still.append(req)
                continue
            fed = req.prompt_len + len(req.replay_tokens or ())
            if fed > survivors[0].client.engine.max_replay_len:
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
        """Drive the probation lane: a retired suspect's clean run
        resets its implication count and releases the reserved
        replica; the next suspect seats solo once the reservation is
        idle. Reserving waits for a second admitting replica (unless
        the fleet's target IS one) so regular traffic keeps a lane."""
        obj = self._probation_obj
        if obj is not None:
            comp = self.completions.get(obj.id)
            if comp is None:
                return  # suspect still running solo
            # clean run: the "poison" evidence didn't reproduce --
            # exonerate (implication is not proof)
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
        if rep.busy:
            return  # let the reserved replica drain its regular work
        req = self._probation[0]
        fed = req.prompt_len + len(req.replay_tokens or ())
        if fed > rep.client.engine.max_replay_len:
            self._probation.pop(0)
            done.append(self._fail_request(req))
            return
        try:
            rep.client.submit_request(req)
        except QueueFull:
            return  # idle replica refused (quota edge); retry next tick
        self._probation.pop(0)
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
            -> Tuple[Optional[_Replica], Optional[str]]:
        """The one add-a-replica sequence every growth path shares:
        take a warm standby (kicking the background refill behind it),
        else cold-build when ``cold_ok``. Returns ``(None, None)`` when
        the pool is empty and a cold build is not warranted. ``grow``
        marks deliberate new capacity (scale-out): quarantine armed, it
        seats a FRESH seat instead of filling a gated one."""
        client = self.standby.take() if self.standby is not None else None
        source = "standby" if client is not None else None
        if client is None:
            if not cold_ok:
                return None, None
            client = self._build_client()
            source = "cold"
        elif self._engine_kwargs.get("max_resident_adapters"):
            # a warm standby was built with the kwargs as of pool-fill
            # time; hot adapter churn since must be replayed onto it
            # BEFORE it serves — a stale bank would refuse re-admitted
            # adapter-bound requests as UnknownAdapter. (Cold builds
            # read the current kwargs and need nothing.) Loading every
            # wanted adapter unconditionally also repairs overwrites:
            # a resident name reuses its index, a slice write is cheap.
            want = dict(self._engine_kwargs.get("adapters") or {})
            for name in list(client.engine.resident_adapters):
                if name not in want:
                    client.unload_adapter(name)
            for name, tree in want.items():
                client.load_adapter(name, tree)
        rep = self._adopt(client)
        if self._seats is not None:
            self._seats.occupy(rep.id, self.now(), grow=grow)
        if self.standby is not None:
            self.standby.refill_async(self._build_client)
        return rep, source

    def _remove_replica(self, rep: _Replica) -> None:
        """The one remove-a-replica sequence failover and scale-in
        share: out of the routing set, affinity/EWMA state dropped,
        engine released. The seat drops its client too, so the engine's
        weights and KV go back to the allocator before a replacement is
        built (the tick that held the replica still references the
        seat)."""
        self._replicas.remove(rep)
        self.router.forget(rep.id)
        try:
            rep.client.shutdown()
        except Exception as exc:  # noqa: BLE001 — teardown is best-effort
            log_suppressed("fleet.teardown", exc,
                           f"replica {rep.id} shutdown failed")
        rep.client = None

    def _promote(self) -> None:
        """Restore capacity after a failover: a warm standby when the
        pool has one (refilled in the background afterwards — spawn
        cost stays off the critical path), a cold build only when the
        fleet would otherwise sit below ``min_replicas``. When the pool
        is empty (a refill still building, or no pool at all), the
        tick-time catch-up (:meth:`tick`) restores toward
        ``_target_replicas`` on the next round — warm if a standby
        landed by then, cold otherwise — so a failover never leaves
        the fleet short forever."""
        if (self._seats is not None
                and not self._seats.allow_build(self.now())):
            # every empty seat is quarantined: the rebuild waits for
            # its backoff (tick-time catch-up performs it), even below
            # min_replicas — that's what degraded mode is for
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
        cfg = self._cfg
        admitting = [r for r in self._replicas if r.admitting]
        total_q = sum(len(r.client.scheduler) for r in self._replicas)
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
        for rep in [r for r in self._replicas if r.draining]:
            if not rep.busy:
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

    def _drain_one(self, admitting: List[_Replica]) -> None:
        """Scale-in is a drain, never a kill: the newest admitting
        replica stops taking requests; its in-flight work retires
        normally and only then is it shut down."""
        candidates = [r for r in admitting
                      if r.id != self._probation_rep] or admitting
        rep = max(candidates, key=lambda r: r.id)
        rep.draining = True
        if self._tel is not None:
            self._tel.event(EVENT_REPLICA_DRAINING, replica=rep.id,
                            in_flight=rep.client.engine.active_count,
                            queued=len(rep.client.scheduler))

    def _retire_replica(self, rep: _Replica) -> None:
        self._remove_replica(rep)
        if self._seats is not None:
            # a deliberate drain is not a death: the seat retires clean
            self._seats.vacate(rep.id)
        self.scale_ins += 1
        self._target_replicas = len(self._replicas)
        self._rebuild_monitor()
        if self._tel is not None:
            self._tel.event(EVENT_SCALE_IN, replica=rep.id,
                            replicas_live=len(self._replicas))

    # ---------------------------------------------------------- driving
    def _busy(self) -> bool:
        return (any(rep.busy for rep in self._replicas)
                or bool(self._parked) or bool(self._probation)
                or self._probation_obj is not None)

    def run_until_idle(self, max_ticks: int = 100_000) \
            -> Dict[int, Completion]:
        """Tick until every replica's queue and slots drain."""
        ticks = 0
        while self._busy():
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"fleet loop did not drain in {max_ticks} ticks")
        return dict(self.completions)

    def serve_trace(self, trace: Sequence[Tuple[float, dict]],
                    max_ticks: int = 100_000) -> Dict[int, Completion]:
        """Replay a scripted arrival trace fleet-wide — the same
        contract as :meth:`ServeClient.serve_trace`: entries the whole
        fleet refuses are SHED as ``finish_reason="rejected"``
        completions (with the aggregated occupancy context logged),
        never aborted."""
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
                        tenant=kwargs.get("tenant") or DEFAULT_TENANT,
                        adapter=kwargs.get("adapter"))
                    if tel is not None:
                        tel.event(EVENT_SHED, id=rid,
                                  why=type(exc).__name__,
                                  context=str(exc))
                        tel.metrics.counter(
                            COUNTER_SHED,
                            help="requests shed fleet-wide at admission"
                        ).inc()
                idx += 1
            if idx < len(pending) and not self._busy():
                # idle gap before the next arrival: fast-forward (tick
                # mode) / yield (wall mode), and re-stamp the watchdog —
                # idle time is not silence, nobody dispatches while
                # there is nothing to do
                if self._clock is None:
                    self._ticks = max(self._ticks,
                                      math.ceil(pending[idx][0]))
                else:
                    # wall-clock mode's idle yield; tick mode never sleeps
                    time.sleep(min(1e-3, max(0.0, pending[idx][0] - now)))
                self._monitor.start()
                # mirror the restamp into the carried beat state, or a
                # later monitor rebuild would seed pre-gap beats and
                # declare everyone silent across the idle skip
                t = self.now()
                for rep in self._replicas:
                    if rep.last_beat is not None:
                        rep.last_beat = t
                continue
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"fleet trace did not drain in {max_ticks} ticks")
        return dict(self.completions)

    # ------------------------------------------------------ observability
    #: internal per-replica gauge prefix -> fleet-merged suffix form
    _REPLICA_GAUGE_RE = re.compile(r"^replica(\d+)_(serve_.+)$")

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Fleet-merged metrics view: the registry's internal
        ``replica<id>_serve_*`` gauge keying (which exists to stop
        per-replica gauges clobbering each other last-writer-wins) is
        renamed to the seat-suffixed operator form —
        ``serve_queue_depth_r0``, ``serve_slot_occupancy_r1``, … —
        alongside the untouched ``serve_fleet_*`` aggregates and every
        other metric. ``{}`` when the fleet was built disarmed."""
        if self._tel is None:
            return {}
        out: Dict[str, Any] = {}
        for name, value in self._tel.metrics.snapshot().items():
            m = self._REPLICA_GAUGE_RE.match(name)
            out[f"{m.group(2)}_r{m.group(1)}" if m else name] = value
        return out

    def request_traces(self) -> Dict[int, Any]:
        """Assembled per-request traces for this fleet run — see
        :meth:`Telemetry.request_traces`. ``{}`` when disarmed."""
        if self._tel is None:
            return {}
        return self._tel.request_traces()

    def export_fleet_trace(self, path: str) -> str:
        """Stitch every replica's seat-tagged spans together
        with the per-request latency segments into ONE multi-track
        Chrome trace (``pid`` = replica seat, ``tid`` = KV slot) and
        atomically publish it at ``path``. Byte-identical across
        identical runs under the tick clock. Raises ``RuntimeError``
        when the fleet was built with ``telemetry=None`` — there is
        nothing to export, and silently writing an empty file would
        mask a mis-armed run."""
        if self._tel is None:
            raise RuntimeError(
                "export_fleet_trace on a disarmed fleet: pass "
                "telemetry= at construction to record a trace")
        from ray_lightning_tpu_torch.obs.tracing import \
            export_fleet_chrome_trace
        return export_fleet_chrome_trace(path, self._tel)

    # ---------------------------------------------------------- teardown
    def shutdown(self) -> None:
        """Release every replica's engine (KV pool/arena + prefix-cache
        refs), the warm standby pool, and the router. Idempotent; the
        fleet is unusable afterwards."""
        for rep in self._replicas:
            try:
                rep.client.shutdown()
            except Exception as exc:  # noqa: BLE001 — teardown is best-effort
                log_suppressed("fleet.teardown", exc,
                               f"replica {rep.id} shutdown failed")
        self._replicas = []
        if self.standby is not None:
            self.standby.shutdown()
        self.router.shutdown()
        self._monitor = None
        journal = self._journal
        if journal is not None:
            self._journal = None
            journal.shutdown()
