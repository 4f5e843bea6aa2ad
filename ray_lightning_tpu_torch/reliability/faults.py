"""Deterministic fault injection at named sites (copied from ``ray_lightning_tpu/reliability/faults.py``).

The standard library only, as in the JAX package: the same sites, modes,
tick counting and arming. Every injection is logged and, with a
:class:`~ray_lightning_tpu_torch.obs.Telemetry` activated, lands on its
bus as ``fault.injected`` and in ``reliability_faults_total``.

Chaos testing on XLA's terms: failures must be *replayable*. A
:class:`FaultPlan` is a finite schedule of :class:`FaultSpec`\\ s keyed by
``(site, tick)`` — the ``tick`` is the 0-based count of times that site
has fired since the plan was armed, NOT wall time — so the same plan
against the same workload injects the same failures at the same program
points every run. Tests pin exact recovery behavior; the chaos bench
pins recovery cost.

Sites are woven into the hot paths as a single ``fire(site)`` call:

====================  ====================================================
``serve.dispatch``    every :class:`ServeEngine` program dispatch
                      (prefill *and* decode step count on one clock)
``train.step``        top of the trainer's batch loop, before the
                      compiled step
``ckpt.save``         inside checkpoint writers, *before the commit
                      point* (a ``raise`` here = killed mid-save)
``loader.next``       per batch fetched by the trainer's prefetcher
``worker.exit``       per trainer batch, worker-side — ``mode="exit"``
                      hard-kills the worker process (``os._exit``), the
                      no-exception death of an OOM-kill/preemption
``worker.stall``      per trainer batch, worker-side — ``mode="stall"``
                      wedges the training loop (heartbeats stop, the
                      gang watchdog's hang verdict)
``rendezvous.init``   driver-side, at the top of the launcher's
                      rendezvous brokering in ``setup_workers``
``serve.replica``     per replica dispatch turn inside a
                      :class:`~ray_lightning_tpu.serve.fleet.ReplicaFleet`
                      tick — ``raise`` kills the whole replica (its
                      in-flight work fails over to survivors),
                      ``stall`` wedges its dispatch loop (heartbeats
                      stop; the fleet's hang verdict). Carries the
                      replica's stable id as ``rank``.
``serve.verify``      per speculative-decode dispatch, after the draft
                      refills and immediately before the fused
                      draft+verify program — ``raise`` crashes the
                      verify (the supervisor's rebuild-and-replay path,
                      token-identical greedy recovery), ``stall``
                      wedges it (deadline pressure on every in-flight
                      row). Only fires on engines armed with a
                      ``draft_model``.
``serve.driver``      per driver tick: top of ``ServeClient.tick()``
                      (standalone clients only) and of
                      ``ReplicaFleet.tick()`` /
                      ``ProcessReplicaFleet.tick()`` — ``raise``
                      crashes the DRIVER itself (the propagating
                      exception is the deterministic mid-decode driver
                      kill the warm-restart tests and the
                      ``driver_restart`` chaos bench replay from a
                      journal), ``stall`` wedges one driver tick.
                      Fleet-member clients and spawned serve workers
                      never fire it: their ticks are replica turns,
                      already covered by ``serve.replica``.
``serve.poison``      id-triggered, not tick-scheduled: the engine calls
                      ``poison_check(requests)`` after seating a prefill
                      batch and before every decode dispatch; the plan's
                      ``poison`` id set crashes any dispatch a scheduled
                      request id joins, every time — the deterministic
                      "poison input" that kills whatever replica admits
                      it (vs ``serve.dispatch``'s transient nth-tick
                      crash). ``mode="exit"`` hard-kills a spawned
                      replica process (the kill -9 shape); degrades to
                      ``raise`` in-process. Exercises the fleet's
                      failure-containment layer
                      (``docs/reliability.md#failure-containment``).
====================  ====================================================

The worker sites additionally carry the firing worker's **rank**
(``fire(site, rank=...)``); a :class:`FaultSpec` with ``rank`` set only
matches that rank, ``rank=None`` matches any. Remote launchers ship the
armed plan to each worker process, which arms its own copy — worker-site
tick counters therefore restart per launch attempt, while driver-side
sites (``rendezvous.init``) keep counting across restarts (see
``docs/reliability.md#gang-supervision``).

When no plan is armed (the default), ``fire`` is one global read and a
``None`` check — the injection machinery costs nothing in production.

Modes: ``raise`` throws :class:`InjectedFault` (a crash), ``nan``
returns a verdict the call site uses to NaN-poison its payload (only
meaningful where there is a float payload: ``train.step`` /
``loader.next``), ``stall`` sleeps ``stall_s`` inside ``fire`` (a slow
dependency, exercising deadlines/backoff), ``exit`` hard-exits the
process — but only when it really is a spawned worker process (the
subprocess backend stamps ``TL_WORKER_PROCESS``); in-process backends
degrade it to ``raise`` so a fake-ray test can never kill the test
runner.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.reliability import logger

SITE_SERVE_DISPATCH = "serve.dispatch"
SITE_TRAIN_STEP = "train.step"
SITE_CKPT_SAVE = "ckpt.save"
SITE_LOADER_NEXT = "loader.next"
SITE_WORKER_EXIT = "worker.exit"
SITE_WORKER_STALL = "worker.stall"
SITE_RENDEZVOUS_INIT = "rendezvous.init"
SITE_SERVE_REPLICA = "serve.replica"
SITE_SERVE_VERIFY = "serve.verify"
SITE_SERVE_POISON = "serve.poison"
SITE_SERVE_DRIVER = "serve.driver"

MODE_RAISE = "raise"
MODE_NAN = "nan"
MODE_STALL = "stall"
MODE_EXIT = "exit"

#: set (to "1") in spawned worker processes; gates the hard-exit mode
WORKER_PROCESS_ENV = "TL_WORKER_PROCESS"

# which modes make sense where: nan needs a float payload to poison,
# exit needs a disposable process to kill
SITES: Dict[str, Tuple[str, ...]] = {
    SITE_SERVE_DISPATCH: (MODE_RAISE, MODE_STALL),
    SITE_TRAIN_STEP: (MODE_RAISE, MODE_NAN, MODE_STALL),
    SITE_CKPT_SAVE: (MODE_RAISE, MODE_STALL),
    SITE_LOADER_NEXT: (MODE_RAISE, MODE_NAN, MODE_STALL),
    SITE_WORKER_EXIT: (MODE_EXIT, MODE_RAISE),
    SITE_WORKER_STALL: (MODE_STALL, MODE_RAISE),
    SITE_RENDEZVOUS_INIT: (MODE_RAISE, MODE_STALL),
    SITE_SERVE_REPLICA: (MODE_RAISE, MODE_STALL),
    SITE_SERVE_VERIFY: (MODE_RAISE, MODE_STALL),
    SITE_SERVE_POISON: (MODE_RAISE, MODE_EXIT),
    SITE_SERVE_DRIVER: (MODE_RAISE, MODE_STALL),
}


class InjectedFault(RuntimeError):
    """The crash a ``mode="raise"`` :class:`FaultSpec` throws."""

    def __init__(self, site: str, tick: int):
        super().__init__(f"injected fault at {site} tick {tick}")
        self.site = site
        self.tick = tick

    def __reduce__(self):
        # crosses the worker -> driver pickle boundary intact
        return (type(self), (self.site, self.tick))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled failure: ``site`` fires its ``at``-th time → ``mode``.

    ``rank`` (optional) restricts the spec to one worker rank at sites
    whose ``fire`` passes a rank (the ``worker.*`` sites); ``None``
    matches any rank."""
    site: str
    at: int
    mode: str = MODE_RAISE
    stall_s: float = 0.01
    rank: Optional[int] = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; known: "
                f"{sorted(SITES)}")
        if self.mode not in SITES[self.site]:
            raise ValueError(
                f"mode {self.mode!r} not supported at {self.site!r} "
                f"(supported: {SITES[self.site]})")
        if self.at < 0:
            raise ValueError(f"at must be >= 0, got {self.at}")
        if self.stall_s < 0:
            raise ValueError(f"stall_s must be >= 0, got {self.stall_s}")
        if self.rank is not None and self.rank < 0:
            raise ValueError(f"rank must be >= 0 or None, got {self.rank}")


class FaultPlan:
    """A deterministic failure schedule over the named sites.

    Arm it around the workload under test::

        plan = FaultPlan.at("serve.dispatch", [0, 3, 7])
        with plan.armed():
            client.serve_trace(trace)
        assert plan.fired == 3

    Each site keeps its own tick counter (incremented on every ``fire``,
    fault or not), so "the 3rd decode dispatch" is a stable coordinate
    regardless of wall time or host scheduling. Counters persist across
    recoveries — a retry's re-dispatch consumes the next tick, which is
    exactly what lets one plan script "fail the first attempt AND its
    retry".
    """

    def __init__(self, specs: Iterable[FaultSpec] = (),
                 sleep: Callable[[float], None] = time.sleep,
                 poison: Iterable[int] = (),
                 poison_mode: str = MODE_RAISE):
        self.specs: List[FaultSpec] = list(specs)
        self._sleep = sleep  # injectable: stall tests stay wall-clock-free
        # id-triggered poison (SITE_SERVE_POISON): request ids whose
        # presence in a seated batch crashes the dispatch, every time —
        # deterministic by id, not by tick, so the same input kills
        # whichever replica re-admits it after failover.
        self.poison = frozenset(int(i) for i in poison)
        if poison_mode not in SITES[SITE_SERVE_POISON]:
            raise ValueError(
                f"poison_mode {poison_mode!r} not supported "
                f"(supported: {SITES[SITE_SERVE_POISON]})")
        self.poison_mode = poison_mode
        self._by_key: Dict[Tuple[str, int, Optional[int]], FaultSpec] = {}
        for spec in self.specs:
            key = (spec.site, spec.at, spec.rank)
            if key in self._by_key:
                raise ValueError(
                    f"duplicate fault at {spec.site!r} tick {spec.at}"
                    + (f" rank {spec.rank}" if spec.rank is not None
                       else ""))
            self._by_key[key] = spec
        self._counts: Dict[str, int] = {site: 0 for site in SITES}
        self.fired = 0

    # ------------------------------------------------------ constructors
    @classmethod
    def at(cls, site: str, ticks: Iterable[int],
           mode: str = MODE_RAISE, stall_s: float = 0.01,
           rank: Optional[int] = None,
           sleep: Callable[[float], None] = time.sleep) -> "FaultPlan":
        """Schedule ``mode`` at ``site`` for every tick in ``ticks``."""
        return cls((FaultSpec(site, int(t), mode, stall_s, rank)
                    for t in ticks), sleep=sleep)

    @classmethod
    def random(cls, seed: int, n_faults: int,
               sites: Sequence[str] = (SITE_SERVE_DISPATCH,),
               horizon: int = 64,
               modes: Optional[Sequence[str]] = None) -> "FaultPlan":
        """Seeded random schedule: same seed → the same plan, always.

        ``n_faults`` faults over ``sites``, ticks uniform in
        ``[0, horizon)`` without (site, tick) repeats, mode drawn from
        ``modes`` ∩ the site's supported modes (default: raise only —
        the mode every site supports).
        """
        import numpy as np

        if n_faults > horizon * len(sites):
            raise ValueError(
                f"cannot place {n_faults} faults on {len(sites)} sites "
                f"with horizon {horizon}")
        rng = np.random.default_rng(seed)
        specs: List[FaultSpec] = []
        used = set()
        while len(specs) < n_faults:
            site = sites[int(rng.integers(len(sites)))]
            tick = int(rng.integers(horizon))
            if (site, tick) in used:
                continue
            used.add((site, tick))
            allowed = [m for m in (modes or (MODE_RAISE,))
                       if m in SITES[site]]
            if not allowed:
                raise ValueError(
                    f"none of modes {modes} supported at {site!r}")
            mode = allowed[int(rng.integers(len(allowed)))]
            specs.append(FaultSpec(site, tick, mode))
        return cls(specs)

    # ------------------------------------------------------------ firing
    def counts(self) -> Dict[str, int]:
        return dict(self._counts)

    def reset(self) -> None:
        """Zero all tick counters (replay the schedule from the top)."""
        self._counts = {site: 0 for site in SITES}
        self.fired = 0

    def fire(self, site: str, rank: Optional[int] = None) -> Optional[str]:
        """Advance ``site``'s tick; inject if a spec is scheduled there.

        ``rank`` is the firing worker's rank at the ``worker.*`` sites
        (rank-addressed specs match it; rank-less specs match anyone).
        Returns ``None`` (no fault), ``MODE_NAN`` (caller poisons its
        payload) or ``MODE_STALL`` (the sleep already happened); raises
        :class:`InjectedFault` for ``MODE_RAISE``; ``MODE_EXIT`` hard-
        exits a spawned worker process (``os._exit(17)``) and degrades
        to a raise everywhere else.
        """
        tick = self._counts[site]
        self._counts[site] = tick + 1
        spec = self._by_key.get((site, tick, rank))
        if spec is None and rank is not None:
            spec = self._by_key.get((site, tick, None))
        if spec is None:
            return None
        self.fired += 1
        logger.warning("injecting %s at %s tick %d (rank %s)", spec.mode,
                       site, tick, "any" if rank is None else rank)
        # chaos is observable, not just survivable: injections land on
        # the activated telemetry's event bus (no-op without one)
        from ray_lightning_tpu_torch import obs
        obs.emit_global("fault.injected", site=site, tick=tick,
                        mode=spec.mode)
        tel = obs.get_global()
        if tel is not None:
            tel.metrics.counter(
                "reliability_faults_total",
                help="faults injected by the armed FaultPlan").inc()
        if spec.mode == MODE_RAISE:
            raise InjectedFault(site, tick)
        if spec.mode == MODE_EXIT:
            if os.environ.get(WORKER_PROCESS_ENV):
                # the no-exception death (OOM-killer, preemption): no
                # unwind, no teardown, the pipe just goes quiet
                os._exit(17)
            logger.warning(
                "worker.exit fired outside a spawned worker process; "
                "degrading to raise so in-process backends survive")
            raise InjectedFault(site, tick)
        if spec.mode == MODE_STALL:
            self._sleep(spec.stall_s)
        return spec.mode

    def poison_check(self, requests: Iterable) -> None:
        """Crash iff any of ``requests`` is a scheduled poison id.

        ``requests`` may hold Request objects (matched on ``.id``) or
        bare ids — engines pass whatever container the call site already
        holds (``active_requests`` keys, a seated batch, one chunk
        state's request). Unlike :meth:`fire`, the poison site has no
        tick schedule: a hit fires *every* time the id is present, which
        is what makes it a deterministic poison rather than a transient
        fault. The tick recorded on the :class:`InjectedFault` is the
        running hit count (for logs/events only).
        """
        if not self.poison:
            return
        hit = None
        for r in requests:
            rid = getattr(r, "id", r)
            if rid in self.poison:
                hit = rid
                break
        if hit is None:
            return
        tick = self._counts[SITE_SERVE_POISON]
        self._counts[SITE_SERVE_POISON] = tick + 1
        self.fired += 1
        logger.warning("injecting poison crash: request %d present "
                       "(hit %d, mode %s)", hit, tick, self.poison_mode)
        from ray_lightning_tpu_torch import obs
        obs.emit_global("fault.injected", site=SITE_SERVE_POISON,
                        tick=tick, mode=self.poison_mode, request=hit)
        tel = obs.get_global()
        if tel is not None:
            tel.metrics.counter(
                "reliability_faults_total",
                help="faults injected by the armed FaultPlan").inc()
        if self.poison_mode == MODE_EXIT:
            if os.environ.get(WORKER_PROCESS_ENV):
                os._exit(17)
            logger.warning(
                "poison exit fired outside a spawned worker process; "
                "degrading to raise so in-process backends survive")
        raise InjectedFault(SITE_SERVE_POISON, tick)

    # ------------------------------------------------------------ arming
    def armed(self):
        """Context manager: install this plan as the process-global one."""
        return _Armed(self)


class _Armed:
    def __init__(self, plan: FaultPlan):
        self._plan = plan

    def __enter__(self) -> FaultPlan:
        arm(self._plan)
        return self._plan

    def __exit__(self, *exc_info) -> None:
        disarm()


_ACTIVE: Optional[FaultPlan] = None
_LOCK = threading.Lock()


def arm(plan: FaultPlan) -> None:
    global _ACTIVE
    with _LOCK:
        if _ACTIVE is not None and _ACTIVE is not plan:
            raise RuntimeError(
                "a FaultPlan is already armed; disarm() it first "
                "(nested plans would make tick counters ambiguous)")
        _ACTIVE = plan


def disarm() -> None:
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


def get_armed() -> Optional[FaultPlan]:
    """The currently armed plan (None when disarmed). Remote launchers
    use this to ship the active plan into worker processes."""
    return _ACTIVE


def ensure_armed(plan: FaultPlan) -> bool:
    """Arm ``plan`` iff nothing is armed yet; returns whether this call
    armed it (and therefore owns the matching ``disarm()``).

    The worker-side seat of plan shipping: a spawned worker process arms
    the shipped copy; an in-process fake "worker" sees the driver's plan
    already armed and leaves it alone (one tick ledger per process).
    """
    global _ACTIVE
    with _LOCK:
        if _ACTIVE is None:
            _ACTIVE = plan
            return True
        return False


def fire(site: str, rank: Optional[int] = None) -> Optional[str]:
    """Hot-path hook: no-op (one global read) unless a plan is armed."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.fire(site, rank)


def poison_check(requests: Iterable) -> None:
    """Hot-path hook for :data:`SITE_SERVE_POISON`: no-op (one global
    read + an empty-set check) unless an armed plan carries poison ids."""
    plan = _ACTIVE
    if plan is None or not plan.poison:
        return
    plan.poison_check(requests)
