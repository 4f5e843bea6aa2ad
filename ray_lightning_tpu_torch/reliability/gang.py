"""Gang supervision: heartbeats, hang detection, coordinated restart (copied from ``ray_lightning_tpu/reliability/gang.py``).

The reference's fault model for distributed fits is fail-fast only: a
dead worker surfaces as a raised ``ray.get`` and recovery belongs to
Tune (SURVEY.md §5; ``teardown_workers``'s docstring). That leaves two
production failure classes unhandled at the launcher layer:

- a worker that **hangs** (wedged collective, stuck host callback, NIC
  partition) raises nothing — ``ray.wait`` polls forever and the driver
  wedges with it;
- a worker that **dies** kills the whole fit with no respawn, even
  though every completed epoch is sitting in a checkpoint.

This module closes both gaps with the classic elastic-training shape
(TorchElastic-style gang restart from the last committed checkpoint):

1. **Heartbeats** — each remote worker's trainer loop ticks a per-rank
   :class:`HeartbeatEmitter` (step count + worker monotonic time)
   through a lightweight driver-owned channel; the driver re-stamps
   each beat with its *own* clock on receipt, so cross-host clock skew
   never enters the timeout math.
2. **Detection** — the driver's result poll doubles as a watchdog: a
   rank silent past ``heartbeat_timeout`` (or an actor death) escalates
   to a :class:`GangFailure` carrying a per-rank
   :class:`RankPostmortem` (last step, beat age, node IP). Peers wedged
   in a collective with the failed rank will never exit on their own,
   so the launcher kills the *full gang* on the way out rather than
   waiting for stragglers.
3. **Coordinated restart** — :class:`GangSupervisor` (a
   :class:`~ray_lightning_tpu_torch.reliability.supervisor.FitSupervisor`)
   catches the failure, lets the launcher tear the gang down, and
   re-launches: a fresh ``setup_workers`` probes a *fresh* rendezvous
   port (a half-dead store on the old port must never adopt the new
   world) and the fit resumes via ``ckpt_path="auto"`` under the usual
   :class:`~ray_lightning_tpu_torch.reliability.retry.RetryPolicy` —
   bounded attempts, deterministic backoff.

In the port a rank is one process owning one card (or the CPU) in a
``torch.distributed`` group: the teardown kills every worker process
without a collective and without ``destroy_process_group`` (a rank that
died inside a NCCL or gloo communicator leaves its peers blocked in it),
and the driver takes the world's collective timeout from the
:class:`GangConfig` (:meth:`GangConfig.collective_timeout`). Everything
runs on the in-process fakes and the subprocess backend, so CPU tests
hold kill-and-resume identity and bounded-time hang detection.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ray_lightning_tpu_torch.reliability import log_suppressed, logger
from ray_lightning_tpu_torch.reliability.retry import RetryPolicy
from ray_lightning_tpu_torch.reliability.supervisor import FitSupervisor

#: telemetry sites emitted by the gang layer
EVENT_HEARTBEAT_MISSED = "worker.heartbeat_missed"
EVENT_WORKER_DEAD = "worker.dead"
EVENT_WORKER_ERROR = "worker.error"
EVENT_GANG_TEARDOWN = "gang.teardown"
EVENT_GANG_RESTART = "gang.restart"
EVENT_GANG_RESIZE = "gang.resize"

GAUGE_ALIVE_WORKERS = "gang_alive_workers"
COUNTER_RESTARTS = "gang_restarts_total"
COUNTER_ELASTIC_RESIZES = "gang_elastic_resizes_total"


@dataclasses.dataclass(frozen=True)
class GangConfig:
    """Arms gang supervision on a launcher (``None`` = disarmed, the
    default — no channel, no monitor, zero per-step cost).

    ``heartbeat_timeout``: seconds a rank may go beat-less once it has
    completed its first step before the gang is declared failed. Beats
    come from the worker's *main* training loop — a background thread
    would keep beating while the main thread is wedged in a collective,
    which is exactly the hang this exists to catch — so the timeout
    must cover the slowest legitimate between-beat gap (a step + any
    epoch-end validation/checkpoint work).

    ``startup_grace``: the more generous window that applies until a
    rank's first *step* beat (``None`` = same as the timeout). Worker
    startup legitimately goes quiet for long stretches (interpreter
    spawn, torch import, the CUDA context, the kernels' builds or loads
    in the first step), none of which is a hang.

    ``heartbeat_interval``: worker-side throttle — beats closer
    together than this are dropped (0 = beat every step; fine for the
    tiny per-beat cost, and what the deterministic tests use).

    ``clock``: injectable driver-side monotonic clock (tests pin the
    timeout arithmetic without wall time).
    """
    heartbeat_timeout: float = 60.0
    startup_grace: Optional[float] = 300.0
    heartbeat_interval: float = 0.0
    clock: Callable[[], float] = time.monotonic

    def collective_timeout(self) -> float:
        """Seconds a rank of an armed gang waits in the rendezvous or a
        collective before it raises: the longer of the timeout and the
        startup grace (the first step's collectives may wait on a peer
        still loading its kernels). A collective blocked longer than
        this is past the watchdog's own verdict, so nothing waits on a
        dead peer for the default process-group timeout."""
        grace = self.startup_grace
        return max(self.heartbeat_timeout,
                   self.heartbeat_timeout if grace is None else grace)


@dataclasses.dataclass
class RankPostmortem:
    """What the driver knew about one rank when the gang failed."""
    rank: int
    last_step: int            # -1 = never completed a step
    last_beat_age_s: float    # driver-clock seconds since the last beat
    beats: int                # total beats received
    node_ip: Optional[str]    # from the launcher's rank map
    silent: bool = False      # past its timeout at detection
    dead: bool = False        # actor process observed dead

    def describe(self) -> str:
        flags = "".join(
            [" SILENT" if self.silent else "", " DEAD" if self.dead else ""])
        return (f"rank {self.rank}: last_step={self.last_step} "
                f"last_beat_age={self.last_beat_age_s:.2f}s "
                f"beats={self.beats} node={self.node_ip or '?'}{flags}")


class GangFailure(RuntimeError):
    """A distributed fit lost gang integrity: a rank went silent past its
    heartbeat timeout, died, or raised — carrying the per-rank postmortem
    the driver assembled at detection. The launcher kills the full gang
    on unwind (peers wedged in a collective never exit on their own);
    :class:`GangSupervisor` treats this as retryable."""

    def __init__(self, reason: str,
                 postmortems: Dict[int, RankPostmortem],
                 detail: str = ""):
        self.reason = reason
        self.postmortems = dict(postmortems)
        lines = [f"gang failure ({reason})"
                 + (f": {detail}" if detail else "")]
        lines += ["  " + pm.describe()
                  for _, pm in sorted(self.postmortems.items())]
        super().__init__("\n".join(lines))


class HeartbeatEmitter:
    """Worker-side beat source: ``beat(step)`` puts ``(rank, step,
    worker_monotonic)`` on the driver-owned channel. Never raises — a
    dying channel (driver mid-teardown) must not take the worker's
    training loop down with it."""

    def __init__(self, channel: Any, rank: int, interval: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        self._channel = channel
        self._rank = rank
        self._interval = interval
        self._clock = clock
        self._last: Optional[float] = None

    def beat(self, step: int) -> None:
        now = self._clock()
        # liveness markers (step < 0: entry / post-rendezvous) always
        # send; step beats honor the throttle
        if (self._interval and step >= 0 and self._last is not None
                and now - self._last < self._interval):
            return
        self._last = now
        try:
            self._channel.put((self._rank, int(step), now))
        except Exception as exc:  # noqa: BLE001 — worker must outlive channel
            log_suppressed("gang.heartbeat", exc,
                           "heartbeat channel unavailable; beat dropped")


def actor_alive(worker: Any) -> bool:
    """Best-effort liveness probe across backends: subprocess actors
    expose ``_proc``, fakes expose ``_killed``, real Ray handles (no
    cheap local probe) default to alive — death still surfaces through
    the failed future that triggered the probe."""
    if getattr(worker, "_dead", False):
        # the process backend's reader thread latches ``_dead`` the
        # moment it observes the pipe EOF — BEFORE it fails the future
        # whose failure triggers this probe. Authoritative, and immune
        # to the race below: ``is_alive()`` polls waitpid, which can
        # still report a just-exited child as running in the window
        # between its connection teardown and process teardown, so a
        # hard-killed worker could read "alive" and get classified
        # worker.error instead of worker.dead (a load-dependent flake
        # the full suite surfaced)
        return False
    proc = getattr(worker, "_proc", None)
    if proc is not None:
        try:
            return bool(proc.is_alive())
        except Exception as exc:  # noqa: BLE001 — probe is advisory only
            log_suppressed("gang.liveness_probe", exc,
                           "cannot probe actor process; assuming alive")
            return True
    return not getattr(worker, "_killed", False)


class GangMonitor:
    """Driver-side beat ledger + watchdog arithmetic for one launch.

    ``start()`` stamps every rank "just seen" when the result poll
    begins; ``drain(channel)`` folds received beats in; ``silent_ranks``
    applies the timeout (``startup_grace`` until a rank's first step
    beat); the ``*_failure`` builders emit the detection telemetry and
    assemble the :class:`GangFailure` the launcher raises.
    """

    def __init__(self, num_workers: int, config: GangConfig,
                 node_ips: Optional[Sequence[str]] = None,
                 telemetry: Any = None):
        self.num_workers = num_workers
        self.config = config
        self._clock = config.clock
        self._node_ips = list(node_ips or [])
        self._tel = telemetry
        now = self._clock()
        self._last_beat = {r: now for r in range(num_workers)}
        self._last_step = {r: -1 for r in range(num_workers)}
        self._beats = {r: 0 for r in range(num_workers)}
        self._done: set = set()

    # ------------------------------------------------------------ beats
    def start(self) -> None:
        """Re-stamp all ranks at watchdog start: time spent between actor
        setup and dispatch must not count against the timeout."""
        now = self._clock()
        for r in range(self.num_workers):
            self._last_beat[r] = now
        if self._tel is not None:
            self._tel.metrics.gauge(
                GAUGE_ALIVE_WORKERS,
                help="workers currently believed alive by the gang "
                     "monitor").set(self.num_workers)

    def observe(self, rank: int, step: int,
                worker_time: Optional[float] = None) -> None:
        """Fold one beat in. The beat is re-stamped with the *driver*
        clock — ``worker_time`` is informational (skew-prone)."""
        if rank not in self._last_beat:
            return  # stray beat from a previous generation's channel
        self._last_beat[rank] = self._clock()
        if step > self._last_step[rank]:
            self._last_step[rank] = step
        self._beats[rank] += 1

    def drain(self, channel: Any) -> None:
        if channel is None:
            return
        while True:
            try:
                item = channel.get(block=False)
            except (_queue.Empty, EOFError, OSError):
                return
            if isinstance(item, tuple) and len(item) == 3:
                self.observe(item[0], item[1], item[2])

    def mark_done(self, rank: int) -> None:
        """Rank's future resolved successfully: it stops beating *by
        design*, so it must leave the silence verdict (completion skew —
        fast ranks finishing long before slow ones — is not a hang)."""
        self._done.add(rank)

    def seed(self, rank: int, *, last_beat: float, last_step: int,
             beats: int) -> None:
        """Carry one rank's ledger entry in from a previous monitor
        generation. The fleet rebuilds its monitor on every membership
        change but a surviving member's silence clock must NOT reset
        with it — churn recurring faster than ``heartbeat_timeout``
        would otherwise defer a wedged member's hang verdict forever,
        and postmortems taken right after a rebuild would report
        freshly-stamped ages instead of real ones."""
        if rank in self._last_beat:
            self._last_beat[rank] = last_beat
            self._last_step[rank] = last_step
            self._beats[rank] = beats

    # ---------------------------------------------------------- verdicts
    def silent_ranks(self) -> List[int]:
        now = self._clock()
        timeout = self.config.heartbeat_timeout
        grace = self.config.startup_grace
        grace = timeout if grace is None else max(grace, timeout)
        out = []
        for r in range(self.num_workers):
            if r in self._done:
                continue
            threshold = grace if self._last_step[r] < 1 else timeout
            if now - self._last_beat[r] > threshold:
                out.append(r)
        return out

    def postmortems(self, silent: Sequence[int] = (),
                    dead: Sequence[int] = ()) -> Dict[int, RankPostmortem]:
        now = self._clock()
        return {
            r: RankPostmortem(
                rank=r,
                last_step=self._last_step[r],
                last_beat_age_s=max(0.0, now - self._last_beat[r]),
                beats=self._beats[r],
                node_ip=(self._node_ips[r]
                         if r < len(self._node_ips) else None),
                silent=r in silent,
                dead=r in dead)
            for r in range(self.num_workers)
        }

    def _mark_lost(self, lost: Sequence[int]) -> None:
        if self._tel is not None:
            self._tel.metrics.gauge(
                GAUGE_ALIVE_WORKERS,
                help="workers currently believed alive by the gang "
                     "monitor").set(self.num_workers - len(set(lost)))

    def heartbeat_failure(self, silent: Sequence[int]) -> GangFailure:
        """Ranks beat-less past their timeout: the hang verdict."""
        pms = self.postmortems(silent=silent)
        for r in silent:
            logger.error("gang: rank %d silent past heartbeat timeout "
                         "(%s)", r, pms[r].describe())
            if self._tel is not None:
                self._tel.event(EVENT_HEARTBEAT_MISSED, rank=r,
                                last_step=pms[r].last_step,
                                beat_age_s=round(pms[r].last_beat_age_s, 3))
        self._mark_lost(silent)
        return GangFailure(
            EVENT_HEARTBEAT_MISSED, pms,
            detail=f"rank(s) {sorted(silent)} silent past "
                   f"{self.config.heartbeat_timeout}s; killing the gang "
                   "(wedged peers never exit on their own)")

    def worker_failure(self, rank: int, exc: BaseException,
                       dead: bool) -> GangFailure:
        """A rank's future failed: death (process gone) or error."""
        site = EVENT_WORKER_DEAD if dead else EVENT_WORKER_ERROR
        pms = self.postmortems(dead=[rank] if dead else ())
        logger.error("gang: rank %d %s: %s (%s)", rank,
                     "died" if dead else "raised", exc, pms[rank].describe())
        if self._tel is not None:
            self._tel.event(site, rank=rank, exc=type(exc).__name__,
                            last_step=pms[rank].last_step)
        self._mark_lost([rank])
        return GangFailure(
            site, pms,
            detail=f"rank {rank} "
                   f"{'died' if dead else 'raised'}: "
                   f"{type(exc).__name__}: {exc}")


class GangSupervisor(FitSupervisor):
    """Run a *distributed* fit to completion under a retry policy.

    The gang analog of :class:`FitSupervisor`: ``make_trainer`` builds a
    fresh trainer (and, through it, a fresh launcher) per attempt, so
    every restart re-runs ``setup_workers`` — new actors, a freshly
    probed rendezvous port, a fresh process group — and
    resumes via ``ckpt_path="auto"`` from the newest checkpoint the
    previous attempt committed. :class:`GangFailure` postmortems are
    collected on ``self.failures``; each restart emits a
    ``gang.restart`` event and bumps ``gang_restarts_total`` on the
    ``telemetry`` handle (``None`` = disarmed, nothing is allocated).

    **Restart backoff.** Consecutive restarts are spaced by a capped
    exponential delay (``restart_backoff * 2**(restarts-1)``, capped at
    ``restart_backoff_cap``) on top of the policy's per-attempt backoff,
    so a crash-looping gang never hot-spins actor respawns on a busy
    host. The delay goes through the injectable ``sleep`` — tests stay
    wall-clock-free — and each applied delay is recorded on
    ``self.restart_delays``.

    **Elastic world size.** With ``elastic=True`` the supervisor reads
    each :class:`GangFailure`'s postmortems: ranks flagged ``dead`` or
    ``silent`` are treated as lost *capacity* (their host is presumed
    gone — a raised worker error leaves capacity intact and restarts at
    full size). When the attached ``standby`` pool cannot cover the
    loss warm, the next attempt restarts at the surviving worker count
    via ``trainer.strategy.set_world_size(...)`` — the fit then resumes
    from the newest checkpoint, re-sharded onto the smaller world by
    the restore path (``core/checkpoint.py:reshard_state``). The
    shrink persists across later attempts and never goes below
    ``min_world_size``; a loss that would means a full-size (respawn-
    bound, but correct) restart instead. Scale back UP by re-running
    the supervisor at full size once capacity returns — the same
    re-shard-on-restore contract covers M→N.
    """

    def __init__(self, make_trainer: Callable[[], Any],
                 policy: Optional[RetryPolicy] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 telemetry: Any = None,
                 standby: Optional[Any] = None,
                 elastic: bool = False,
                 min_world_size: int = 1,
                 restart_backoff: float = 0.5,
                 restart_backoff_cap: float = 30.0):
        super().__init__(make_trainer, policy, sleep)
        if min_world_size < 1:
            raise ValueError(
                f"min_world_size must be >= 1, got {min_world_size}")
        if restart_backoff < 0 or restart_backoff_cap < 0:
            raise ValueError("restart backoff values must be >= 0")
        self.telemetry = telemetry
        self.standby = standby
        self.elastic = bool(elastic)
        self.min_world_size = int(min_world_size)
        self.restart_backoff = float(restart_backoff)
        self.restart_backoff_cap = float(restart_backoff_cap)
        self.restarts = 0
        self.failures: List[GangFailure] = []
        self.restart_delays: List[float] = []
        self.resizes: List[tuple] = []
        self._target_world: Optional[int] = None

    # FitSupervisor hooks -------------------------------------------------
    def _record_failure(self, exc: BaseException) -> None:
        if isinstance(exc, GangFailure):
            self.failures.append(exc)
            if self.elastic:
                self._plan_world_size(exc)

    def _plan_world_size(self, failure: GangFailure) -> None:
        """Decide the next attempt's world size from the postmortems."""
        world = len(failure.postmortems)
        lost = [r for r, pm in failure.postmortems.items()
                if pm.dead or pm.silent]
        if not lost:
            return  # error-class failure: capacity intact, full restart
        if self.standby is not None \
                and self.standby.live_available() >= len(lost):
            return  # live warm replacements cover the loss: same world size
        surviving = world - len(lost)
        if surviving >= self.min_world_size:
            self._target_world = surviving
        else:
            # below the floor: a full-size restart (respawn-bound, but
            # correct) beats running a gang too small to be useful
            self._target_world = None
            logger.warning(
                "gang: %d surviving rank(s) < min_world_size=%d; "
                "restarting at full size instead of shrinking",
                surviving, self.min_world_size)

    def _prepare_trainer(self, trainer: Any) -> Any:
        target = self._target_world
        strategy = getattr(trainer, "strategy", None)
        if target is None or strategy is None \
                or strategy.num_workers == target:
            return trainer
        prev = strategy.num_workers
        strategy.set_world_size(target)
        self.resizes.append((prev, target))
        logger.warning("gang: elastic restart at world size %d (was %d)",
                       target, prev)
        tel = self.telemetry
        if tel is not None:
            tel.event(EVENT_GANG_RESIZE, from_world=prev, to_world=target,
                      min_world_size=self.min_world_size)
            tel.metrics.counter(
                COUNTER_ELASTIC_RESIZES,
                help="gang restarts that resumed at a smaller world "
                     "size").inc()
        return trainer

    def _on_retry(self, attempt: int) -> None:
        self.restarts += 1
        tel = self.telemetry
        if tel is not None:
            tel.event(EVENT_GANG_RESTART, attempt=attempt,
                      restarts=self.restarts,
                      standby_available=(self.standby.available()
                                         if self.standby is not None
                                         else 0))
            tel.metrics.counter(
                COUNTER_RESTARTS,
                help="coordinated gang restarts performed by "
                     "GangSupervisor").inc()
        if self.restart_backoff:
            delay = min(self.restart_backoff_cap,
                        self.restart_backoff * 2.0 ** (self.restarts - 1))
            self.restart_delays.append(delay)
            self._sleep(delay)
