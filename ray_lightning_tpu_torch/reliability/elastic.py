"""Elastic gang recovery: warm standbys and in-memory checkpoint tiers (counterpart of ``ray_lightning_tpu/reliability/elastic.py``).

Gang supervision makes distributed-fit failures *detected* in bounded
time, but a cold restart pays a worker spawn, the interpreter, the torch
import, the CUDA context and the kernels' loads before the first step,
and it is locked to a fixed world size. This module supplies the two
recovery tiers that take those costs off the critical path
(TorchElastic / Elastic Horovod in spirit):

- :class:`StandbyPool` -- **warm-standby workers**: ``num_standby``
  extra executor actors spawned *off* the critical path (a background
  refill thread, dispatched while the gang trains) that have already
  paid the process spawn, the package import, the CUDA context and the
  kernel loads (:func:`standby_warmup`). On restart, ``RayLauncher``
  *promotes* a standby into each rank slot it can (``standby.promoted``
  event) instead of spawning cold. A full-gang restart needs a fresh
  process per rank (the old gang is always killed whole -- wedged peers
  cannot be reused), so size ``num_standby >= num_workers`` to keep
  spawn entirely off the recovery path.
- :class:`MemoryCheckpointStore` -- **peer-replicated in-memory
  checkpoints**: the last-``keep_last`` committed train states held in
  host RAM, each replicated to its owner rank's *ring buddy*
  (``(rank + 1) % world``) so one lost host does not lose the copy.
  ``resume="auto"`` consults this tier **ahead of disk** (newest step
  wins; ties go to memory) and falls back to the on-disk scan when the
  buddy died too (:meth:`MemoryCheckpointStore.drop_rank`). On remote
  launchers the replication rides the same driver-owned channel
  machinery as heartbeats: workers ship commits through a
  :class:`MemoryCheckpointClient`, the driver's watchdog poll drains
  them into the store, and each (re)launch ships the current resume
  candidates back out with the dispatch.

**Everything the store holds is on the host.** The trainer copies every
tensor of a checkpoint into CPU memory before ``put``
(``core/checkpoint.py:host_copy``), so the channel never carries a CUDA
tensor: one pickled across processes would travel as a CUDA IPC handle,
which dies with the process that made it -- exactly the death this tier
must survive.

Both tiers follow the ``FaultPlan`` arming contract: nothing is
allocated and every hot-path hook is one global read + ``None`` check
until a store is installed (:func:`install_memory_store` /
``store.installed()``) or a pool is attached
(``RayLauncher(standby=...)``).
"""
from __future__ import annotations

import copy
import queue as _queue
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_lightning_tpu_torch.reliability import log_suppressed, logger

#: telemetry sites/metrics of the elastic layer
EVENT_STANDBY_PROMOTED = "standby.promoted"
EVENT_MEMORY_RESUME = "ckpt.memory_resume"
EVENT_CKPT_RESHARD = "ckpt.reshard"
GAUGE_STANDBY_AVAILABLE = "gang_standby_available"
COUNTER_STANDBY_PROMOTIONS = "gang_standby_promotions_total"
COUNTER_RESHARDS = "ckpt_reshards_total"

#: channel message tag for replicated in-memory checkpoints
_MEMCKPT_TAG = "memckpt"


def ring_buddy(rank: int, world_size: int) -> int:
    """The neighbor rank holding ``rank``'s in-memory checkpoint replica.

    A ring is the cheapest replication topology that survives any single
    host loss: rank ``r``'s copy lives on ``(r + 1) % world`` — losing
    ``r`` leaves the replica, losing the buddy leaves the original, and
    only losing *both* neighbors falls back to disk.
    """
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    return (rank + 1) % world_size


def standby_warmup() -> bool:
    """Default standby warm-up body, run inside the standby actor.

    Pays exactly the costs a cold gang restart pays on this card before
    its first step: the package and torch import (pickling this module
    function into a spawned worker forces them), the CUDA context on the
    rank's device (the first visible card: the launcher gives a worker
    its own card's index when it promotes it), and the load of every
    kernel extension already built (``_build.load_built``), so a
    promoted worker compiles and loads nothing. On a host without a card
    only the imports are paid."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.init()
        torch.empty(1, device="cuda")     # the context on the card
        from ray_lightning_tpu_torch import _build
        _build.load_built()
    return True


class StandbyPool:
    """Pre-spawned warm executor actors that make gang restarts
    promotion-bound instead of spawn-bound.

    ``ray_module`` is the same ray-compatible backend the launcher uses
    (real Ray, :class:`~ray_lightning_tpu_torch.launchers.process_backend.ProcessRay`,
    or a fake); the pool never creates actors itself — the launcher
    hands it its own actor factory, so standbys are scheduled with
    exactly the resources a gang worker gets. ``warmup`` runs inside
    each standby right after spawn (default: :func:`standby_warmup`)
    and its future is resolved at :meth:`take` time, so an
    already-warm standby promotes instantly.

    Lifecycle: the pool is **caller-owned** (it deliberately survives
    the launcher's full-gang teardown — that is the whole point); call
    :meth:`shutdown` when done or idle standbys leak. The process-
    backend tests pin "zero live actors after fit teardown + pool
    shutdown".
    """

    def __init__(self, ray_module: Any, num_standby: int = 1,
                 warmup: Optional[Callable[[], Any]] = standby_warmup,
                 telemetry: Any = None,
                 warmup_timeout: Optional[float] = 60.0):
        if num_standby < 0:
            raise ValueError(
                f"num_standby must be >= 0, got {num_standby}")
        self._ray = ray_module
        self.num_standby = int(num_standby)
        self._warmup = warmup
        self.warmup_timeout = warmup_timeout
        self._tel = telemetry
        self._lock = threading.Lock()
        # (actor handle, pending warmup future | None), FIFO
        self._idle: List[Tuple[Any, Any]] = []
        self._refill_thread: Optional[threading.Thread] = None
        self._closed = False
        self.promotions = 0
        self.spawned = 0

    # ------------------------------------------------------------- fill
    def available(self) -> int:
        """Standbys currently idle (warm or still warming)."""
        with self._lock:
            return len(self._idle)

    def live_available(self) -> int:
        """Idle standbys that still pass the liveness duck-probe; dead
        ones are dropped (and killed) on the way. The elastic policy
        uses this instead of :meth:`available` — a host death can take
        a gang worker AND its co-located standby, and counting the
        corpse as a warm replacement would skip the shrink the policy
        promised, paying a cold respawn instead."""
        from ray_lightning_tpu_torch.reliability.gang import actor_alive
        with self._lock:
            idle = list(self._idle)
        dead = [pair for pair in idle if not actor_alive(pair[0])]
        if dead:
            with self._lock:
                self._idle = [p for p in self._idle if p not in dead]
            for actor, _warm in dead:
                self._kill(actor)
            self._gauge()
        return self.available()

    def fill(self, make_actor: Callable[[], Any]) -> int:
        """Spawn standbys up to ``num_standby``; returns how many were
        created. Safe to call repeatedly (idempotent at capacity)."""
        created = 0
        while not self._closed:
            with self._lock:
                if len(self._idle) >= self.num_standby:
                    break
            actor = make_actor()
            warm_ref = None
            if self._warmup is not None:
                warm_ref = actor.execute.remote(self._warmup)
            with self._lock:
                if self._closed:  # raced shutdown: do not leak the spawn
                    self._kill(actor)
                    break
                self._idle.append((actor, warm_ref))
                self.spawned += 1
                created += 1
        self._gauge()
        return created

    def refill_async(self, make_actor: Callable[[], Any]) -> None:
        """Top the pool back up on a background thread.

        This is how spawn cost stays OFF the recovery critical path:
        the launcher calls it right after dispatching the (re)started
        gang, so the replacement standby warms while the workers train.
        """
        with self._lock:
            if self._closed or len(self._idle) >= self.num_standby:
                return
            if self._refill_thread is not None \
                    and self._refill_thread.is_alive():
                return

            def _run():
                try:
                    self.fill(make_actor)
                except Exception as exc:  # noqa: BLE001 — bg thread must not die loudly
                    log_suppressed(
                        "standby.refill", exc,
                        "background standby refill failed; the pool "
                        "stays short and the next restart spawns cold")

            self._refill_thread = threading.Thread(
                target=_run, name="tl-standby-refill", daemon=True)
            self._refill_thread.start()

    # ------------------------------------------------------------- take
    def take(self) -> Optional[Any]:
        """Pop a live, warmed standby (waiting at most ``warmup_timeout``
        on its warm-up future if it is still in flight), or ``None``
        when the pool is empty. Dead standbys — and standbys wedged in
        warm-up past the timeout — are dropped and the next one is
        tried: this sits on the gang-restart critical path, where the
        watchdog is not yet running, so an unbounded wait here would
        reintroduce exactly the hang-forever failure mode supervision
        exists to remove."""
        from ray_lightning_tpu_torch.reliability.gang import actor_alive
        while True:
            with self._lock:
                if not self._idle:
                    return None
                actor, warm_ref = self._idle.pop(0)
            try:
                if warm_ref is not None:
                    self._ray.get(warm_ref, timeout=self.warmup_timeout)
            except Exception as exc:  # noqa: BLE001 — a dead/wedged standby is droppable
                log_suppressed("standby.take", exc,
                               "standby died or wedged during warm-up; "
                               "dropped")
                self._kill(actor)
                continue
            if not actor_alive(actor):
                self._kill(actor)
                continue
            self.promotions += 1
            self._gauge()
            return actor

    # --------------------------------------------------------- teardown
    def shutdown(self) -> None:
        """Kill every idle standby and stop refilling. Idempotent."""
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
            thread = self._refill_thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=60)
        for actor, _warm in idle:
            self._kill(actor)
        self._gauge()

    def _kill(self, actor: Any) -> None:
        try:
            self._ray.kill(actor, no_restart=True)
        except Exception as exc:  # noqa: BLE001 — best-effort cleanup
            log_suppressed("standby.kill", exc,
                           "could not kill standby actor")

    def _gauge(self) -> None:
        if self._tel is not None:
            with self._lock:
                n = len(self._idle)
            self._tel.metrics.gauge(
                GAUGE_STANDBY_AVAILABLE,
                help="warm standby workers currently idle in the "
                     "pool").set(n)


class MemoryCheckpointStore:
    """Last-``keep_last`` committed train states in host RAM, replicated
    to each owner rank's ring buddy.

    Layout: ``_held[holder_rank][(owner_rank, step)] = payload`` — every
    ``put`` lands the payload under the owner *and* its
    :func:`ring_buddy`, so :meth:`drop_rank` (a host died: its RAM, own
    entries AND the replicas it held for its neighbor, all gone) models
    exactly the failure the ring protects against. Payloads are
    host-deep-copied on ``put`` and on read, so neither side can
    mutate a stored checkpoint.

    The store is what the DRIVER owns; remote workers talk to it
    through a :class:`MemoryCheckpointClient` over the launcher's
    channel machinery. It is installed process-globally
    (:func:`install_memory_store` / ``with store.installed():``) the
    same way a :class:`~ray_lightning_tpu_torch.reliability.faults.FaultPlan`
    is armed — nothing in the trainer allocates until then.
    """

    def __init__(self, keep_last: int = 2):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.keep_last = int(keep_last)
        self._lock = threading.Lock()
        self._held: Dict[int, "OrderedDict[Tuple[int, int], Any]"] = {}
        self.puts = 0

    # -------------------------------------------------------------- put
    def put(self, step: int, ckpt: Dict[str, Any], rank: int = 0,
            world_size: int = 1, copy_payload: bool = True) -> None:
        """Commit one checkpoint payload under ``rank`` and its buddy.

        ``ckpt`` must already live in host memory (the trainer copies
        every tensor to the CPU before putting, ``host_copy``); it is
        deep-copied once here so later training steps can never alias
        into the stored copy.
        ``copy_payload=False`` skips that copy for payloads the store
        may own outright — e.g. :meth:`drain`'s channel arrivals, which
        were freshly unpickled and are referenced nowhere else (a
        second copy there would transiently double host RAM per commit
        for large states).
        """
        payload = copy.deepcopy(ckpt) if copy_payload else ckpt
        buddy = ring_buddy(rank, max(1, int(world_size)))
        key = (int(rank), int(step))
        with self._lock:
            self.puts += 1
            for holder in {int(rank), buddy}:
                held = self._held.setdefault(holder, OrderedDict())
                held.pop(key, None)
                held[key] = payload
                mine = [k for k in held if k[0] == key[0]]
                while len(mine) > self.keep_last:
                    held.pop(mine.pop(0), None)

    def drain(self, channel: Any) -> int:
        """Fold replicated commits shipped by workers into the store;
        returns how many were absorbed. Same non-blocking contract as
        ``GangMonitor.drain`` — the driver's watchdog poll calls this."""
        if channel is None:
            return 0
        absorbed = 0
        while True:
            try:
                item = channel.get(block=False)
            except (_queue.Empty, EOFError, OSError):
                return absorbed
            if isinstance(item, tuple) and len(item) == 5 \
                    and item[0] == _MEMCKPT_TAG:
                _tag, rank, world, step, payload = item
                # freshly unpickled off the channel: the store owns it
                self.put(step, payload, rank=rank, world_size=world,
                         copy_payload=False)
                absorbed += 1

    # ------------------------------------------------------------- read
    def resume_candidates(self, copy_payloads: bool = True
                          ) -> List[Tuple[int, Dict[str, Any]]]:
        """``[(step, ckpt)]`` newest-first across every surviving holder
        (deduped by owner+step). Payloads are fresh copies by default;
        ``copy_payloads=False`` hands out the stored objects for callers
        that copy anyway (the launcher pickles them into each dispatch)
        or copy lazily (the trainer copies only the one candidate it
        actually restores) — eager copies of every held multi-GB state
        would double peak host RAM for nothing."""
        with self._lock:
            merged: Dict[Tuple[int, int], Any] = {}
            for held in self._held.values():
                merged.update(held)
        ordered = sorted(merged.items(), key=lambda kv: kv[0][1],
                         reverse=True)
        return [(step,
                 copy.deepcopy(payload) if copy_payloads else payload)
                for (_owner, step), payload in ordered]

    def latest_step(self) -> int:
        with self._lock:
            steps = [s for held in self._held.values() for (_r, s) in held]
        return max(steps) if steps else -1

    # --------------------------------------------------------- failures
    def drop_rank(self, rank: int) -> None:
        """Rank ``rank``'s host died: its RAM — own entries and the
        replicas it was holding for its ring neighbor — is gone."""
        with self._lock:
            self._held.pop(int(rank), None)

    def clear(self) -> None:
        with self._lock:
            self._held.clear()

    def shutdown(self) -> None:
        """Teardown path (lint contract): drop every held payload."""
        self.clear()

    # ------------------------------------------------------ global seat
    def installed(self) -> "_Installed":
        """``with store.installed(): ...`` — process-global registration
        scoped to the block (restores whatever was installed before)."""
        return _Installed(self)


class MemoryCheckpointClient:
    """Worker-side face of the driver's :class:`MemoryCheckpointStore`.

    ``put`` ships the commit over the driver-owned channel (never
    raises — a dying channel mid-teardown must not take the training
    loop down, the :class:`HeartbeatEmitter` contract);
    ``resume_candidates`` serves the candidate list the launcher shipped
    with this dispatch.
    """

    def __init__(self, channel: Any, rank: int = 0, world_size: int = 1,
                 candidates: Optional[List[Tuple[int, Dict[str, Any]]]]
                 = None):
        self._channel = channel
        self._rank = int(rank)
        self._world = max(1, int(world_size))
        self._candidates = list(candidates or [])

    def put(self, step: int, ckpt: Dict[str, Any], rank: Optional[int]
            = None, world_size: Optional[int] = None) -> None:
        r = self._rank if rank is None else int(rank)
        w = self._world if world_size is None else int(world_size)
        try:
            self._channel.put((_MEMCKPT_TAG, r, w, int(step), ckpt))
        except Exception as exc:  # noqa: BLE001 — worker must outlive channel
            log_suppressed("ckpt.memory", exc,
                           "in-memory checkpoint channel unavailable; "
                           "commit dropped (disk copy is intact)")

    def resume_candidates(self, copy_payloads: bool = True
                          ) -> List[Tuple[int, Dict[str, Any]]]:
        return [(step,
                 copy.deepcopy(payload) if copy_payloads else payload)
                for step, payload in self._candidates]

    def shutdown(self) -> None:
        self._candidates = []


class _Installed:
    def __init__(self, store: Any):
        self._store = store
        self._prev: Any = None

    def __enter__(self):
        self._prev = install_memory_store(self._store)
        return self._store

    def __exit__(self, *exc_info) -> None:
        install_memory_store(self._prev)


_MEMORY_STORE: Any = None
_WORKER_SEAT = threading.local()


def install_memory_store(store: Any) -> Any:
    """Install the process-global memory-checkpoint seat (the DRIVER's
    store). Returns the previous occupant so callers can restore it.
    Worker-side clients go through :func:`install_worker_client`
    instead — that seat is thread-scoped, so in-process fake-ray
    workers (threads sharing the driver's process) can never clobber
    the driver's store or each other's rank tagging."""
    global _MEMORY_STORE
    prev = _MEMORY_STORE
    _MEMORY_STORE = store
    if store is not None:
        logger.debug("memory checkpoint store installed: %r", store)
    return prev


def install_worker_client(client: Any) -> Any:
    """Install a :class:`MemoryCheckpointClient` for THIS thread (the
    launched worker body). Thread-local by design: on real backends a
    worker process has one thread and this is equivalent to a global;
    on the threaded in-process fakes each concurrent worker sees only
    its own client while the driver thread keeps seeing the store.
    Returns the thread's previous occupant for symmetric restore."""
    prev = getattr(_WORKER_SEAT, "client", None)
    _WORKER_SEAT.client = client
    return prev


def get_memory_store() -> Any:
    """The installed client (this thread's worker seat) or store, or
    ``None`` (the zero-cost default: every trainer hook is this read +
    a ``None`` check)."""
    client = getattr(_WORKER_SEAT, "client", None)
    if client is not None:
        return client
    return _MEMORY_STORE
