"""The multi-process launcher: one worker process per device (counterpart of ``ray_lightning_tpu/launchers/ray_launcher.py``).

The reference's own design (``ray_lightning/launchers/ray_launcher.py:
27-380``, ``ray_ddp.py:171-213``), where the JAX package drives every
chip of a host from one process:

  launch = setup_workers -> run_function_on_workers -> rank 0's results
           -> teardown_workers

- one executor actor per data-parallel rank, each owning one card (or
  the CPU under ``device="cpu"``);
- the rendezvous: a free port probed on worker 0's node, broadcast with
  worker 0's address as ``MASTER_ADDR``/``MASTER_PORT`` (and
  ``WORLD_SIZE`` and the seed) to every worker, which then calls
  ``init_process_group(init_method="env://")``
  (``Strategy.worker_setup``);
- the per-node ``CUDA_VISIBLE_DEVICES`` union, so co-located workers see
  each other's cards (NCCL's peer-to-peer path), and each worker's device
  index in it (the reference's ``_share_cuda_visible_devices`` and
  ``root_device``). Under Ray each worker reports the card Ray assigned
  it (``ray.get_gpu_ids()``); the subprocess backend (``ProcessRay``),
  which assigns none, hands out the host's visible cards in rank order;
- the global -> (local, node) rank map from the workers' node addresses
  (:meth:`RayLauncher.get_local_ranks`);
- inside a Ray Tune trial, one session queue per launch
  (:meth:`RayLauncher.setup_workers`): each worker's session puts into
  it, the driver runs what arrives while it waits on the workers
  (``util.process_results``), and the queue is shut down at teardown.

The JAX launcher's TPU rule -- one actor per host, enforced unless
``allow_colocated_workers`` -- does not apply: a card has one owner
either way, and ``allow_colocated_workers`` has no effect here.

The reliability seams, each disarmed (no channel, no thread, no event)
until asked for, as in the JAX launcher:

- ``gang=`` (a :class:`~ray_lightning_tpu_torch.reliability.gang.
  GangConfig`): each rank's trainer beats (``(rank, step, time)``)
  into a driver-owned channel, and the driver's wait on the workers is
  the watchdog (:meth:`RayLauncher._process_results`): a rank silent
  past its timeout, or a worker whose future failed, raises a
  :class:`~ray_lightning_tpu_torch.reliability.gang.GangFailure` with
  the per-rank postmortem, and the teardown kills every worker process
  (``gang.teardown``) -- no collective, no ``destroy_process_group``:
  a rank that died inside a NCCL or gloo communicator leaves its peers
  blocked in it. The world's collective timeout comes from the config.
- ``standby=`` (a :class:`~ray_lightning_tpu_torch.reliability.elastic.
  StandbyPool`): rank slots are filled by promoting warm standbys
  (``standby.promoted``) before any cold spawn, and the pool is topped
  up on a background thread once the gang is dispatched.
- an installed :class:`~ray_lightning_tpu_torch.reliability.elastic.
  MemoryCheckpointStore`: workers ship their checkpoints' host copies
  through a channel the watchdog poll drains into it, and each dispatch
  carries the store's resume candidates out.

With a ``Telemetry`` on the trainer the driver emits ``launch.start``
and ``launch.done`` around every launch and flushes its log after.

Ray is optional: the launcher takes any ray-compatible module, which is
also the test seam (``testing/fake_ray.py``, ``process_backend.py``).
"""
from __future__ import annotations

import gc
import os
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_lightning_tpu_torch import session as _session
from ray_lightning_tpu_torch.core.seed import GLOBAL_SEED_ENV, reset_seed
from ray_lightning_tpu_torch.launchers.utils import (
    CUDA_VISIBLE_DEVICES_ENV, WorkerOutput, find_free_port,
    get_executable_cls, get_node_ip, visible_gpu_ids)
from ray_lightning_tpu_torch.util import (POLL_INTERVAL_S, _drain_queue,
                                          process_results)

MASTER_ADDR_ENV = "MASTER_ADDR"
MASTER_PORT_ENV = "MASTER_PORT"
WORLD_SIZE_ENV = "WORLD_SIZE"


def _import_ray():
    try:
        import ray
        return ray
    except ImportError:
        return None


class ExecutorBase:
    """The worker actor's body (the reference's ``RayExecutor``,
    ``launchers/utils.py:27-52``): env plumbing, host introspection and a
    function runner, nothing about training."""

    def set_env_var(self, key: str, value: Optional[str]) -> None:
        """``None`` unsets."""
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value

    def set_env_vars(self, keys: List[str], values: List[str]) -> None:
        for key, value in zip(keys, values):
            self.set_env_var(key, value)

    def get_env_var(self, key: str) -> Optional[str]:
        return os.environ.get(key)

    def get_node_ip(self) -> str:
        ray = _import_ray()
        if ray is not None and ray.is_initialized():
            return ray.util.get_node_ip_address()
        return get_node_ip()

    def find_free_port(self) -> int:
        return find_free_port()

    def get_node_and_gpu_ids(self) -> Tuple[str, List[Any]]:
        """(node address, card ids): under Ray the cards Ray assigned this
        actor (``ray.get_gpu_ids()``), else every card this process sees
        (its ``CUDA_VISIBLE_DEVICES``, or all the host has)."""
        ray = _import_ray()
        if ray is not None and ray.is_initialized():
            return self.get_node_ip(), list(ray.get_gpu_ids())
        return self.get_node_ip(), visible_gpu_ids()

    def execute(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        return fn(*args, **kwargs)


class RayLauncher:
    """Launches the trainer's stage on one worker process per rank,
    behind the same ``launch()`` contract as
    :class:`~ray_lightning_tpu_torch.launchers.local.LocalLauncher`."""

    def __init__(self, strategy, ray_module: Any = None,
                 workers: Optional[List[Any]] = None,
                 gang: Optional[Any] = None,
                 standby: Optional[Any] = None):
        """``workers``: externally owned executor actors to reuse instead
        of creating (and killing) a fresh set per ``launch()``: spawning,
        interpreter and CUDA start-up are paid once for many fits. Every
        launch still forms a fresh process group over them (a new port,
        ``init_process_group``, destroyed at the launch's end), so a reuse
        needs the same count and rank order. The caller owns their
        lifetime, unless a launch fails: a world that lost a rank may be
        stuck in a collective, so the launcher kills every worker and
        forgets them.

        ``gang`` and ``standby``: see the module docstring (the pool is
        caller-owned: it survives the gang's teardown by design, and the
        caller shuts it down)."""
        self._strategy = strategy
        self._ray = ray_module if ray_module is not None else _import_ray()
        if self._ray is None:
            raise RuntimeError(
                "RayLauncher requires `ray` or an injected ray-compatible "
                "module (e.g. launchers.process_backend.ProcessRay)")
        if workers is not None and len(workers) != strategy.num_workers:
            raise ValueError(
                f"{len(workers)} external workers for a strategy needing "
                f"num_workers={strategy.num_workers}; persistent worlds "
                "must keep the same process count")
        if not self._ray.is_initialized():
            self._ray.init()
        self._external_workers = workers
        self._workers: List[Any] = []
        self._failed = False
        self._master_addr: Optional[str] = None
        self._master_port: Optional[int] = None
        self._device_indices: List[Optional[int]] = []
        self.queue: Any = None
        # gang supervision (None/False when disarmed)
        self._gang = gang
        self._gang_channel: Any = None
        self._gang_monitor: Any = None
        self._gang_failed = False
        self._tel: Any = None   # the trainer's telemetry, per launch
        # the warm tiers (None = disarmed)
        self._standby = standby
        self._memstore_channel: Any = None
        self._memstore_driver: Any = None

    # ------------------------------------------------------------------ #
    # driver side: the launch pipeline
    # ------------------------------------------------------------------ #
    def launch(self, function: Callable, *args: Any, trainer=None,
               **kwargs: Any) -> Any:
        """setup -> run on every rank -> rank 0's result -> teardown; a
        failure anywhere still releases the workers."""
        tel = getattr(trainer, "telemetry", None)
        self._tel = tel
        self._failed = False
        self._gang_failed = False
        if tel is not None:
            tel.event("launch.start", launcher="ray",
                      num_workers=self._strategy.num_workers)
        try:
            self.setup_workers()
            return self.run_function_on_workers(
                function, *args, trainer=trainer, **kwargs)
        except BaseException:
            self._failed = True
            raise
        finally:
            self.teardown_workers()
            self._strategy.teardown()
            if tel is not None:
                tel.event("launch.done", launcher="ray")
                tel.flush()   # the driver owns the jsonl log

    def setup_workers(self) -> None:
        """Create (or adopt) the workers, run ``init_hook`` on each, probe
        the rendezvous port on worker 0, broadcast the env, share the
        visible cards per node and compute the rank map."""
        strategy = self._strategy
        if self._external_workers is not None:
            self._workers = list(self._external_workers)
        else:
            self._check_enough_gpus()
            # warm standbys first: a restart with enough of them pays no
            # spawn on its critical path
            self._workers = [self._promote_or_create(rank)
                             for rank in range(strategy.num_workers)]
        if strategy.init_hook:
            self._ray.get([
                w.execute.remote(strategy.init_hook) for w in self._workers])
        # a fresh port for every world: a failed earlier world's store
        # may still be bound
        from ray_lightning_tpu_torch.reliability import faults as _faults
        _faults.fire("rendezvous.init")
        self._master_addr = self._ray.get(
            self._workers[0].get_node_ip.remote())
        self._master_port = self._ray.get(
            self._workers[0].execute.remote(find_free_port))
        self._setup_env_vars()
        node_ips = self._ray.get(
            [w.get_node_ip.remote() for w in self._workers])
        local_ranks = self.get_local_ranks(node_ips)
        strategy.set_global_to_local(local_ranks)
        self._device_indices = [None] * len(self._workers)
        if strategy.use_gpu:
            self._device_indices = self._share_cuda_visible_devices(
                local_ranks)
        self._gang_failed = False
        if self._gang is not None:
            from ray_lightning_tpu_torch.reliability.gang import GangMonitor
            self._gang_channel = self._make_queue()
            self._gang_monitor = GangMonitor(
                strategy.num_workers, self._gang, node_ips=node_ips,
                telemetry=self._tel)
            strategy.collective_timeout_s = self._gang.collective_timeout()
        # the store is captured here, so in-process fake workers
        # installing their clients can never race the driver's drain
        from ray_lightning_tpu_torch.reliability import elastic as _elastic
        self._memstore_driver = _elastic.get_memory_store()
        if self._memstore_driver is not None:
            self._memstore_channel = self._make_queue()
        self.queue = self._make_queue() if self._in_tune_session() \
            else None

    def _promote_or_create(self, rank: int):
        """A warm standby promoted into rank slot ``rank``
        (``standby.promoted``), or a freshly spawned worker when the pool
        is absent or empty."""
        worker = None if self._standby is None else self._standby.take()
        if worker is None:
            return self._create_worker(rank)
        if self._tel is not None:
            from ray_lightning_tpu_torch.reliability.elastic import (
                COUNTER_STANDBY_PROMOTIONS, EVENT_STANDBY_PROMOTED)
            self._tel.event(EVENT_STANDBY_PROMOTED, rank=rank,
                            available=self._standby.available())
            self._tel.metrics.counter(
                COUNTER_STANDBY_PROMOTIONS,
                help="warm standby workers promoted into gang rank "
                     "slots").inc()
        return worker

    @staticmethod
    def _in_tune_session() -> bool:
        from ray_lightning_tpu_torch.tune import is_session_enabled
        return is_session_enabled()

    def _make_queue(self):
        """One driver-owned queue (a Tune session's, the heartbeat
        channel, the memory tier's), from the injected module: the
        backend's own (``ProcessRay``'s manager queue, the fakes'), or a
        Ray queue actor under Ray."""
        make_queue = getattr(self._ray, "make_queue", None)
        if make_queue is not None:
            return make_queue()
        from ray.util.queue import Queue
        return Queue(actor_options={"num_cpus": 0})

    def _create_worker(self, rank: int):
        """One actor per rank, asking Ray for one card when the workers
        train on cards (the reference's ``_create_worker``,
        ``ray_launcher.py:105-115``)."""
        strategy = self._strategy
        executable_cls = get_executable_cls() or ExecutorBase
        remote_cls = self._ray.remote(executable_cls)
        return remote_cls.options(
            num_cpus=strategy.num_cpus_per_worker,
            num_gpus=strategy.num_gpus_per_worker,
            resources=dict(strategy.additional_resources_per_worker) or None,
            runtime_env=strategy.worker_runtime_env or None,
        ).remote()

    def _check_enough_gpus(self) -> None:
        """Refuse, before anything is spawned, more card workers than
        there are cards: NCCL would otherwise fail mid-rendezvous with a
        duplicate-GPU error (or Ray would pend forever). The subprocess
        backend counts the cards this host shows; Ray its cluster's."""
        strategy = self._strategy
        if not strategy.use_gpu:
            return
        if getattr(self._ray, "assigns_gpus", True):
            resources = getattr(self._ray, "cluster_resources", None)
            if resources is None:
                return  # a fake without a resource table
            have = int(resources().get("GPU", 0))
            where = "the Ray cluster has"
        else:
            have = len(visible_gpu_ids())
            where = "this host shows"
        if strategy.num_workers > have:
            raise ValueError(
                f"num_workers={strategy.num_workers} card workers but "
                f"{where} {have} visible GPU(s): each worker owns one "
                "card. Lower num_workers, or pass device='cpu' for CPU "
                "workers.")

    def _setup_env_vars(self) -> None:
        """Broadcast the rendezvous (``MASTER_ADDR``, ``MASTER_PORT``,
        ``WORLD_SIZE``) and the driver's seed to every worker (the
        reference's ``_setup_env_vars``, ``ray_launcher.py:160-176``)."""
        keys = [MASTER_ADDR_ENV, MASTER_PORT_ENV, WORLD_SIZE_ENV]
        values = [self._master_addr, str(self._master_port),
                  str(self._strategy.num_workers)]
        if GLOBAL_SEED_ENV in os.environ:
            keys.append(GLOBAL_SEED_ENV)
            values.append(os.environ[GLOBAL_SEED_ENV])
        self._ray.get([w.set_env_vars.remote(keys, values)
                       for w in self._workers])

    def _share_cuda_visible_devices(
            self, local_ranks: List[Tuple[int, int]]) -> List[Optional[int]]:
        """Give every worker of a node the union of the node's cards as
        ``CUDA_VISIBLE_DEVICES``, and return each rank's index of its own
        card in that union (its ``cuda:`` index). A worker that gets no
        card keeps its environment and raises in ``worker_setup``."""
        node_and_gpus = self._ray.get(
            [w.get_node_and_gpu_ids.remote() for w in self._workers])
        assigned = getattr(self._ray, "assigns_gpus", True)
        own: List[Any] = []
        for (_ip, ids), (local_rank, _node) in zip(node_and_gpus,
                                                   local_ranks):
            ids = list(ids)
            if assigned:      # Ray: the card it gave this actor
                own.append(ids[0] if ids else None)
            else:             # the node's visible cards, in rank order
                own.append(ids[local_rank] if local_rank < len(ids)
                           else None)
        union: Dict[str, List[Any]] = defaultdict(list)   # in rank order
        for (ip, _ids), gpu in zip(node_and_gpus, own):
            if gpu is not None and gpu not in union[ip]:
                union[ip].append(gpu)
        futures, indices = [], []
        for worker, (ip, _ids), gpu in zip(self._workers, node_and_gpus,
                                           own):
            if gpu is None:
                indices.append(None)
                continue
            visible = ",".join(str(g) for g in union[ip])
            futures.append(worker.set_env_var.remote(
                CUDA_VISIBLE_DEVICES_ENV, visible))
            indices.append(union[ip].index(gpu))
        if futures:
            self._ray.get(futures)
        return indices

    @staticmethod
    def get_local_ranks(node_ips: List[str]) -> List[Tuple[int, int]]:
        """global rank -> (local rank, node rank), from the workers' node
        addresses in creation order; nodes numbered by first appearance
        (the reference's ``get_local_ranks``, ``ray_launcher.py:131-158``).
        """
        node_rank_map: Dict[str, int] = {}
        local_counter: Dict[str, int] = defaultdict(int)
        out: List[Tuple[int, int]] = []
        for ip in node_ips:
            if ip not in node_rank_map:
                node_rank_map[ip] = len(node_rank_map)
            out.append((local_counter[ip], node_rank_map[ip]))
            local_counter[ip] += 1
        return out

    def run_function_on_workers(self, function: Callable, *args: Any,
                                trainer=None, **kwargs: Any) -> Any:
        """Put the trainer in the object store once (its launcher
        detached: actor handles never cross the boundary), dispatch the
        named stage on every rank, wait on every rank (a failure raises
        at once) and return rank 0's result (the reference's
        ``ray_launcher.py:222-251``)."""
        trainer = trainer if trainer is not None else getattr(
            function, "__self__", None)
        if trainer is None:
            raise ValueError(
                "run_function_on_workers needs the trainer (pass trainer= "
                "or launch a bound trainer method).")
        launcher, trainer._launcher = trainer._launcher, None
        try:
            trainer_ref = self._ray.put(trainer)
        finally:
            trainer._launcher = launcher
        coordinator = f"{self._master_addr}:{self._master_port}"
        num_workers = self._strategy.num_workers
        global_to_local = self._strategy.global_to_local
        # the driver's armed chaos schedule is armed in every worker too
        from ray_lightning_tpu_torch.reliability import faults as _faults
        fault_plan = _faults.get_armed()
        memstore = None
        if self._memstore_channel is not None:
            memstore = {
                "channel": self._memstore_channel,
                "world_size": num_workers,
                # no eager copy: the dispatch's pickle is the copy
                "candidates": self._memstore_driver.resume_candidates(
                    copy_payloads=False)}
        futures = [
            w.execute.remote(self._wrapping_function, rank, global_to_local,
                             self._device_indices[rank], trainer_ref,
                             function.__name__, args, kwargs, coordinator,
                             num_workers, fault_plan, self.queue,
                             self._heartbeat_for(rank), memstore)
            for rank, w in enumerate(self._workers)
        ]
        if self._standby is not None:
            # top the pool back up off the critical path: the gang is
            # already dispatched and training while replacements warm
            self._standby.refill_async(lambda: self._create_worker(-1))
        return self._process_results(futures, self.queue)[0]

    def _heartbeat_for(self, rank: int):
        """Rank ``rank``'s beat source into the gang channel (built here
        so the config's throttle applies; the channel pickles by
        reference into the worker), or None when disarmed."""
        if self._gang_channel is None:
            return None
        from ray_lightning_tpu_torch.reliability.gang import \
            HeartbeatEmitter
        return HeartbeatEmitter(self._gang_channel, rank,
                                interval=self._gang.heartbeat_interval)

    def _process_results(self, futures: List[Any], queue) -> List[Any]:
        """Wait on the workers' futures (``util.process_results``), and
        with a gang armed or a memory store installed let the same poll
        drain the heartbeat channel into the :class:`GangMonitor` and
        the replicated checkpoints into the store. A rank silent past
        its timeout, or a failed future, raises a ``GangFailure`` with
        the per-rank postmortem; the unwind through :meth:`launch` then
        kills the whole gang. Disarmed, a failed worker raises its own
        error at once (peers blocked in a collective with it would
        never finish)."""
        monitor = self._gang_monitor
        chan, store = self._memstore_channel, self._memstore_driver
        if monitor is None and chan is None:
            return process_results(futures, self._ray, queue=queue)
        if monitor is not None:
            monitor.start()
        unfinished = list(futures)
        while unfinished:
            _drain_queue(queue)
            if chan is not None:
                store.drain(chan)
            if monitor is not None:
                monitor.drain(self._gang_channel)
                silent = monitor.silent_ranks()
                if silent:
                    self._gang_failed = True
                    raise monitor.heartbeat_failure(silent)
            ready, unfinished = self._ray.wait(unfinished,
                                               timeout=POLL_INTERVAL_S)
            for ref in ready:
                rank = futures.index(ref)
                try:
                    self._ray.get(ref)
                except Exception as exc:
                    if monitor is None:
                        raise
                    self._gang_failed = True
                    monitor.drain(self._gang_channel)
                    from ray_lightning_tpu_torch.reliability.gang import \
                        actor_alive
                    dead = (rank < len(self._workers)
                            and not actor_alive(self._workers[rank]))
                    raise monitor.worker_failure(rank, exc,
                                                 dead=dead) from exc
                if monitor is not None:
                    # a finished rank stops beating by design
                    monitor.mark_done(rank)
        _drain_queue(queue)
        if chan is not None:
            store.drain(chan)
        return self._ray.get(futures)

    @staticmethod
    def _wrapping_function(global_rank: int, global_to_local,
                           device_index: Optional[int], trainer_ref,
                           fn_name: str, args, kwargs, coordinator: str,
                           num_processes: int, fault_plan=None,
                           queue=None, heartbeat=None,
                           memstore=None) -> Optional[WorkerOutput]:
        """The worker's entry (the reference's ``ray_launcher.py:253-311``):
        the trainer, ranks and session (with this launch's queue, if
        any); the process group
        (``Strategy.worker_setup``, which also finds this worker's card);
        the stage; then the group destroyed and the trainer freed. Only
        rank 0 returns its output. ``heartbeat`` (gang armed) is this
        rank's beat source, which the trainer reaches as the shim's
        ``heartbeat``; ``memstore`` (a store installed on the driver)
        the channel and the shipped candidates, served by a
        :class:`~ray_lightning_tpu_torch.reliability.elastic.
        MemoryCheckpointClient` installed in this thread for the
        stage."""
        trainer = trainer_ref
        if hasattr(trainer_ref, "_is_fake_object_ref"):
            trainer = trainer_ref.value  # in-process fake store (tests)
        else:
            ray = _import_ray()
            if ray is not None and isinstance(trainer_ref, ray.ObjectRef):
                trainer = ray.get(trainer_ref)
        from ray_lightning_tpu_torch.reliability import faults as _faults
        armed_here = (fault_plan is not None
                      and _faults.ensure_armed(fault_plan))
        from ray_lightning_tpu_torch.reliability import elastic as _elastic
        prev_client = None
        if memstore is not None:
            prev_client = _elastic.install_worker_client(
                _elastic.MemoryCheckpointClient(
                    memstore["channel"], rank=global_rank,
                    world_size=memstore.get("world_size", num_processes),
                    candidates=memstore.get("candidates")))
        if heartbeat is not None:
            heartbeat.beat(-1)   # alive: entered, before any set-up
        reset_seed()
        strategy = trainer.strategy
        strategy.set_remote(True)
        strategy.set_global_to_local(global_to_local)
        strategy.set_device_index(device_index)
        _session.shutdown_session()
        _session.init_session(rank=global_rank, queue=queue)
        try:
            strategy.worker_setup(process_idx=global_rank,
                                  num_processes=num_processes,
                                  coordinator_address=coordinator)
            if heartbeat is not None:
                heartbeat.beat(-1)   # alive: rendezvous done
            trainer._launcher = _WorkerSideQueueShim(heartbeat)
            results = getattr(trainer, fn_name)(*args, **kwargs)
        finally:
            _session.shutdown_session()
            if armed_here:
                _faults.disarm()
            if memstore is not None:
                _elastic.install_worker_client(prev_client)
            strategy.teardown()
            # the trainer and its module refer to each other: collect the
            # cycle now, so a persistent worker's next fit starts with
            # this one's device memory free
            trainer = None
            gc.collect()
            import torch
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
        return results if global_rank == 0 else None

    def teardown_workers(self) -> None:
        """Kill the workers this launcher made (the reference's
        ``ray_launcher.py:117-129``) and shut the queues down. External
        workers are released, unless the launch failed: then they are
        killed and forgotten, so the next launch spawns a fresh world.
        After a gang failure (``gang.teardown``) every worker process is
        killed outright, busy ones by signal, whatever collective it is
        blocked in; nothing waits on a dead rank."""
        if self._gang_failed and self._tel is not None:
            from ray_lightning_tpu_torch.reliability.gang import \
                EVENT_GANG_TEARDOWN
            self._tel.event(EVENT_GANG_TEARDOWN,
                            num_workers=len(self._workers))
        if self._external_workers is None or self._failed:
            for worker in self._workers:
                self._ray.kill(worker, no_restart=True)
            self._external_workers = None
        self._workers = []
        if self.queue is not None:
            self.queue.shutdown()
            self.queue = None
        if self._gang_channel is not None:
            self._gang_channel.shutdown()
            self._gang_channel = None
        self._gang_monitor = None
        if self._memstore_channel is not None:
            # a commit shipped just as the gang failed is the one the
            # restart wants: drain before the channel goes
            self._memstore_driver.drain(self._memstore_channel)
            self._memstore_channel.shutdown()
            self._memstore_channel = None
        self._memstore_driver = None


class _WorkerSideQueueShim:
    """The worker's stand-in for the launcher: the fit loop calls
    ``launcher.drain_queue()`` between batches, and on a worker there is
    nothing to run -- the session queue belongs to the driver, which
    drains it while it waits on the workers. It is also the trainer's
    heartbeat seat: with a gang armed ``heartbeat(step)`` forwards to
    the rank's
    :class:`~ray_lightning_tpu_torch.reliability.gang.HeartbeatEmitter`,
    otherwise it does nothing."""

    def __init__(self, heartbeat=None):
        self._heartbeat = heartbeat

    def drain_queue(self) -> None:
        return None

    def heartbeat(self, step: int) -> None:
        if self._heartbeat is not None:
            self._heartbeat.beat(step)
