"""Subprocess-backed execution: real OS processes, no Ray needed (copied from ``ray_lightning_tpu/launchers/process_backend.py``).

A **ray-compatible module** (``init/is_initialized/remote/put/get/wait/
kill`` and the actor ``.options().remote()`` / ``method.remote()``
protocol) whose actors are spawned OS processes:

- every argument and result crosses a real pickle boundary,
- actors run concurrently (one process each; the calls on one actor are
  FIFO, as Ray's are),
- workers form a real ``torch.distributed`` process group (gloo on the
  CPU, NCCL on the cards): one process per device, the reference's own
  design (``ray_lightning/ray_ddp.py:171-213``).

This is what ``Strategy.configure_launcher`` uses for ``num_workers > 1``
when no Ray runtime is attached::

    ray_mod = ProcessRay(worker_env={...}, num_threads=1)
    launcher = RayLauncher(strategy, ray_module=ray_mod)

Each worker applies its environment (``CUDA_VISIBLE_DEVICES`` among it)
and torch's thread count before anything touches a device. A call or
result whose pickle is above ``INLINE_BYTES`` (rank 0's final train
state, 1.49 GB for GPT-2-small with AdamW) is pickled straight into a
temporary file whose name goes down the pipe instead: ``multiprocessing``
reads a pipe message 64 KiB at a time, and on an H100 host a 1.49 GB
result had not arrived after minutes (``PERF.md`` §6).

:meth:`ProcessRay.make_queue` is the session queue a Tune trial's
launch hands its workers (``ray.util.queue.Queue``'s part the launcher
uses): a ``multiprocessing`` manager's queue that pickles by reference,
so a worker reused across launches gets each launch's queue as a task
argument. Its items cross as calls do, a large one (a trial checkpoint)
through a temporary file, never through the manager process.

**Driver death.** A worker exits when its pipe to the driver closes. A
SIGKILLed driver closes no pipe a worker wedged in a long call would
read, and its queue manager holds none, so a spawned process whose
environment sets :data:`ORPHAN_GRACE_ENV` (the process replica fleet's
workers) and the manager of ``ProcessRay(orphan_grace_s=)`` run the
orphan guard: a watchdog thread that hard-exits the process once its
parent has been gone for the grace window.
"""
from __future__ import annotations

import io
import multiprocessing as mp
import os
import pickle
import queue as _queue
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple, Union

#: pickled payloads larger than this cross through a temporary file
INLINE_BYTES = 64 << 20

#: set in a spawned process's env (by ProcessReplicaFleet) to arm the
#: orphan guard: a watchdog thread that hard-exits the process once its
#: parent (the driver) has been gone past this many seconds, so a
#: SIGKILLed driver never leaks its worker fleet
ORPHAN_GRACE_ENV = "TL_ORPHAN_GRACE_S"


def _running(pid: int) -> bool:
    """Whether process ``pid`` exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            # the state follows the parenthesized command name
            return f.read().rsplit(")", 1)[1].split()[0] not in "ZX"
    except FileNotFoundError:
        return False
    except OSError:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        return True


def _install_orphan_guard(grace_s: float,
                          driver_pid: Optional[int] = None) -> None:
    """Start the orphan-reap watchdog in THIS process.

    A SIGKILLed driver sends no exit message and closes no pipe handles
    held by grandchildren, but the kernel reparents its children at
    once, so a ppid change IS the death signal. The watchdog polls for
    it; on detection it waits out ``grace_s`` (so a transient
    ptrace/debugger reparenting can never kill a healthy worker) and
    hard-exits: there is no driver left to unwind toward. Exit code 3
    marks an orphan self-reap in postmortems. A process whose parent is
    not the driver (an actor forked by a fork server) watches
    ``driver_pid`` as well.
    """
    parent = os.getppid()
    poll = max(0.02, min(0.25, grace_s / 4)) if grace_s > 0 else 0.05

    def _watch() -> None:
        while True:
            time.sleep(poll)  # tl-lint: allow-sleep — wall-clock watchdog poll; the driver it watches is a real OS process
            if os.getppid() != parent or (
                    driver_pid is not None and not _running(driver_pid)):
                if grace_s > 0:
                    time.sleep(grace_s)  # tl-lint: allow-sleep — the orphan grace window is wall-clock by contract
                os._exit(3)

    threading.Thread(target=_watch, daemon=True,
                     name="tl-orphan-guard").start()


def install_orphan_guard_from_env(driver_pid: Optional[int] = None
                                  ) -> Optional[float]:
    """Arm the orphan guard iff :data:`ORPHAN_GRACE_ENV` is set; returns
    the grace window (seconds) when armed. Called by every actor process
    after applying its env, with the pid of the process that created
    it."""
    raw = os.environ.get(ORPHAN_GRACE_ENV)
    if not raw:
        return None
    grace_s = float(raw)
    _install_orphan_guard(grace_s, driver_pid)
    return grace_s


class _Spill:
    """A binary sink for ``pickle.dump``: memory up to
    :data:`INLINE_BYTES`, then a temporary file (in ``TMPDIR``) that
    takes what was written and everything after. The pickler writes a
    large bytes object through directly, so it is never copied."""

    def __init__(self):
        self._mem: Optional[io.BytesIO] = io.BytesIO()
        self._file = None
        self._path = ""
        self._size = 0

    def write(self, data) -> int:
        n = memoryview(data).nbytes
        if self._file is None and self._size + n > INLINE_BYTES:
            fd, self._path = tempfile.mkstemp(prefix="processray-")
            self._file = os.fdopen(fd, "wb")
            self._file.write(self._mem.getbuffer())
            self._mem = None
        (self._mem if self._file is None else self._file).write(data)
        self._size += n
        return n

    def packed(self) -> Union[bytes, Tuple[str, str, int]]:
        if self._file is None:
            return self._mem.getvalue()
        self._file.close()
        return ("file", self._path, self._size)


def _dump(obj: Any) -> Union[bytes, Tuple[str, str, int]]:
    """``obj`` pickled as it goes down the pipe or into a queue: the
    pickle's bytes, or, above :data:`INLINE_BYTES`, the name of the
    temporary file it was pickled into (:func:`_load` reads and removes
    it)."""
    sink = _Spill()
    try:
        pickle.dump(obj, sink, protocol=pickle.HIGHEST_PROTOCOL)
    except BaseException:
        _discard(sink.packed())
        raise
    return sink.packed()


def _load(packed) -> Any:
    """Inverse of :func:`_dump`; a file is removed once read."""
    if isinstance(packed, (bytes, bytearray)):
        return pickle.loads(packed)
    _kind, path, _size = packed
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    finally:
        os.remove(path)


def _discard(packed) -> None:
    """Drop a payload no one will load (its file removed)."""
    if not isinstance(packed, (bytes, bytearray)):
        try:
            os.remove(packed[1])
        except FileNotFoundError:
            pass


def _worker_main(conn, env: Dict[str, str],
                 num_threads: Optional[int] = None,
                 driver_pid: Optional[int] = None) -> None:
    """Actor process body: apply the environment and torch's thread count
    before anything initialises a device, then serve construct/call
    messages over the pipe until exit/EOF."""
    # stamp the process as a disposable spawned worker: this is what
    # authorizes the fault plan's hard-exit mode (faults.MODE_EXIT) to
    # really os._exit here instead of degrading to a raise
    os.environ.setdefault("TL_WORKER_PROCESS", "1")
    os.environ.update(env)
    if num_threads is not None:
        import torch
        torch.set_num_threads(int(num_threads))
    # a pipe EOF already ends this loop when the driver dies cleanly; the
    # guard covers the SIGKILL shape, where a worker wedged inside a long
    # call (or blocked on a manager queue) never reads the pipe
    install_orphan_guard_from_env(driver_pid)
    actor = None
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        kind = msg[0]
        if kind == "exit":
            try:
                conn.close()
            finally:
                return
        try:
            if kind == "construct":
                cls, args, kwargs = _load(msg[1])
                actor = cls(*args, **kwargs)
                conn.send(("ok", pickle.dumps(None)))
            elif kind == "call":
                name = msg[1]
                args, kwargs = _load(msg[2])
                result = getattr(actor, name)(*args, **kwargs)
                conn.send(("ok", _dump(result)))
            else:
                conn.send(("err", pickle.dumps(
                    RuntimeError(f"unknown message kind {kind!r}"))))
        except BaseException as exc:  # noqa: BLE001 - must cross the pipe
            try:
                payload = pickle.dumps(exc)
            except Exception as pickle_exc:
                from ray_lightning_tpu_torch.reliability import \
                    log_suppressed
                log_suppressed("process_backend.pickle", pickle_exc,
                               "unpicklable worker exception; shipping "
                               "the traceback as RuntimeError instead")
                payload = pickle.dumps(
                    RuntimeError(traceback.format_exc()))
            try:
                conn.send(("err", payload))
            except (BrokenPipeError, OSError):
                return


class ProcessFuture:
    """Resolvable once; ``ProcessRay.get`` re-raises worker exceptions."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def _resolve(self, value: Any = None,
                 error: Optional[BaseException] = None) -> None:
        self._value, self._error = value, error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("ProcessFuture not resolved in time")
        if self._error is not None:
            raise self._error
        return self._value


class ProcessObjectRef:
    """Driver-held ref; the object is re-pickled into each task's args
    (Ray resolves top-level refs in args the same way)."""

    def __init__(self, value: Any):
        self.value = value

    def __repr__(self) -> str:
        return f"ProcessObjectRef({type(self.value).__name__})"


def _resolve_arg(obj: Any) -> Any:
    if isinstance(obj, ProcessObjectRef):
        return obj.value
    if isinstance(obj, ProcessFuture):
        return obj.result()
    return obj


class ProcessActorMethod:
    def __init__(self, handle: "ProcessActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args: Any, **kwargs: Any) -> ProcessFuture:
        return self._handle._submit(self._name, args, kwargs)


class ProcessActorHandle:
    """One spawned process per actor; FIFO call pipeline + reader thread."""

    def __init__(self, cls: type, args: Tuple, kwargs: Dict,
                 env: Dict[str, str], construct_timeout: float = 60.0,
                 num_threads: Optional[int] = None,
                 start_method: str = "spawn"):
        # never fork: it is unsafe with CUDA and threads
        ctx = mp.get_context(start_method)
        self._conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(
            target=_worker_main,
            args=(child_conn, env, num_threads, os.getpid()), daemon=True)
        self._proc.start()
        child_conn.close()
        self._send_lock = threading.Lock()
        self._pending: List[ProcessFuture] = []
        self._pending_lock = threading.Lock()
        self._killed = False
        self._dead = False  # latched by the reader on process death
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        # construction is itself a pipelined call
        fut = self._enqueue(
            ("construct", _dump((cls, args, kwargs))))
        fut.result(timeout=construct_timeout)

    def _enqueue(self, message: Tuple) -> ProcessFuture:
        """Append the future and send its request atomically: the worker
        replies FIFO, so pending order must equal send order even when
        several driver threads submit concurrently."""
        fut = ProcessFuture()
        with self._send_lock:
            with self._pending_lock:
                if self._dead:
                    # the reader already drained the pipe and exited: a
                    # send could still "succeed" into the broken pipe's
                    # buffer and this future would never resolve
                    fut._resolve(error=self._death_error())
                    return fut
                self._pending.append(fut)
            try:
                self._conn.send(message)
            except (BrokenPipeError, OSError) as exc:
                with self._pending_lock:
                    if fut in self._pending:
                        self._pending.remove(fut)
                fut._resolve(error=self._death_error(exc))
        return fut

    def _death_error(self, exc: Optional[BaseException] = None
                     ) -> RuntimeError:
        """The one actor-died error, shared by every failure path."""
        suffix = f": {exc}" if exc is not None else ""
        return RuntimeError(
            f"actor process pid={self._proc.pid} died "
            f"(exitcode={self._proc.exitcode}){suffix}")

    def _read_loop(self) -> None:
        while True:
            try:
                status, payload = self._conn.recv()
            except (EOFError, OSError):
                # process died: latch death first (under the lock, so a
                # racing _enqueue either lands in `pending` here or sees
                # the latch), then fail everything still in flight
                with self._pending_lock:
                    self._dead = True
                    pending, self._pending = self._pending, []
                err = self._death_error()
                for fut in pending:
                    fut._resolve(error=err)
                return
            with self._pending_lock:
                fut = self._pending.pop(0)
            try:
                value = _load(payload)
            except Exception as exc:  # noqa: BLE001 - the caller must hear
                # a reply that does not unpickle here (e.g. an exception
                # type whose __init__ pickle cannot call) still resolves
                # its future, or the caller would wait forever
                fut._resolve(error=RuntimeError(
                    f"the worker's {'result' if status == 'ok' else 'error'}"
                    f" could not be unpickled: {type(exc).__name__}: {exc}"))
                continue
            if status == "ok":
                fut._resolve(value=value)
            else:
                fut._resolve(error=value)

    def _submit(self, name: str, args: Tuple,
                kwargs: Dict) -> ProcessFuture:
        if self._killed:
            raise RuntimeError("Actor was killed")
        args = tuple(_resolve_arg(a) for a in args)
        kwargs = {k: _resolve_arg(v) for k, v in kwargs.items()}
        return self._enqueue(
            ("call", name, _dump((args, kwargs))))

    def __getattr__(self, name: str) -> ProcessActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ProcessActorMethod(self, name)

    def _kill(self) -> None:
        self._killed = True
        with self._pending_lock:
            busy = bool(self._pending) or self._dead
        if not busy:
            # idle actor: ask it to exit cleanly and give it a moment
            try:
                with self._send_lock:
                    self._conn.send(("exit",))
            except (BrokenPipeError, OSError):
                pass
            self._proc.join(timeout=5)
        # a busy actor serves messages FIFO, so an "exit" would queue
        # behind the in-flight call, which may be wedged in a collective:
        # terminate it instead
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5)
        if self._proc.is_alive():  # SIGTERM ignored/blocked: escalate
            self._proc.kill()
            self._proc.join(timeout=5)
        try:
            self._conn.close()
        except OSError:
            pass


class ProcessRemoteClass:
    def __init__(self, cls: type, backend: "ProcessRay"):
        self._cls = cls
        self._backend = backend
        self._options: Dict[str, Any] = {}

    def options(self, **options: Any) -> "ProcessRemoteClass":
        out = ProcessRemoteClass(self._cls, self._backend)
        out._options = options
        return out

    def remote(self, *args: Any, **kwargs: Any) -> ProcessActorHandle:
        # honored options (Ray ignores unknown ones, so do we):
        #   worker_env: per-actor env merged over the backend's (how the
        #     process fleet stamps each replica's seat and device)
        #   construct_timeout: the seconds the spawned process may take
        #     to build the actor
        env = dict(self._backend.worker_env)
        env.update(self._options.get("worker_env") or {})
        handle = ProcessActorHandle(
            self._cls, args, kwargs, env,
            construct_timeout=self._options.get("construct_timeout", 60.0),
            num_threads=self._backend.num_threads,
            start_method=self._backend._start_method)
        self._backend.created_actors.append(handle)
        return handle


class _ManagerQueue:
    """A cross-process queue with the part of ``ray.util.queue.Queue``'s
    surface the launcher and the session use (``put``, ``get``,
    ``empty``, ``shutdown``). It pickles by reference, as a Ray queue's
    actor handle does: only the manager's proxy crosses, and every
    unpickled copy puts into the one queue the manager holds. An item is
    pickled by the process that puts it (:func:`_dump`): a large one
    crosses as the name of a temporary file, and the getter loads it."""

    def __init__(self, proxy: Any):
        self._q = proxy

    def __reduce__(self):
        return (_ManagerQueue, (self._q,))

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        # the timeout matters worker-side: a put into a dead manager's
        # proxy raises promptly, but a full queue under a dying manager
        # could block forever (serve workers bound every put by their
        # orphan grace window, launchers/serve_worker.py)
        packed = _dump(item)
        try:
            self._q.put(packed, block, timeout)
        except BaseException:
            _discard(packed)
            raise

    def get(self, block: bool = True, timeout: Optional[float] = None):
        return _load(self._q.get(block, timeout))

    def empty(self) -> bool:
        return self._q.empty()

    def shutdown(self) -> None:
        """Drop what no one drained (a failed launch's), removing the
        temporary files of large items."""
        while True:
            try:
                packed = self._q.get_nowait()
            except _queue.Empty:
                return
            _discard(packed)


class ProcessRay:
    """Ray-compatible module whose actors are spawned OS processes on
    this host. ``assigns_gpus`` is False: the launcher hands each worker
    one card of the host's visible set, where Ray would assign one."""

    ObjectRef = ProcessObjectRef
    assigns_gpus = False
    #: how actors and the queue manager start. A spawned process takes
    #: the driver's environment as it is at the spawn (the launcher's and
    #: Tune's spills land in the caller's current ``TMPDIR``); the process
    #: fleet's backend forks from a fork server instead
    #: (``serve/process_fleet.py:_ForkServerRay``)
    _start_method = "spawn"

    def __init__(self, worker_env: Optional[Dict[str, str]] = None,
                 num_threads: Optional[int] = None,
                 orphan_grace_s: Optional[float] = None):
        self._initialized = False
        self.worker_env = dict(worker_env or {})
        self.num_threads = num_threads
        # arms the manager process's own orphan guard: the manager
        # outlives a SIGKILLed driver exactly as a worker does, and it
        # holds no pipe to notice the death through
        self.orphan_grace_s = orphan_grace_s
        self.created_actors: List[ProcessActorHandle] = []
        self.killed_actors: List[ProcessActorHandle] = []
        self._manager = None

    # -- lifecycle ----------------------------------------------------- #
    def init(self, *args: Any, **kwargs: Any) -> None:
        self._initialized = True

    def is_initialized(self) -> bool:
        return self._initialized

    def shutdown(self) -> None:
        for actor in self.created_actors:
            if not actor._killed:
                actor._kill()
        if self._manager is not None:
            self._manager.shutdown()
            self._manager = None
        self._initialized = False

    # -- object store -------------------------------------------------- #
    def put(self, obj: Any) -> ProcessObjectRef:
        """A snapshot of ``obj`` as it is now (a pickle round trip, as
        Ray's object store takes one): the caller may change ``obj``
        right after, as ``run_function_on_workers`` puts the trainer's
        launcher back."""
        return ProcessObjectRef(pickle.loads(pickle.dumps(obj)))

    def get(self, refs: Any, timeout: Optional[float] = None) -> Any:
        if isinstance(refs, list):
            # ray.get's timeout is one overall deadline, not per ref
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            out = []
            for r in refs:
                if isinstance(r, ProcessFuture):
                    remaining = None if deadline is None \
                        else max(0.0, deadline - time.monotonic())
                    out.append(r.result(remaining))
                else:
                    out.append(_resolve_arg(r))
            return out
        if isinstance(refs, ProcessFuture):
            return refs.result(timeout)
        return _resolve_arg(refs)

    def wait(self, refs: List[Any], num_returns: int = 1,
             timeout: Optional[float] = None
             ) -> Tuple[List[Any], List[Any]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ready = [r for r in refs
                     if not isinstance(r, ProcessFuture) or r.done()]
            if len(ready) >= num_returns or (
                    deadline is not None
                    and time.monotonic() >= deadline):
                not_ready = [r for r in refs if r not in ready]
                return ready, not_ready
            time.sleep(0.005)  # tl-lint: allow-sleep — ray.wait poll quantum (wall-clock by contract)

    # -- actors -------------------------------------------------------- #
    def remote(self, cls: type) -> ProcessRemoteClass:
        return ProcessRemoteClass(cls, self)

    def kill(self, actor: ProcessActorHandle,
             no_restart: bool = False) -> None:
        actor._kill()
        self.killed_actors.append(actor)

    def live_actor_count(self) -> int:
        """Spawned actor processes still alive (the no-leak check)."""
        return sum(1 for a in self.created_actors if a._proc.is_alive())

    # -- the session queue --------------------------------------------- #
    def make_queue(self) -> _ManagerQueue:
        """A new queue the driver drains and the workers put into; the
        manager process that holds the queues starts with the first and
        stops at :meth:`shutdown`."""
        if self._manager is None:
            ctx = mp.get_context(self._start_method)
            if self.orphan_grace_s is not None:
                # ctx.Manager() takes no initializer: start the manager
                # by hand so its process installs the orphan guard
                # before it serves any proxy
                from multiprocessing.managers import SyncManager
                self._manager = SyncManager(ctx=ctx)
                self._manager.start(_install_orphan_guard,
                                    (float(self.orphan_grace_s),
                                     os.getpid()))
            else:
                self._manager = ctx.Manager()
        return _ManagerQueue(self._manager.Queue())
