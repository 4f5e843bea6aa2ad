"""In-process ray-compatible fakes (copied from ``ray_lightning_tpu/testing/fake_ray.py``).

The exact subset of the Ray API the launcher uses --
``init/is_initialized/remote/put/get/wait/kill`` plus the actor
``.options(...).remote()`` / ``method.remote(...)`` protocol -- in two
flavors:

- :class:`FakeRay` -- synchronous: remote calls run at once in this
  process and return resolved refs. The seam most launcher unit tests
  use (rank maps, the env broadcast, the visible-device union, the
  rank-0 result), with no process group.
- :class:`ThreadedFakeRay` -- concurrent: each actor owns a one-thread
  executor (one message at a time per actor, actors concurrent with each
  other), ``wait`` really polls, and task arguments cross a pickle
  boundary.

``put`` (and, in the threaded fake, task arguments) round-trip through
pickle, so anything unpicklable fails in the tests where it would fail
on a cluster. :class:`FakeQueueHandle` pickles *by reference* the way
a ``ray.util.queue.Queue`` actor handle does (``FakeRay.make_queue``:
the session queue of a Tune trial's launch). Both stand in for Ray, which assigns each actor its card
(``assigns_gpus``). :class:`RecordingExecutor` records env writes per
actor instead of touching ``os.environ``; subclass it and override
``node_ip()`` / ``gpu_ids()`` to simulate placement.
"""
from __future__ import annotations

import itertools
import pickle
import queue as _queue
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple


class FakeObjectRef:
    """Stand-in for ``ray.ObjectRef``: pre-resolved value or live future."""
    _is_fake_object_ref = True

    def __init__(self, value: Any = None, future: Optional[Future] = None):
        self._value = value
        self._future = future

    @property
    def value(self) -> Any:
        if self._future is not None:
            return self._future.result()
        return self._value

    def done(self) -> bool:
        return self._future is None or self._future.done()

    def __repr__(self) -> str:
        if self._future is not None and not self._future.done():
            return "FakeObjectRef(<pending>)"
        return f"FakeObjectRef({type(self.value).__name__})"


def _resolve(obj: Any) -> Any:
    return obj.value if isinstance(obj, FakeObjectRef) else obj


class FakeActorMethod:
    def __init__(self, handle: "FakeActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args: Any, **kwargs: Any) -> FakeObjectRef:
        handle = self._handle
        if handle._killed:
            raise RuntimeError("Actor was killed")
        backend = handle._backend
        args = tuple(_resolve(a) for a in args)
        kwargs = {k: _resolve(v) for k, v in kwargs.items()}
        if backend is not None and backend.serialize_task_args:
            args, kwargs = pickle.loads(pickle.dumps((args, kwargs)))
        method = getattr(handle._instance, self._name)
        if handle._pool is not None:
            return FakeObjectRef(future=handle._pool.submit(
                method, *args, **kwargs))
        return FakeObjectRef(method(*args, **kwargs))


class FakeActorHandle:
    def __init__(self, instance: Any, options: Dict[str, Any],
                 backend: Optional["FakeRay"] = None,
                 concurrent: bool = False):
        self._instance = instance
        self._options = options
        self._backend = backend
        self._killed = False
        # Ray's actor model: one message processed at a time per actor,
        # actors concurrent with each other → one thread per actor.
        self._pool = ThreadPoolExecutor(max_workers=1) if concurrent else None

    def __getattr__(self, name: str) -> FakeActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return FakeActorMethod(self, name)

    def _shutdown_pool(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=False)


class FakeRemoteClass:
    def __init__(self, cls: type, backend: "FakeRay"):
        self._cls = cls
        self._backend = backend
        self._options: Dict[str, Any] = {}

    def options(self, **options: Any) -> "FakeRemoteClass":
        out = FakeRemoteClass(self._cls, self._backend)
        out._options = options
        return out

    def remote(self, *args: Any, **kwargs: Any) -> FakeActorHandle:
        backend = self._backend
        handle = FakeActorHandle(self._cls(*args, **kwargs),
                                 dict(self._options), backend=backend,
                                 concurrent=backend.concurrent)
        backend.created_actors.append(handle)
        return handle


class FakeQueueHandle:
    """A queue that pickles *by reference* (like a Ray queue's actor
    handle): every unpickled copy in this process puts into the same
    in-process queue."""

    _registry: Dict[int, _queue.Queue] = {}
    _ids = itertools.count()

    def __init__(self, _id: Optional[int] = None):
        if _id is None:
            _id = next(FakeQueueHandle._ids)
            FakeQueueHandle._registry[_id] = _queue.Queue()
        self._id = _id

    def __reduce__(self):
        return (FakeQueueHandle, (self._id,))

    @property
    def _q(self) -> _queue.Queue:
        return FakeQueueHandle._registry[self._id]

    def put(self, item: Any) -> None:
        self._q.put(item)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        return self._q.get(block=block, timeout=timeout)

    def empty(self) -> bool:
        return self._q.empty()

    def shutdown(self) -> None:
        FakeQueueHandle._registry.pop(self._id, None)


class FakeRay:
    """Drop-in module-like object for ``RayLauncher(ray_module=...)``."""

    ObjectRef = FakeObjectRef
    concurrent = False
    serialize_task_args = False
    assigns_gpus = True

    def __init__(self):
        self._initialized = False
        self.created_actors: List[FakeActorHandle] = []
        self.killed_actors: List[FakeActorHandle] = []

    # -- lifecycle ----------------------------------------------------- #
    def init(self, *args: Any, **kwargs: Any) -> None:
        self._initialized = True

    def is_initialized(self) -> bool:
        return self._initialized

    def shutdown(self) -> None:
        self._initialized = False

    # -- object store -------------------------------------------------- #
    def put(self, obj: Any) -> FakeObjectRef:
        return FakeObjectRef(pickle.loads(pickle.dumps(obj)))

    def get(self, refs: Any, timeout: Optional[float] = None) -> Any:
        if isinstance(refs, list):
            return [_resolve(r) for r in refs]
        return _resolve(refs)

    def wait(self, refs: List[Any], num_returns: int = 1,
             timeout: Optional[float] = None
             ) -> Tuple[List[Any], List[Any]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            done = [r for r in refs
                    if not isinstance(r, FakeObjectRef) or r.done()]
            if len(done) >= num_returns or (
                    deadline is not None
                    and time.monotonic() >= deadline):
                # ray.wait caps the ready set at num_returns even when more
                # have finished; the rest stay in the unfinished list.
                ready = done[:num_returns]
                return ready, [r for r in refs if r not in ready]
            time.sleep(0.002)  # tl-lint: allow-sleep — ray.wait poll quantum (wall-clock by contract)

    # -- actors -------------------------------------------------------- #
    def remote(self, cls: type) -> FakeRemoteClass:
        return FakeRemoteClass(cls, self)

    def kill(self, actor: FakeActorHandle, no_restart: bool = False) -> None:
        actor._killed = True
        actor._shutdown_pool()
        self.killed_actors.append(actor)

    # -- the session queue --------------------------------------------- #
    def make_queue(self) -> FakeQueueHandle:
        return FakeQueueHandle()


class ThreadedFakeRay(FakeRay):
    """Concurrent fake: actors run in their own threads, task args cross
    pickle, ``wait`` genuinely polls. The closest no-Ray approximation of
    a local cluster's scheduling semantics."""

    concurrent = True
    serialize_task_args = True


class RecordingExecutor:
    """Fake executor: env writes go to a per-actor dict, not ``os.environ``.

    The counterpart of the reference's ``Node1Actor``/``Node2Actor``
    stubs (``tests/test_ddp.py:80-114``); subclass and override
    ``node_ip()`` / ``gpu_ids()`` to simulate placement.
    """
    instances: List["RecordingExecutor"] = []

    def __init__(self):
        self.env: Dict[str, str] = {}
        self.executed: List[Callable] = []
        type(self).instances.append(self)

    # --- introspection overridden by placement-simulating subclasses --- #
    def node_ip(self) -> str:
        return "127.0.0.1"

    def gpu_ids(self) -> List[int]:
        return []

    # --- executor protocol --------------------------------------------- #
    def set_env_var(self, key: str, value: Optional[str]) -> None:
        if value is None:
            self.env.pop(key, None)
        else:
            self.env[key] = value

    def set_env_vars(self, keys: List[str], values: List[str]) -> None:
        for k, v in zip(keys, values):
            self.set_env_var(k, v)

    def get_env_var(self, key: str) -> Optional[str]:
        return self.env.get(key)

    def get_node_ip(self) -> str:
        return self.node_ip()

    def find_free_port(self) -> int:
        return 29500

    def get_node_and_gpu_ids(self) -> Tuple[str, List[int]]:
        return self.node_ip(), self.gpu_ids()

    def execute(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        self.executed.append(fn)
        return fn(*args, **kwargs)
