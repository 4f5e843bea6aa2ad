"""Native host components (C++), loaded through ctypes (counterpart of ``ray_lightning_tpu/_native/__init__.py``).

The shared-memory ring buffer behind the multiprocess data loader
(``csrc/shm_ring.cpp``, a byte-for-byte copy of the JAX package's
source). It is host code: :func:`~ray_lightning_tpu_torch._build.build_host`
compiles it with ``g++`` at first use into ``_build/lib<name>-<hash>.so``
(gitignored), never into the source tree.

Unlike the JAX loader, a failed build is not a quiet fallback:
:func:`load` raises ``RuntimeError`` with the compiler's output.
``TL_DISABLE_NATIVE=1`` is the one explicit opt-out: :func:`load` then
returns None, :func:`native_available` is False, and
:class:`~ray_lightning_tpu_torch.data.multiproc.MultiprocessDataLoader`
iterates in-process.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

from ray_lightning_tpu_torch import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _declare(lib: ctypes.CDLL) -> None:
    lib.tlshm_create.restype = ctypes.c_void_p
    lib.tlshm_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.tlshm_open.restype = ctypes.c_void_p
    lib.tlshm_open.argtypes = [ctypes.c_char_p]
    lib.tlshm_push.restype = ctypes.c_int
    lib.tlshm_push.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_double
    ]
    lib.tlshm_push_v.restype = ctypes.c_int
    lib.tlshm_push_v.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_double
    ]
    lib.tlshm_peek.restype = ctypes.c_int64
    lib.tlshm_peek.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.tlshm_pop.restype = ctypes.c_int64
    lib.tlshm_pop.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_double
    ]
    lib.tlshm_count.restype = ctypes.c_uint64
    lib.tlshm_count.argtypes = [ctypes.c_void_p]
    lib.tlshm_is_closed.restype = ctypes.c_int
    lib.tlshm_is_closed.argtypes = [ctypes.c_void_p]
    lib.tlshm_close.restype = None
    lib.tlshm_close.argtypes = [ctypes.c_void_p]
    lib.tlshm_destroy.restype = None
    lib.tlshm_destroy.argtypes = [ctypes.c_void_p]


def load() -> Optional[ctypes.CDLL]:
    """The ring library, built on first call (cached per process). None
    only under ``TL_DISABLE_NATIVE=1``; a failed build raises."""
    global _lib
    if os.environ.get("TL_DISABLE_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host("shm_ring")))
            _declare(lib)
            _lib = lib
    return _lib


def native_available() -> bool:
    """False only under the ``TL_DISABLE_NATIVE=1`` opt-out."""
    return load() is not None


class ShmRing:
    """Cross-process byte-message ring over POSIX shared memory.

    Push and pop block inside the native call with the GIL released, so a
    producer process feeding batches overlaps the consumer's step. A
    message may take at most half the ring's capacity.
    """

    def __init__(self, name: str, capacity: int = 64 << 20,
                 create: bool = True):
        lib = load()
        if lib is None:
            raise RuntimeError(
                "the native ring is disabled (TL_DISABLE_NATIVE is set); "
                "use the in-process loader path instead")
        self._lib = lib
        self.name = name.encode() if isinstance(name, str) else name
        if create:
            self._h = lib.tlshm_create(self.name, capacity)
        else:
            self._h = lib.tlshm_open(self.name)
        if not self._h:
            raise OSError(
                f"Could not {'create' if create else 'open'} shared-memory "
                f"ring {name!r}")

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        return cls(name, create=False)

    @staticmethod
    def _check(rc: int, nbytes: int) -> None:
        if rc == -1:
            raise TimeoutError("ring full")
        if rc == -2:
            raise BrokenPipeError("ring closed")
        if rc == -3:
            raise ValueError(
                f"message of {nbytes} bytes exceeds half the ring "
                "capacity; enlarge the ring")

    def push(self, data: bytes, timeout: float = 10.0) -> None:
        self._check(self._lib.tlshm_push(self._h, data, len(data), timeout),
                    len(data))

    def push_buffers(self, buffers, timeout: float = 10.0) -> None:
        """Scatter-gather push: one message assembled from several
        buffer-protocol segments (bytes, memoryviews, numpy arrays), each
        copied straight from its own memory into the ring. A strided
        segment is made contiguous first (one extra copy of that
        segment)."""
        import numpy as np

        def as_u8(b):
            try:
                return np.frombuffer(b, dtype=np.uint8)
            except (ValueError, BufferError):
                return np.ascontiguousarray(b).reshape(-1).view(np.uint8)

        n = len(buffers)
        # `views` keeps every segment alive across the native call
        views = [as_u8(b) for b in buffers]
        ptrs = (ctypes.c_void_p * n)(*[v.ctypes.data for v in views])
        lens = (ctypes.c_uint64 * n)(*[v.nbytes for v in views])
        self._check(self._lib.tlshm_push_v(self._h, ptrs, lens, n, timeout),
                    sum(v.nbytes for v in views))

    def pop_view(self, timeout: float = 10.0) -> Optional[memoryview]:
        """Next message as a writable memoryview over a freshly allocated
        buffer (one shared-memory-to-host copy), or None when the ring is
        closed and drained. The view owns the buffer: arrays rebuilt over
        slices of it stay valid while referenced."""
        size = self._lib.tlshm_peek(self._h, timeout)
        if size == -2:
            return None
        if size == -1:
            raise TimeoutError("ring empty")
        buf = ctypes.create_string_buffer(int(size))
        n = self._lib.tlshm_pop(self._h, buf, int(size), timeout)
        if n == -2:
            return None
        if n == -1:
            raise TimeoutError("ring empty")
        if n < 0:
            raise OSError(f"ring pop failed ({n})")
        return memoryview(buf)[:int(n)]

    def pop(self, timeout: float = 10.0) -> Optional[bytes]:
        """Next message, or None when the ring is closed and drained."""
        view = self.pop_view(timeout)
        return None if view is None else view.tobytes()

    def __len__(self) -> int:
        return int(self._lib.tlshm_count(self._h))

    @property
    def closed(self) -> bool:
        return bool(self._lib.tlshm_is_closed(self._h))

    def close(self) -> None:
        self._lib.tlshm_close(self._h)

    def destroy(self) -> None:
        if self._h:
            self._lib.tlshm_destroy(self._h)
            self._h = None

    def __del__(self):  # best effort; an explicit destroy() is preferred
        try:
            self.destroy()
        except Exception:  # noqa: BLE001 -- may run at interpreter exit
            pass
