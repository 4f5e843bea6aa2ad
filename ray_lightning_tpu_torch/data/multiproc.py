"""Multiprocess data loading over the native shared-memory ring (counterpart of ``ray_lightning_tpu/data/multiproc.py``).

Worker *processes* run the Python-bound batch assembly, and batches come
back through the native ring (``csrc/shm_ring.cpp``) as raw bytes: pickle
protocol 5 with out-of-band buffers, so an array's memory crosses into
shared memory once and comes out as a window into the one buffer the
consumer popped. Blocking happens inside the C call with the GIL
released, so the trainer's step overlaps the loading.

Ordering is deterministic: worker ``i`` produces logical batches ``i,
i+N, i+2N, ...`` into its own ring and the consumer takes them round
robin, so the sequence equals the in-process loader's exactly.

The popped buffer is a fresh, writable allocation, so the arrays rebuilt
over it are writable: ``torch.from_numpy`` takes them without a copy and
without the read-only warning (the trainer's ``_to_device`` does exactly
that). :class:`DevicePrefetcher` moves each batch to the card through
pinned staging buffers on a side CUDA stream.
"""
from __future__ import annotations

import collections
import multiprocessing as mp
import os
import pickle
import struct
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch._native import ShmRing, native_available
from ray_lightning_tpu_torch.data.loader import tree_map
from ray_lightning_tpu_torch.device import resolve_device


def _pack_frames(obj: Any) -> list:
    """Serialize ``obj`` into scatter-gather segments for
    :meth:`ShmRing.push_buffers`: pickle protocol 5 with out-of-band
    buffers, so numpy arrays are not copied into the pickle stream.

    Wire layout (one ring message):
    ``[u64 n_buf][u64 meta_len][u64 len_i x n_buf][meta][buf_0]...[buf_n]``
    """
    pickle_bufs: list = []
    meta = pickle.dumps(obj, protocol=5, buffer_callback=pickle_bufs.append)
    raws = [b.raw() for b in pickle_bufs]
    header = struct.pack("<QQ", len(raws), len(meta))
    header += struct.pack(f"<{len(raws)}Q", *[m.nbytes for m in raws])
    return [header, meta] + raws


def _unpack_frames(view: memoryview) -> Any:
    """Inverse of :func:`_pack_frames` over a popped message: the
    out-of-band buffers are slices of ``view``, so numpy arrays come back
    as zero-copy windows into it (writable, as ``view`` is)."""
    n_buf, meta_len = struct.unpack_from("<QQ", view, 0)
    off = 16
    lens = struct.unpack_from(f"<{n_buf}Q", view, off)
    off += 8 * n_buf
    meta = view[off:off + meta_len]
    off += meta_len
    bufs = []
    for ln in lens:
        bufs.append(view[off:off + ln])
        off += ln
    return pickle.loads(meta, buffers=bufs)


def default_mp_context() -> str:
    """``spawn`` once this process has initialized CUDA (a forked child
    inherits a CUDA context it cannot use, and its first CUDA call
    fails), ``fork`` otherwise (the dataset is inherited copy-on-write,
    nothing is pickled). Producers touch numpy and the ring only."""
    return "spawn" if torch.cuda.is_initialized() else "fork"


def _worker_batches(loader, worker_id: int, num_workers: int):
    """Batches ``worker_id, worker_id + N, ...`` of the loader's sequence:
    through the loader's ``iter_batches(start, step)`` when it has one
    (only this worker's share is gathered), else enumerate-and-skip."""
    if hasattr(loader, "iter_batches"):
        yield from loader.iter_batches(start=worker_id, step=num_workers)
        return
    for idx, batch in enumerate(loader):
        if idx % num_workers == worker_id:
            yield batch


def _producer(loader, worker_id: int, num_workers: int,
              ring_name: str) -> None:
    ring = ShmRing.attach(ring_name)
    try:
        for batch in _worker_batches(loader, worker_id, num_workers):
            ring.push_buffers(_pack_frames(("batch", batch)), timeout=600.0)
    except BrokenPipeError:
        # the consumer closed the ring: it stopped early (a step limit,
        # an abandoned iterator) and wants nothing more
        return
    except BaseException as e:  # ship the error, never truncate silently
        import traceback
        try:
            ring.push_buffers(
                _pack_frames(("error", repr(e), traceback.format_exc())),
                timeout=5.0)
        except Exception as push_exc:  # noqa: BLE001 -- the exit code
            # still reports the failure to the consumer
            from ray_lightning_tpu_torch.reliability import log_suppressed
            log_suppressed("multiproc.error_report", push_exc,
                           "could not ship the worker error over the ring")
        raise
    finally:
        ring.close()


class MultiprocessDataLoader:
    """Wraps any re-iterable loader with N producer processes.

    Each ``__iter__`` starts fresh producers, so the wrapper is
    re-iterable and epoch-aware exactly like the inner loader.

    ``mp_context``: ``None`` picks :func:`default_mp_context` each time
    the producers start (so a loader built before CUDA started spawns
    once it has); ``"spawn"`` pickles the loader and re-imports the
    caller's ``__main__`` in each child (a script needs its ``if __name__
    == "__main__":`` guard).

    ``auto_fallback``: producers only pay off on spare cores, so by
    default the ring is used only with at least 2 host cores and the
    worker count is capped at ``cores - 1``; ``auto_fallback=False``
    forces the ring regardless. Without the native library
    (``TL_DISABLE_NATIVE=1``) the loader iterates in-process.

    Each pass through the ring keeps ``stats``: ``first_batch_s`` (from
    starting the producers to the first batch popped: their start-up
    cost), ``batches`` and ``bytes`` popped so far, ``pop_s`` (seconds
    inside the pops: waiting for a producer plus the copy out of shared
    memory) and, once the pass has ended, ``seconds``.
    """

    def __init__(self, loader: Any, num_workers: int = 2,
                 ring_capacity: int = 64 << 20,
                 mp_context: Optional[str] = None,
                 auto_fallback: bool = True):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.loader = loader
        self.ring_capacity = ring_capacity
        self._mp_context = mp_context
        self.native = native_available()
        cores = os.cpu_count() or 1
        if auto_fallback:
            self.num_workers = max(1, min(num_workers, cores - 1))
            self.uses_ring = self.native and cores >= 2
        else:
            self.num_workers = num_workers
            self.uses_ring = self.native
        self.stats: Dict[str, float] = {}

    @property
    def mp_context(self) -> str:
        return self._mp_context or default_mp_context()

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Any]:
        if not self.uses_ring:
            # in-process: the identical sequence, no overlap
            yield from self.loader
            return
        run_id = uuid.uuid4().hex[:12]
        rings: List[ShmRing] = []
        procs = []
        ctx = mp.get_context(self.mp_context)
        t0 = time.perf_counter()
        stats = {"first_batch_s": None, "bytes": 0, "batches": 0,
                 "pop_s": 0.0}
        self.stats = stats
        try:
            for w in range(self.num_workers):
                name = f"/tl_{os.getpid()}_{run_id}_{w}"
                rings.append(ShmRing(name, capacity=self.ring_capacity))
                p = ctx.Process(target=_producer,
                                args=(self.loader, w, self.num_workers,
                                      name), daemon=True)
                p.start()
                procs.append(p)
            done = [False] * self.num_workers
            w = 0
            while not all(done):
                if not done[w]:
                    t_pop = time.perf_counter()
                    msg = rings[w].pop_view(timeout=600.0)
                    stats["pop_s"] += time.perf_counter() - t_pop
                    if msg is None:
                        done[w] = True
                        # clean exhaustion or a crash: a dead producer
                        # must never silently truncate the epoch
                        procs[w].join(timeout=30.0)
                        if procs[w].exitcode not in (0, None):
                            raise RuntimeError(
                                f"data worker {w} exited with code "
                                f"{procs[w].exitcode}")
                    else:
                        if stats["first_batch_s"] is None:
                            stats["first_batch_s"] = time.perf_counter() - t0
                        stats["bytes"] += msg.nbytes
                        kind, *payload = _unpack_frames(msg)
                        if kind == "error":
                            raise RuntimeError(
                                f"data worker {w} failed: {payload[0]}\n"
                                f"{payload[1]}")
                        stats["batches"] += 1
                        yield payload[0]
                w = (w + 1) % self.num_workers
            stats["seconds"] = time.perf_counter() - t0
        finally:
            for r in rings:
                r.close()
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
            for r in rings:
                r.destroy()


class DevicePrefetcher:
    """Moves batch k+1 to the device while the step consumes batch k.

    ``device=None`` means the card (the port's device rule; the JAX
    prefetcher's ``sharding=None`` passes batches through). On a CUDA
    device each numpy or CPU-tensor leaf is copied into a pinned host
    staging buffer and from there to the card with ``non_blocking=True``
    on a side stream; the consumer's stream waits on that copy's event
    before it sees the batch, and every tensor is ``record_stream``-ed
    onto it, so the caching allocator never hands its memory out while
    the step still reads it. A staging buffer goes back to the pool only
    after its copy's event has fired. Leaves already on the device pass
    through untouched, and ``Trainer._to_device`` then moves nothing (it
    only casts floating leaves under bf16 precision). On a CPU device a
    leaf becomes a tensor over the same memory (``torch.from_numpy``; a
    read-only array is copied once, explicitly).

    The prefetcher moves whole batches: under a world size above 1 give
    it this rank's rows (``Strategy.shard_batch`` would otherwise slice a
    global batch that is already on the card). ``copies`` and ``bytes``
    count the host-to-device copies it made.
    """

    def __init__(self, loader: Any, device=None, depth: int = 2):
        self.loader = loader
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.depth = max(1, depth)
        self.copies = 0
        self.bytes = 0
        self._stream = None
        # (shape, dtype) -> free pinned buffers; (event, buffers) in flight
        self._free: Dict[Tuple, List[torch.Tensor]] = {}
        self._in_flight: collections.deque = collections.deque()

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    # ------------------------------------------------------------- stage
    def _recycle(self) -> None:
        """Return the staging buffers of every finished copy to the pool
        (in copy order; ``query()`` never blocks)."""
        while self._in_flight and self._in_flight[0][0].query():
            _, bufs = self._in_flight.popleft()
            for buf in bufs:
                self._free.setdefault((tuple(buf.shape), buf.dtype),
                                      []).append(buf)

    def _pinned(self, shape: Tuple[int, ...], dtype) -> torch.Tensor:
        free = self._free.get((shape, dtype))
        if free:
            return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _put_cuda(self, batch: Any) -> Tuple[Any, Any]:
        self._recycle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        staged: List[torch.Tensor] = []

        def move(x):
            if isinstance(x, torch.Tensor):
                if x.device == self.device:
                    return x
                x = x.numpy()
            arr = np.asarray(x)
            host = self._pinned(arr.shape, torch.from_numpy(
                np.empty(0, arr.dtype)).dtype)
            np.copyto(host.numpy(), arr)
            dev = torch.empty(arr.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(host, non_blocking=True)
            staged.append(host)
            self.copies += 1
            self.bytes += arr.nbytes
            return dev

        with torch.cuda.stream(self._stream):
            out = tree_map(move, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._in_flight.append((event, staged))
        return out, event

    def _put(self, batch: Any) -> Tuple[Any, Any]:
        if self.device.type == "cuda":
            return self._put_cuda(batch)

        def as_tensor(x):
            if isinstance(x, torch.Tensor):
                return x.to(self.device)
            arr = np.asarray(x)
            if not arr.flags.writeable:
                arr = arr.copy()
            return torch.from_numpy(arr)

        return tree_map(as_tensor, batch), None

    def _ready(self, staged: Tuple[Any, Any]) -> Any:
        """The batch, safe to read on the consumer's current stream."""
        batch, event = staged
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)

            def mark(t):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(stream)
                return t

            tree_map(mark, batch)
        return batch

    def __iter__(self) -> Iterator[Any]:
        buf = collections.deque()
        it = iter(self.loader)
        for batch in it:
            buf.append(self._put(batch))
            if len(buf) > self.depth:
                yield self._ready(buf.popleft())
        while buf:
            yield self._ready(buf.popleft())
