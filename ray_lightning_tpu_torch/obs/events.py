"""Process-local structured event bus (copied from ``ray_lightning_tpu/obs/events.py``).

The port's own copy (the port imports nothing of the JAX package),
unchanged but for this paragraph and the module paths: the same ring,
tick clock, site filter, drop counter and JSONL sink, so a tick-clock
run writes the same bytes as the JAX package's.

One :class:`Event` is one thing that *happened* at a named site —
``serve.retire``, ``fault.injected``, ``engine.rebuild`` — with a small
JSON-able payload. The bus is deliberately tiny: a bounded in-memory ring
(recent history for probes and tests) plus an optional crash-safe JSONL
sink (the durable operator-facing log). It is NOT a metrics system
(:mod:`~ray_lightning_tpu_torch.obs.metrics` owns aggregates) and NOT a tracer
(:mod:`~ray_lightning_tpu_torch.obs.spans` owns durations) — events are the
ordered, discrete record: *what* happened, in *what order*.

Two clock modes, mirroring :class:`~ray_lightning_tpu_torch.serve.client.ServeClient`:

- **tick clock** (``clock=None``, the default): ``Event.wall_ms`` is
  ``None`` and the only time coordinate is ``tick`` — the bus's emit
  counter. Fully deterministic: the same workload emits a byte-identical
  JSONL log every run, which is what the serving chaos tests pin.
- **wall clock** (``clock=time.perf_counter`` or any callable):
  ``wall_ms`` is milliseconds since the bus's first emit — real
  timestamps for production logs.

The JSONL sink uses the same tmp + ``os.replace`` discipline as
checkpointing: every flush atomically publishes the *complete* current
segment, so a reader (or a crash) never sees a torn line. When a segment
outgrows ``rotate_bytes`` it is rotated to ``<path>.1`` (one generation
kept) and a fresh segment starts.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured occurrence: site + bus tick (+ wall time) + payload."""
    site: str
    tick: int                      # per-bus emit index (0-based)
    wall_ms: Optional[float]       # None under the tick clock
    payload: Dict[str, Any]

    def to_json(self) -> str:
        """Compact, key-sorted JSON — stable bytes for deterministic logs."""
        doc: Dict[str, Any] = {"site": self.site, "tick": self.tick,
                               "payload": self.payload}
        if self.wall_ms is not None:
            doc["wall_ms"] = round(self.wall_ms, 3)
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))


class JsonlSink:
    """Crash-safe JSONL segment writer (tmp + ``os.replace`` publish).

    Lines accumulate in memory and are serialized lazily; ``flush()``
    writes the whole current segment to ``<path>.tmp-<pid>`` and
    atomically replaces ``path`` — the published file is always complete,
    valid JSONL. Rotation: once the segment passes ``rotate_bytes`` the
    published file moves to ``<path>.1`` and the segment restarts.
    """

    def __init__(self, path: str, rotate_bytes: int = 4 << 20):
        self.path = path
        self.rotate_bytes = rotate_bytes
        self._lines: List[str] = []
        self._bytes = 0
        self._dirty = False

    def write(self, line: str) -> None:
        self._lines.append(line)
        self._bytes += len(line) + 1
        self._dirty = True

    def flush(self) -> None:
        if not self._dirty:
            return
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write("\n".join(self._lines) + "\n")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):  # failed before the rename: no litter
                os.remove(tmp)
        self._dirty = False
        if self._bytes > self.rotate_bytes:
            os.replace(self.path, f"{self.path}.1")
            self._lines = []
            self._bytes = 0
            # publish the fresh (empty) segment so `path` always exists
            open(self.path, "w").close()


class EventBus:
    """Bounded ring of recent :class:`Event`\\ s + optional JSONL sink.

    ``emit(site, **payload)`` is the single producer call. The ring keeps
    the last ``capacity`` events for in-process probes; the sink (when a
    ``jsonl_path`` is given) keeps the full segment history on disk,
    auto-flushed every ``flush_every`` emits and on :meth:`flush`.
    Payload values must be JSON-serializable scalars/lists/dicts — call
    sites keep payloads small (ids, counts, reasons), never arrays.
    """

    def __init__(self, capacity: int = 4096,
                 clock: Optional[Callable[[], float]] = None,
                 jsonl_path: Optional[str] = None,
                 rotate_bytes: int = 4 << 20,
                 flush_every: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._clock = clock
        self._t0: Optional[float] = None
        self._tick = 0
        self._flush_every = max(1, flush_every)
        self._sink = (JsonlSink(jsonl_path, rotate_bytes)
                      if jsonl_path else None)
        # ring-overflow accounting, mirroring SpanRecorder.dropped: the
        # sink (when armed) still keeps every line — drops only truncate
        # the in-memory ring that probes and the trace assembler read.
        self.dropped = 0
        self._warned_drop = False
        self._drop_hook: Optional[Callable[[], Any]] = None

    @property
    def tick(self) -> int:
        """Total events emitted (the next event's ``tick``)."""
        return self._tick

    def __getstate__(self):
        # a pickled bus is a WORKER-SIDE copy (remote launchers ship the
        # trainer, telemetry included): the driver process owns the
        # jsonl segment, and a copy flushing the same path would
        # atomically clobber it with only its own events. Copies keep
        # the ring (local probes still work) but lose the sink.
        state = self.__dict__.copy()
        state["_sink"] = None
        # the hook closes over the DRIVER's metrics registry — a worker
        # copy incrementing it would double-count (and may not pickle)
        state["_drop_hook"] = None
        return state

    def emit(self, site: str, /, **payload: Any) -> Event:
        # `site` is positional-only so a payload may carry its own
        # "site" key (e.g. fault.injected records the *fault's* site)
        wall_ms = None
        if self._clock is not None:
            now = self._clock()
            if self._t0 is None:
                self._t0 = now
            wall_ms = (now - self._t0) * 1e3
        ev = Event(site=site, tick=self._tick, wall_ms=wall_ms,
                   payload=payload)
        self._tick += 1
        evicting = len(self._ring) == self._ring.maxlen
        if evicting:
            self.dropped += 1
            if self._drop_hook is not None:
                self._drop_hook()
        self._ring.append(ev)
        if self._sink is not None:
            self._sink.write(ev.to_json())
            if self._tick % self._flush_every == 0:
                self._sink.flush()
        if evicting and not self._warned_drop:
            # one-shot, so a truncated ring is self-describing; the flag
            # flips BEFORE the nested emit (which itself evicts one more
            # ring entry, counted like any other) to bound the recursion
            self._warned_drop = True
            self.emit("obs.events_dropped", capacity=self._ring.maxlen)
        return ev

    def events(self, site: Optional[str] = None) -> List[Event]:
        """Ring contents (oldest first), optionally filtered by site
        (exact match, or a ``"prefix."`` match when ``site`` ends with
        a dot)."""
        evs = list(self._ring)
        if site is None:
            return evs
        if site.endswith("."):
            return [e for e in evs if e.site.startswith(site)]
        return [e for e in evs if e.site == site]

    def flush(self) -> None:
        """Publish the sink segment (atomic tmp + ``os.replace``)."""
        if self._sink is not None:
            self._sink.flush()
