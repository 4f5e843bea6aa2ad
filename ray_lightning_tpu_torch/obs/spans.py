"""Nestable host-side spans, exported as Chrome trace-event JSON (copied from ``ray_lightning_tpu/obs/spans.py``).

The port's own copy, unchanged but for this paragraph and the export's
docstring. :class:`SpanRecorder` records host work -- scheduler
decisions, prefill-vs-step dispatch, recovery replays -- as nested
begin/end spans and exports the Chrome trace-event format
(``{"traceEvents": [...]}`` with complete ``"ph": "X"`` events), which
Perfetto loads beside a ``torch.profiler`` device trace. The spans time
the host only: they open no NVTX range and no profiler record.

Clock modes, same contract as the event bus:

- **tick** (``clock=None``): timestamps are a monotone enter/exit
  counter — deterministic nesting, no wall time. A child span's
  ``[ts, ts+dur]`` is always strictly inside its parent's.
- **wall** (``clock=time.perf_counter``): microsecond timestamps from
  the injected clock, zeroed at the recorder's first span.

Export uses the same tmp + ``os.replace`` publish as checkpoints and the
JSONL sink: the file on disk is always complete, valid JSON.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional

#: Reusable no-op context for disarmed call sites: ``with (tel.span(...)
#: if tel is not None else NULL_SPAN):`` keeps the hot loop allocation-free.
NULL_SPAN = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed span: name, [ts, ts+dur] (µs or ticks), depth, args."""
    name: str
    ts: float
    dur: float
    depth: int
    args: Dict[str, Any]


class SpanRecorder:
    """Record nested host spans; export Chrome trace-event JSON.

    Use as a context manager factory::

        rec = SpanRecorder()
        with rec.span("epoch", epoch=0):
            with rec.span("train_batch", idx=0):
                ...
        rec.export_chrome_trace("host_trace.json")

    Spans close LIFO per recorder (host-side, single-threaded by design —
    the trainer loop and the serve loop are both synchronous drivers).
    The recorder keeps at most ``capacity`` *closed* spans, dropping the
    oldest; the open stack is unbounded (its depth is the nesting depth).
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 capacity: int = 65536):
        self._clock = clock
        self._t0: Optional[float] = None
        self._seq = 0          # tick mode: advances at every enter/exit
        self._stack: List[tuple] = []
        self._closed: List[Span] = []
        self._capacity = capacity
        self.dropped = 0

    # ------------------------------------------------------------ clock
    def _now(self) -> float:
        if self._clock is None:
            t = float(self._seq)
            self._seq += 1
            return t
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        return (now - self._t0) * 1e6  # µs, Chrome's unit

    # ------------------------------------------------------------ spans
    @contextlib.contextmanager
    def span(self, name: str, **args: Any):
        self.begin(name, **args)
        try:
            yield self
        finally:
            self.end()

    def begin(self, name: str, **args: Any) -> None:
        """Explicit begin (for code where a ``with`` block is awkward,
        e.g. spanning a loop iteration). Pair with :meth:`end` — spans
        close LIFO."""
        self._stack.append((name, self._now(), args))

    def end(self) -> None:
        if not self._stack:
            raise RuntimeError("SpanRecorder.end() with no open span")
        name, ts, args = self._stack.pop()
        self._closed.append(Span(name=name, ts=ts, dur=self._now() - ts,
                                 depth=len(self._stack), args=args))
        if len(self._closed) > self._capacity:
            del self._closed[0]
            self.dropped += 1

    def record_closed(self, name: str, ts: float, dur: float,
                      depth: int = 0,
                      args: Optional[Dict[str, Any]] = None) -> None:
        """Import one already-closed span measured elsewhere — the
        process-backend ``MSG_SPAN`` leg lands here: a worker stamped
        ``[ts, ts+dur]`` on the shared fleet timeline (µs since the
        fleet epoch) and shipped the closed span over the manager queue.
        Imported spans keep their own timestamps (they are NOT re-zeroed
        against this recorder's ``_t0``) and respect the same capacity /
        ``dropped`` accounting as locally recorded spans."""
        self._closed.append(Span(name=name, ts=float(ts), dur=float(dur),
                                 depth=int(depth), args=dict(args or {})))
        if len(self._closed) > self._capacity:
            del self._closed[0]
            self.dropped += 1

    @property
    def open_depth(self) -> int:
        return len(self._stack)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Closed spans in completion order (children before parents)."""
        if name is None:
            return list(self._closed)
        return [s for s in self._closed if s.name == name]

    # ------------------------------------------------------------ export
    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event document: complete (``ph="X"``) events,
        sorted by start time so viewers rebuild the nesting directly.
        ``pid``/``tid`` are fixed at 0 — one host process, one logical
        track — so the document is deterministic under the tick clock."""
        events = [
            {"name": s.name, "ph": "X", "ts": s.ts, "dur": s.dur,
             "pid": 0, "tid": 0, "args": s.args}
            for s in sorted(self._closed, key=lambda s: (s.ts, -s.dur))
        ]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Atomically publish the trace JSON (tmp + ``os.replace``);
        returns ``path``. Load it in Perfetto/``chrome://tracing`` next
        to a device trace."""
        doc = self.chrome_trace()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path
