"""Unified telemetry: structured events, metrics, and host spans (counterpart of ``ray_lightning_tpu/obs/__init__.py``).

One :class:`Telemetry` handle bundles the three primitives, each the
port's own copy of the JAX package's module:

- :class:`~ray_lightning_tpu_torch.obs.events.EventBus` -- ordered
  structured events (what happened), bounded ring + crash-safe JSONL sink.
- :class:`~ray_lightning_tpu_torch.obs.metrics.MetricsRegistry` --
  counters, gauges, log-bucketed histograms, with ``snapshot()`` and
  Prometheus-text export.
- :class:`~ray_lightning_tpu_torch.obs.spans.SpanRecorder` -- nested
  host spans, exported as Chrome trace-event JSON.

**Off by default, zero when off.** Every instrumented component takes
``telemetry=None`` and guards each emission with one attribute read and
a ``None`` check. Armed, every payload is built from host state (Python
ints and lists of the engine's host row arrays, never a read of a device
tensor), so an armed dispatch adds no launch and no synchronizing call::

    tel = Telemetry(clock=time.perf_counter, jsonl_path="serve.jsonl")
    client = ServeClient(model, state_dict, telemetry=tel, ...)

Process-global channels (fault injection, retry attempts, suppressed
exceptions) have no constructor to thread through; activate the handle
around the workload to capture them too::

    with tel.activated():
        with plan.armed():
            client.serve_trace(trace)
    tel.flush()

Clock contract (shared by bus and spans): ``clock=None`` is the
deterministic tick clock -- events carry no wall time, so the same
workload writes a byte-identical JSONL log every run (and the same bytes
as the JAX package's client on the same trace); ``clock=time.perf_counter``
gives real timestamps.

The trainer takes the same handle (``Trainer(telemetry=tel)``: the
launch, worker, fit and epoch lifecycle events, the profiler's sections
as gauges), and :class:`StepStatsCallback` adds per-step timing and the
straggler detector. The per-request trace assembler
(``Telemetry.request_traces``) comes with ``ROADMAP.md`` S8.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

from ray_lightning_tpu_torch.obs.events import Event, EventBus, JsonlSink
from ray_lightning_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                                 MetricsRegistry,
                                                 DEFAULT_LATENCY_BUCKETS,
                                                 log_buckets)
from ray_lightning_tpu_torch.obs.spans import NULL_SPAN, Span, SpanRecorder


class Telemetry:
    """One handle bundling event bus + metrics registry + span recorder.

    ``clock`` (None = deterministic tick mode) is shared by the bus and
    the span recorder. ``jsonl_path`` arms the crash-safe event log;
    without it events live only in the in-memory ring.
    """

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 capacity: int = 4096,
                 jsonl_path: Optional[str] = None,
                 rotate_bytes: int = 4 << 20,
                 flush_every: int = 256):
        self.clock = clock
        self.bus = EventBus(capacity=capacity, clock=clock,
                            jsonl_path=jsonl_path,
                            rotate_bytes=rotate_bytes,
                            flush_every=flush_every)
        self.metrics = MetricsRegistry()
        self.spans = SpanRecorder(clock=clock)
        # ring-overflow drops surface as a counter so truncated traces
        # are visible in snapshot()/Prometheus, not just on the bus
        self.bus._drop_hook = self.metrics.counter(
            "obs_events_dropped_total",
            help="events evicted from the in-memory ring before being "
                 "read (the JSONL sink, when armed, still has them)").inc

    # ------------------------------------------------------ conveniences
    def event(self, site: str, /, **payload: Any) -> Event:
        return self.bus.emit(site, **payload)

    def span(self, name: str, **args: Any):
        return self.spans.span(name, **args)

    def events(self, site: Optional[str] = None) -> List[Event]:
        return self.bus.events(site)

    def flush(self) -> None:
        self.bus.flush()

    # --------------------------------------------------------- global
    def activated(self) -> "_Activated":
        """Install as the process-global handle for the channels that
        have no constructor seat: ``faults.fire`` injections,
        ``call_with_retry`` attempts, and ``log_suppressed`` records all
        land on the *activated* telemetry. Nests stack-wise (the previous
        handle is restored on exit)."""
        return _Activated(self)


class _Activated:
    def __init__(self, tel: Telemetry):
        self._tel = tel
        self._prev: Optional[Telemetry] = None

    def __enter__(self) -> Telemetry:
        global _GLOBAL
        self._prev = _GLOBAL
        _GLOBAL = self._tel
        return self._tel

    def __exit__(self, *exc_info) -> None:
        global _GLOBAL
        _GLOBAL = self._prev


_GLOBAL: Optional[Telemetry] = None


def get_global() -> Optional[Telemetry]:
    """The activated process-global handle, or None (the default)."""
    return _GLOBAL


def set_global(tel: Optional[Telemetry]) -> None:
    """Install (or clear, with None) the process-global handle directly —
    prefer the scoped :meth:`Telemetry.activated` where possible."""
    global _GLOBAL
    _GLOBAL = tel


def emit_global(site: str, /, **payload: Any) -> None:
    """Hot-path hook for the global channels: one module-global read and
    a None check when no handle is activated — the same zero-cost
    contract as ``faults.fire``."""
    tel = _GLOBAL
    if tel is None:
        return
    tel.bus.emit(site, **payload)


# imported late: stepstats pulls in core.callbacks, which must find the
# primitives above already defined
from ray_lightning_tpu_torch.obs.stepstats import \
    StepStatsCallback  # noqa: E402

__all__ = [
    "Telemetry", "Event", "EventBus", "JsonlSink",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS", "log_buckets",
    "Span", "SpanRecorder", "NULL_SPAN", "StepStatsCallback",
    "get_global", "set_global", "emit_global",
]
