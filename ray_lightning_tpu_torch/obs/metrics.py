"""Metrics registry: counters, gauges, and log-bucketed histograms (copied from ``ray_lightning_tpu/obs/metrics.py``).

The port's own copy, unchanged but for this paragraph: the same
instruments, quantiles, snapshot and Prometheus text.

The aggregate side of the telemetry layer (events record *occurrences*,
metrics record *totals and distributions*). Three instrument types, the
Prometheus trinity:

- :class:`Counter` — monotonically increasing total (requests served,
  faults injected, tokens generated).
- :class:`Gauge` — a value that goes both ways (queue depth, slot
  occupancy, tokens/sec).
- :class:`Histogram` — fixed log-spaced buckets for latency-shaped
  distributions, PLUS a bounded reservoir of raw samples so quantiles are
  *exact* (numpy-``percentile``-identical linear interpolation) until the
  reservoir cap, and bucket-interpolated after it.

:class:`MetricsRegistry` is the name → instrument map with ``snapshot()``
(plain dict for tests/driver transport) and ``prometheus_text()`` (the
``text/plain; version=0.0.4`` exposition format, scrape-ready).
Instruments are get-or-create by name; re-registering a name as a
different type raises — name collisions are config bugs, not data.
"""
from __future__ import annotations

import bisect
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple


def log_buckets(lo: float, hi: float, count: int) -> Tuple[float, ...]:
    """``count`` log-spaced bucket upper bounds from ``lo`` to ``hi``."""
    if lo <= 0 or hi <= lo or count < 2:
        raise ValueError(
            f"need 0 < lo < hi and count >= 2, got {lo}, {hi}, {count}")
    ratio = (hi / lo) ** (1.0 / (count - 1))
    return tuple(lo * ratio ** i for i in range(count))


# 0.1 ms .. 60 s in ~5 buckets/decade — covers a tick-clock trace (small
# integers) and wall-clock serving latencies in ms with one fixed layout
DEFAULT_LATENCY_BUCKETS = log_buckets(0.1, 60_000.0, 30)


class Counter:
    """Monotonic total. ``inc()`` only — decrements are a type error in
    the model; use a :class:`Gauge` for values that go down."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """A point-in-time value: set/inc/dec."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    def dec(self, n: float = 1.0) -> None:
        self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram + exact-quantile reservoir.

    ``buckets`` are upper bounds (``le``), a ``+Inf`` bucket is implicit.
    ``observe()`` is O(log buckets). Quantiles: while ``count <=
    max_samples`` every observation is retained and ``quantile(q)``
    matches ``np.percentile(samples, 100*q)`` (linear interpolation)
    exactly; past the cap the reservoir stops growing and quantiles fall
    back to linear interpolation *within* the bucket the quantile rank
    lands in — bounded error, bounded memory.
    """

    __slots__ = ("name", "help", "buckets", "counts", "sum", "count",
                 "_samples", "_max_samples")

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None,
                 max_samples: int = 4096):
        self.name = name
        self.help = help
        bs = tuple(sorted(buckets if buckets is not None
                          else DEFAULT_LATENCY_BUCKETS))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0
        self._samples: List[float] = []
        self._max_samples = max_samples

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            raise ValueError(f"histogram {self.name}: NaN observation")
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        if len(self._samples) < self._max_samples:
            self._samples.append(v)

    def quantile(self, q: float) -> float:
        """q in [0, 1]. Exact (numpy-linear) while the reservoir holds
        every observation; bucket-interpolated afterwards."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            raise ValueError(f"histogram {self.name} is empty")
        if self.count == len(self._samples):
            s = sorted(self._samples)
            h = (len(s) - 1) * q
            lo = math.floor(h)
            hi = min(lo + 1, len(s) - 1)
            return s[lo] + (h - lo) * (s[hi] - s[lo])
        # bucket interpolation: find the bucket holding rank q*count,
        # assume uniform density inside it
        rank = q * self.count
        cum = 0
        lower = 0.0
        for i, c in enumerate(self.counts):
            upper = (self.buckets[i] if i < len(self.buckets)
                     else self.buckets[-1])
            if cum + c >= rank and c > 0:
                frac = (rank - cum) / c
                return lower + frac * (upper - lower)
            cum += c
            lower = upper
        return self.buckets[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Name → instrument, get-or-create, with snapshot + Prometheus export."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, **kwargs)
            self._metrics[name] = m
            return m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  max_samples: int = 4096) -> Histogram:
        return self._get(name, Histogram, help=help, buckets=buckets,
                         max_samples=max_samples)

    def get(self, name: str) -> Optional[Any]:
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view: counters/gauges → float, histograms →
        ``{count, sum, mean, p50, p99}`` — the driver-transportable form
        (everything is host scalars)."""
        out: Dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                doc = {"count": m.count, "sum": m.sum, "mean": m.mean}
                if m.count:
                    doc["p50"] = m.quantile(0.5)
                    doc["p99"] = m.quantile(0.99)
                out[name] = doc
            else:
                out[name] = m.value
        return out

    def prometheus_text(self) -> str:
        """``text/plain; version=0.0.4`` exposition. Metric names are
        sanitized (dots → underscores); histogram buckets are cumulative
        with the standard ``le`` label and ``+Inf`` terminal."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for le, c in zip(m.buckets, m.counts):
                    cum += c
                    lines.append(
                        f'{pname}_bucket{{le="{_fmt(le)}"}} {cum}')
                cum += m.counts[-1]
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{pname}_sum {_fmt(m.sum)}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _fmt(v: float) -> str:
    return repr(round(v, 9)) if v != int(v) else str(int(v))
