"""Trainer profilers (copied from ``ray_lightning_tpu/core/profiler.py``).

The standard library only. :class:`SimpleProfiler` (``profiler="simple"``)
times the trainer's sections by the JAX package's names (``train_step``,
``get_train_batch``, ``validation``, ``epoch_end_callbacks``) and prints a
table at fit end. CUDA launches are asynchronous, as XLA's dispatch is:
"train_step" measures host time, and the host only waits there when the
device queue is full, so a large "train_step" share means device bound
and a large "get_train_batch" share means input bound. For device
traces use :class:`ray_lightning_tpu_torch.core.loggers.TorchProfilerCallback`.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Tuple


class PassThroughProfiler:
    """No-op seat so the hot loop never branches on profiler presence."""

    @contextlib.contextmanager
    def profile(self, name: str):
        yield

    def profile_iterable(self, iterable, name: str):
        return iterable

    def summary(self) -> str:
        return ""

    def describe(self) -> None:
        pass

    def reset(self) -> None:
        pass

    def records(self) -> Dict[str, Tuple[int, float]]:
        """``{section: (calls, total_seconds)}``."""
        return {}


class SimpleProfiler(PassThroughProfiler):
    """Accumulate wall-clock per named section (scoped per fit: the
    trainer resets the records at fit start so a reused Trainer reports
    each run separately)."""

    def __init__(self):
        self._records: Dict[str, Tuple[int, float]] = {}

    def reset(self) -> None:
        self._records = {}

    @contextlib.contextmanager
    def profile(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            count, total = self._records.get(name, (0, 0.0))
            self._records[name] = (count + 1, total + dt)

    def records(self) -> Dict[str, Tuple[int, float]]:
        return dict(self._records)

    def profile_iterable(self, iterable, name: str):
        """Time each ``next()`` — the data-wait measurement."""
        it = iter(iterable)
        while True:
            with self.profile(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def summary(self) -> str:
        if not self._records:
            return ""
        total_all = sum(t for _, t in self._records.values())
        lines = [
            f"{'Action':<24}| {'Mean (s)':>10} | {'Calls':>7} | "
            f"{'Total (s)':>10} | {'%':>6}",
            "-" * 68,
        ]
        for name, (count, total) in sorted(self._records.items(),
                                           key=lambda kv: -kv[1][1]):
            pct = 100.0 * total / total_all if total_all else 0.0
            lines.append(f"{name:<24}| {total / count:>10.5f} | "
                         f"{count:>7} | {total:>10.3f} | {pct:>5.1f}%")
        return "\n".join(lines)

    def describe(self) -> None:
        s = self.summary()
        if s:
            print("SimpleProfiler report\n" + s)


def resolve_profiler(profiler) -> PassThroughProfiler:
    if profiler is None:
        return PassThroughProfiler()
    if isinstance(profiler, str):
        if profiler == "simple":
            return SimpleProfiler()
        raise ValueError(
            f"Unknown profiler {profiler!r}; use 'simple', None, or a "
            "profiler object with profile()/profile_iterable()/describe()")
    missing = [m for m in ("profile", "profile_iterable", "describe")
               if not callable(getattr(profiler, m, None))]
    if missing:
        raise ValueError(
            f"profiler object {profiler!r} lacks required method(s) "
            f"{missing}; pass 'simple', None, or implement the "
            "profile()/profile_iterable()/describe() contract")
    return profiler
