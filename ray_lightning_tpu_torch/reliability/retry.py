"""Bounded retry with exponential backoff and deterministic jitter (copied from ``ray_lightning_tpu/reliability/retry.py``).

The port's own copy, unchanged but for this paragraph, the module paths
and the log line, which takes the failed attempt's message instead of the
exception (a log handler that keeps records must not pin a crashed
engine through the traceback): the same delays for the same policy, the
same ``retry.*`` events.

The jitter is a pure function of ``(policy.seed, attempt)`` — a
splitmix64 hash, not a global RNG — so a retry schedule is replayable
byte-for-byte: tests assert exact backoff sequences and two supervisors
with the same policy never need a shared random state. (Classic
decorrelated jitter exists to de-synchronize *fleets*; per-supervisor
seeds give the same de-synchronization without giving up replayability.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, TypeVar

from ray_lightning_tpu_torch.reliability import logger

T = TypeVar("T")

_M64 = (1 << 64) - 1


def _unit(seed: int, attempt: int) -> float:
    """splitmix64((seed, attempt)) → uniform float in [0, 1)."""
    x = (seed * 0x9E3779B97F4A7C15 + attempt * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return x / 2.0 ** 64


class RetriesExhausted(RuntimeError):
    """Every attempt the policy allowed has failed."""

    def __init__(self, attempts: int, last_error: BaseException):
        super().__init__(
            f"exhausted {attempts} attempt(s); last error: "
            f"{type(last_error).__name__}: {last_error}")
        self.attempts = attempts
        self.last_error = last_error


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How hard to try: attempts, backoff shape, and an overall deadline.

    ``max_attempts`` counts total tries (1 = no retry). The delay before
    retry ``attempt`` (1-based, after the ``attempt``-th failure) is
    ``base_delay * multiplier**(attempt-1)`` capped at ``max_delay``,
    scaled by a deterministic jitter in ``[1-jitter, 1+jitter]``.
    ``deadline`` bounds the *total* elapsed seconds across attempts —
    once exceeded, no further retry is attempted even if attempts
    remain.
    """
    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError(
                f"multiplier must be >= 1, got {self.multiplier}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(
                f"jitter must be in [0, 1), got {self.jitter}")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(
                f"deadline must be > 0, got {self.deadline}")

    def delay(self, attempt: int, salt: int = 0) -> float:
        """Backoff (seconds) before retry ``attempt`` (1-based).

        ``salt`` folds an extra coordinate into the jitter hash — e.g. a
        replica seat id, so every quarantined seat sharing one fleet
        policy backs off on its own de-correlated schedule. The result
        stays a pure function of ``(seed, salt, attempt)``: replayable,
        and tests still assert exact schedules per salt.
        """
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter:
            seed = ((self.seed + salt * 0xD1B54A32D192ED03) & _M64
                    if salt else self.seed)
            d *= 1.0 + self.jitter * (2.0 * _unit(seed, attempt) - 1.0)
        return d


def call_with_retry(fn: Callable[[int], T], policy: RetryPolicy, *,
                    site: str = "retry",
                    sleep: Callable[[float], None] = time.sleep,
                    clock: Callable[[], float] = time.monotonic) -> T:
    """Run ``fn(attempt)`` under ``policy``; raise :class:`RetriesExhausted`
    (chaining the last error) once attempts or the deadline run out.

    ``sleep``/``clock`` are injectable so tests retry instantly and
    assert the exact backoff schedule.
    """
    from ray_lightning_tpu_torch import obs
    t0 = clock()
    for attempt in range(1, policy.max_attempts + 1):
        # every attempt (including the first) is an event: a chaos run's
        # log shows the full retry ladder, not just the failures. The
        # None check comes BEFORE any kwargs build — the disarmed path
        # stays allocation-free (the FaultPlan contract).
        tel = obs.get_global()
        if tel is not None:
            tel.bus.emit("retry.attempt", site=site, attempt=attempt,
                         max_attempts=policy.max_attempts)
        try:
            return fn(attempt)
        except Exception as exc:  # noqa: BLE001 — re-raised on exhaustion
            out_of_time = (policy.deadline is not None
                           and clock() - t0 >= policy.deadline)
            if attempt >= policy.max_attempts or out_of_time:
                if tel is not None:
                    tel.bus.emit("retry.exhausted", site=site,
                                 attempts=attempt,
                                 exc=type(exc).__name__)
                raise RetriesExhausted(attempt, exc) from exc
            if tel is not None:
                tel.metrics.counter(
                    "reliability_retries_total",
                    help="failed attempts that scheduled a retry").inc()
            logger.warning(
                "%s: attempt %d/%d failed (%s: %s); retrying in %.3fs",
                site, attempt, policy.max_attempts, type(exc).__name__,
                str(exc), policy.delay(attempt))
            sleep(policy.delay(attempt))
    raise AssertionError("unreachable: the loop returns or raises")
