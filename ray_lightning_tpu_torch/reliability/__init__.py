"""Fault tolerance for the one-process trainer (counterpart of ``ray_lightning_tpu/reliability/``).

- :mod:`.faults` -- the seedable :class:`FaultPlan` that injects failures
  (raise / NaN-poison / stall) at named sites by tick, copied from the
  JAX package: the trainer fires ``train.step``, ``loader.next`` and
  ``ckpt.save`` where the JAX trainer does.
- :mod:`.guard` -- the non-finite loss/gradient guard's helpers.

Retry, the supervisors, gang supervision and the warm recovery tiers
come with ``ROADMAP.md`` T6/T7.
"""
from __future__ import annotations

import logging

logger = logging.getLogger("ray_lightning_tpu_torch.reliability")


def log_suppressed(site: str, exc: BaseException, detail: str = "") -> None:
    """Record a swallowed exception instead of silently dropping it."""
    logger.warning("suppressed at %s: %s: %s%s", site,
                   type(exc).__name__, exc,
                   f" ({detail})" if detail else "")


from ray_lightning_tpu_torch.reliability.faults import (  # noqa: E402
    FaultPlan, FaultSpec, InjectedFault, MODE_EXIT, MODE_NAN, MODE_RAISE,
    MODE_STALL, SITE_CKPT_SAVE, SITE_LOADER_NEXT, SITE_TRAIN_STEP, arm,
    disarm, ensure_armed, fire, get_armed)
from ray_lightning_tpu_torch.reliability.guard import (  # noqa: E402
    NonFiniteError)

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault", "MODE_EXIT", "MODE_NAN",
    "MODE_RAISE", "MODE_STALL", "SITE_CKPT_SAVE", "SITE_LOADER_NEXT",
    "SITE_TRAIN_STEP", "arm", "disarm", "ensure_armed", "fire",
    "get_armed", "NonFiniteError", "logger", "log_suppressed",
]
