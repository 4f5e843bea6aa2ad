"""Fault tolerance (counterpart of ``ray_lightning_tpu/reliability/``).

- :mod:`.faults` -- the seedable :class:`FaultPlan` that injects failures
  (raise / NaN-poison / stall) at named sites by tick, copied from the
  JAX package: the trainer fires ``train.step``, ``loader.next`` and
  ``ckpt.save``, the serving engine ``serve.dispatch``, ``serve.verify``
  and ``serve.poison``, the client ``serve.driver``, where the JAX
  package fires them.
- :mod:`.retry` -- :class:`RetryPolicy` (bounded attempts, exponential
  backoff, deterministic jitter, optional deadline) and
  :func:`call_with_retry`, copied.
- :mod:`.supervisor` -- :class:`ServeSupervisor`: rebuilds a crashed
  :class:`~ray_lightning_tpu_torch.serve.engine.ServeEngine` and
  re-admits every in-flight request by replaying its prompt + emitted
  tokens; :class:`FitSupervisor`: a fit retried to completion, each
  attempt resuming from the newest checkpoint.
- :mod:`.gang` -- gang supervision of a multi-process fit: worker
  heartbeats, the driver's watchdog, :class:`GangFailure` postmortems
  and :class:`GangSupervisor`'s coordinated (optionally elastic)
  restart, copied.
- :mod:`.elastic` -- the warm recovery tiers: :class:`StandbyPool`
  (pre-spawned workers that have paid the CUDA context and the kernel
  loads) and :class:`MemoryCheckpointStore` (host-memory checkpoints
  replicated to a ring buddy, ahead of disk on ``resume="auto"``).
- :mod:`.guard` -- the non-finite loss/gradient guard's helpers.
"""
from __future__ import annotations

import logging

logger = logging.getLogger("ray_lightning_tpu_torch.reliability")


def log_suppressed(site: str, exc: BaseException, detail: str = "") -> None:
    """Record a swallowed exception instead of silently dropping it.

    With a :class:`~ray_lightning_tpu_torch.obs.Telemetry` handle
    activated, every suppression also lands on its event bus (site
    ``log.suppressed``) and in ``reliability_suppressed_total``."""
    # the message, not the exception, goes to the log: a handler that
    # keeps records (a test's capture) must not pin the traceback's
    # frames -- a crashed engine among them
    logger.warning("suppressed at %s: %s: %s%s", site,
                   type(exc).__name__, str(exc),
                   f" ({detail})" if detail else "")
    from ray_lightning_tpu_torch.obs import emit_global, get_global
    emit_global("log.suppressed", site=site, exc=type(exc).__name__,
                detail=detail)
    tel = get_global()
    if tel is not None:
        tel.metrics.counter(
            "reliability_suppressed_total",
            help="exceptions swallowed via log_suppressed").inc()


from ray_lightning_tpu_torch.reliability.faults import (  # noqa: E402
    FaultPlan, FaultSpec, InjectedFault, MODE_EXIT, MODE_NAN, MODE_RAISE,
    MODE_STALL, SITE_CKPT_SAVE, SITE_LOADER_NEXT, SITE_RENDEZVOUS_INIT,
    SITE_SERVE_DISPATCH, SITE_TRAIN_STEP, SITE_WORKER_EXIT,
    SITE_WORKER_STALL, arm, disarm, ensure_armed, fire, get_armed)
from ray_lightning_tpu_torch.reliability.guard import (  # noqa: E402
    NonFiniteError)
from ray_lightning_tpu_torch.reliability.retry import (  # noqa: E402
    RetriesExhausted, RetryPolicy, call_with_retry)
from ray_lightning_tpu_torch.reliability.supervisor import (  # noqa: E402
    FitSupervisor, ServeSupervisor, failed_completion)
from ray_lightning_tpu_torch.reliability.gang import (  # noqa: E402
    GangConfig, GangFailure, GangMonitor, GangSupervisor, HeartbeatEmitter,
    RankPostmortem)
from ray_lightning_tpu_torch.reliability.elastic import (  # noqa: E402
    MemoryCheckpointClient, MemoryCheckpointStore, StandbyPool,
    get_memory_store, install_memory_store, ring_buddy, standby_warmup)

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault", "MODE_EXIT", "MODE_NAN",
    "MODE_RAISE", "MODE_STALL", "SITE_CKPT_SAVE", "SITE_LOADER_NEXT",
    "SITE_RENDEZVOUS_INIT", "SITE_SERVE_DISPATCH", "SITE_TRAIN_STEP",
    "SITE_WORKER_EXIT", "SITE_WORKER_STALL", "arm", "disarm",
    "ensure_armed", "fire", "get_armed", "NonFiniteError",
    "RetriesExhausted", "RetryPolicy", "call_with_retry",
    "FitSupervisor", "ServeSupervisor", "failed_completion",
    "GangConfig", "GangFailure", "GangMonitor", "GangSupervisor",
    "HeartbeatEmitter", "RankPostmortem",
    "MemoryCheckpointClient", "MemoryCheckpointStore", "StandbyPool",
    "get_memory_store", "install_memory_store", "ring_buddy",
    "standby_warmup",
    "logger", "log_suppressed",
]
