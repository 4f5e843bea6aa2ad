"""Per-worker session: the worker<->driver side-channel (copied from
``ray_lightning_tpu/session.py``, plus :func:`queue_enabled`).

A per-worker global singleton holding ``(rank, queue)``. Worker code
(e.g. report callbacks) pushes ``(rank, item)`` tuples; the launcher
drains the queue between batches and runs callables on the driver side.
"""
from __future__ import annotations

from typing import Any, Optional


class TpuLightningSession:
    """Holds this worker's rank and the driver-bound queue."""

    def __init__(self, rank: int, queue: Optional[Any]):
        self._rank = rank
        self._queue = queue

    def get_actor_rank(self) -> int:
        return self._rank

    def set_queue(self, queue: Any) -> None:
        self._queue = queue

    def put_queue(self, item: Any) -> None:
        if self._queue is None:
            raise ValueError(
                "Trying to put something into the session queue, but the "
                "queue was not initialized. This usually means the trainer "
                "was not launched through a strategy launcher.")
        self._queue.put((self._rank, item))


_session: Optional[TpuLightningSession] = None


def init_session(rank: int, queue: Optional[Any] = None) -> None:
    """Install the worker-global session (double-init guarded)."""
    global _session
    if _session is not None:
        raise ValueError(
            "A session is already initialized for this worker process. "
            "Call shutdown_session() first.")
    _session = TpuLightningSession(rank, queue)


def get_session() -> TpuLightningSession:
    if _session is None:
        raise ValueError(
            "No session initialized. `init_session` must be called by the "
            "launcher before worker code uses the session.")
    return _session


def shutdown_session() -> None:
    global _session
    _session = None


def queue_enabled() -> bool:
    """True when this worker's session has a queue to the driver (a Tune
    trial's launch made one)."""
    return _session is not None and _session._queue is not None


def get_actor_rank() -> int:
    """Rank of this worker."""
    return get_session().get_actor_rank()


def put_queue(item: Any) -> None:
    """Push ``(rank, item)`` onto the driver queue."""
    get_session().put_queue(item)
