"""The launcher result record (copied from ``ray_lightning_tpu/launchers/utils.py``).

Only :class:`WorkerOutput` is copied: the rendezvous helpers come with
the multi-process launchers (``ROADMAP.md`` T6).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional


class WorkerOutput(NamedTuple):
    """What rank 0 returns to the driver after a launched stage: best
    checkpoint path, the final state as a byte stream (None in-process),
    trainer progress counters, and metrics as plain Python numbers."""
    best_model_path: Optional[str]
    state_stream: Optional[bytes]
    trainer_state: Dict[str, Any]
    callback_metrics: Dict[str, Any]
    logged_metrics: Dict[str, Any]
    results: Any = None
    callback_states: Optional[Dict[str, Any]] = None
