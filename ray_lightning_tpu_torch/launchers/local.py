"""In-process launcher (counterpart of ``ray_lightning_tpu/launchers/local.py``).

One process on one device: ``launch`` re-applies the seed, opens the
session, runs the launched function in-process, drains the session queue
and tears down -- the launcher contract the multi-process launchers keep.
"""
from __future__ import annotations

import queue as _queue
from typing import Any, Callable

from ray_lightning_tpu_torch import session as _session
from ray_lightning_tpu_torch.core.seed import reset_seed


class LocalLauncher:
    """Runs the launched function in this process."""

    def __init__(self, strategy):
        self._strategy = strategy
        self.queue: Any = None

    def launch(self, function: Callable, *args, trainer=None, **kwargs) -> Any:
        """setup session -> run -> drain queue -> teardown; returns the
        function's ``WorkerOutput``."""
        del trainer
        reset_seed()
        self.queue = _queue.Queue()
        if self._strategy.init_hook is not None:
            self._strategy.init_hook()
        _session.shutdown_session()
        _session.init_session(rank=0, queue=self.queue)
        try:
            return function(*args, **kwargs)
        finally:
            self.drain_queue()
            _session.shutdown_session()
            self._strategy.teardown()

    def drain_queue(self) -> None:
        """Run queued driver-side callables: with no process boundary the
        driver is the worker, so they run when the trainer drains between
        batches."""
        if self.queue is None:
            return
        while True:
            try:
                (_rank, item) = self.queue.get_nowait()
            except _queue.Empty:
                return
            if callable(item):
                item()
