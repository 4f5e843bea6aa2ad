"""Trainer callbacks (counterpart of ``ray_lightning_tpu/core/callbacks.py``).

The hook base and the two callbacks the GPT example uses:
:class:`LambdaCallback` (the tests' probe) and :class:`EpochStatsCallback`
(epoch wall time and the card's peak memory). ``ModelCheckpoint``,
``EarlyStopping``, ``EMAWeightAveraging`` and ``LearningRateMonitor`` are
not ported yet (``ROADMAP.md`` T1 and T5).
"""
from __future__ import annotations

import time
from typing import Any, Dict

import torch


class Callback:
    def setup(self, trainer, pl_module, stage: str) -> None: ...
    def teardown(self, trainer, pl_module, stage: str) -> None: ...
    def on_fit_start(self, trainer, pl_module) -> None: ...
    def on_fit_end(self, trainer, pl_module) -> None: ...
    def on_sanity_check_start(self, trainer, pl_module) -> None: ...
    def on_sanity_check_end(self, trainer, pl_module) -> None: ...
    def on_train_start(self, trainer, pl_module) -> None: ...
    def on_train_end(self, trainer, pl_module) -> None: ...
    def on_train_epoch_start(self, trainer, pl_module) -> None: ...
    def on_train_epoch_end(self, trainer, pl_module) -> None: ...
    def on_train_batch_start(self, trainer, pl_module, batch,
                             batch_idx: int) -> None: ...
    def on_train_batch_end(self, trainer, pl_module, outputs, batch,
                           batch_idx: int) -> None: ...
    def on_validation_start(self, trainer, pl_module) -> None: ...
    def on_validation_end(self, trainer, pl_module) -> None: ...
    def on_validation_epoch_start(self, trainer, pl_module) -> None: ...
    def on_validation_epoch_end(self, trainer, pl_module) -> None: ...
    def on_validation_batch_start(self, trainer, pl_module, batch,
                                  batch_idx: int,
                                  dataloader_idx: int = 0) -> None: ...
    def on_validation_batch_end(self, trainer, pl_module, outputs, batch,
                                batch_idx: int,
                                dataloader_idx: int = 0) -> None: ...
    def on_test_start(self, trainer, pl_module) -> None: ...
    def on_test_end(self, trainer, pl_module) -> None: ...
    def on_test_epoch_start(self, trainer, pl_module) -> None: ...
    def on_test_epoch_end(self, trainer, pl_module) -> None: ...
    def on_test_batch_start(self, trainer, pl_module, batch,
                            batch_idx: int,
                            dataloader_idx: int = 0) -> None: ...
    def on_test_batch_end(self, trainer, pl_module, outputs, batch,
                          batch_idx: int,
                          dataloader_idx: int = 0) -> None: ...
    def on_before_optimizer_step(self, trainer, pl_module,
                                 optimizer) -> None:
        """Fired once per training batch, before its step."""
        ...
    def state_dict(self) -> Dict[str, Any]:
        return {}
    def load_state_dict(self, state: Dict[str, Any]) -> None: ...


class EpochStatsCallback(Callback):
    """Epoch wall time and peak device memory (the reference's
    ``CUDACallback``): the peak is ``torch.cuda.max_memory_allocated``
    over the epoch (stats reset at its start); 0 on the CPU, which keeps
    no such count."""

    def __init__(self, print_stats: bool = True):
        self.print_stats = print_stats
        self.epoch_times: list = []
        self.peak_memory_mib: list = []
        self._t0 = 0.0

    def _cuda(self, trainer):
        device = trainer.strategy.root_device
        return device if device.type == "cuda" else None

    def on_train_epoch_start(self, trainer, pl_module) -> None:
        device = self._cuda(trainer)
        if device is not None:
            torch.cuda.reset_peak_memory_stats(device)
        self._t0 = time.perf_counter()

    def on_train_epoch_end(self, trainer, pl_module) -> None:
        trainer.block_until_ready()
        dt = time.perf_counter() - self._t0
        self.epoch_times.append(dt)
        device = self._cuda(trainer)
        peak = (torch.cuda.max_memory_allocated(device) / 2**20
                if device is not None else 0.0)
        self.peak_memory_mib.append(peak)
        if self.print_stats and trainer.global_rank == 0:
            print(f"Epoch {trainer.current_epoch}: {dt:.2f}s, "
                  f"peak device memory {peak:.0f} MiB")


class LambdaCallback(Callback):
    """Attach ad-hoc hook functions -- the tests' callback-as-probe
    helper."""

    def __init__(self, **hooks):
        for name, fn in hooks.items():
            if not hasattr(Callback, name):
                raise ValueError(f"Unknown callback hook {name!r}")
            setattr(self, name, fn)
