"""Metric logger and profiling callback (counterpart of ``ray_lightning_tpu/core/loggers.py``).

- :class:`CSVLogger`: one metrics row per train epoch on rank 0, in
  ``<save_dir or default_root_dir>/<name>/version_<k>/metrics.csv`` like
  PTL's ``CSVLogger``; the header grows when a metric first appears
  (e.g. the first validation), and non-numeric values are skipped.
- :class:`TorchProfilerCallback`: the counterpart of
  ``JaxProfilerCallback``: a ``torch.profiler`` window of ``num_steps``
  training steps from ``start_step`` (CPU and, on the card, CUDA
  activity), written as a Chrome/Perfetto trace.
"""
from __future__ import annotations

import csv
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.core.callbacks import Callback


class CSVLogger(Callback):
    """Append one metrics row per train epoch to ``metrics.csv``."""

    def __init__(self, save_dir: Optional[str] = None,
                 name: str = "tpu_logs", version: Optional[int] = None):
        self.save_dir = save_dir
        self.name = name
        self.version = version
        self._path: Optional[str] = None
        self._fieldnames: list = []

    @property
    def log_dir(self) -> Optional[str]:
        return os.path.dirname(self._path) if self._path else None

    def setup(self, trainer, pl_module, stage: str) -> None:
        if trainer.global_rank != 0 or self._path is not None:
            return
        root = self.save_dir or trainer.default_root_dir
        base = os.path.join(root, self.name)
        version = self.version
        if version is None:
            os.makedirs(base, exist_ok=True)
            existing = [
                int(d.split("_", 1)[1]) for d in os.listdir(base)
                if d.startswith("version_") and d.split("_", 1)[1].isdigit()
            ]
            version = max(existing) + 1 if existing else 0
        d = os.path.join(base, f"version_{version}")
        os.makedirs(d, exist_ok=True)
        self._path = os.path.join(d, "metrics.csv")

    def on_train_epoch_end(self, trainer, pl_module) -> None:
        if trainer.global_rank != 0 or self._path is None:
            return
        row: Dict[str, Any] = {
            "epoch": trainer.current_epoch,
            "step": trainer.global_step,
        }
        for k, v in trainer.callback_metrics.items():
            if hasattr(v, "__float__") or np.isscalar(v):
                # np.isscalar("abc") is True: a string metric is skipped
                try:
                    row[k] = float(v)
                except (TypeError, ValueError):
                    continue
        self._write(row)

    def _write(self, row: Dict[str, Any]) -> None:
        new_fields = [k for k in row if k not in self._fieldnames]
        if new_fields:
            self._fieldnames.extend(new_fields)
            # rewrite with the extended header (rows are few: epochs)
            rows = []
            if os.path.exists(self._path):
                with open(self._path) as f:
                    rows = list(csv.DictReader(f))
            with open(self._path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                w.writeheader()
                for r in rows:
                    w.writerow(r)
                w.writerow(row)
        else:
            with open(self._path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fieldnames).writerow(row)

    def state_dict(self) -> Dict[str, Any]:
        return {"path": self._path, "fieldnames": self._fieldnames}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._path = state.get("path")
        self._fieldnames = list(state.get("fieldnames", []))


class TorchProfilerCallback(Callback):
    """Profile a window of training steps with ``torch.profiler``.

    Starts at the first batch whose ``global_step >= start_step`` (so a
    run resumed past ``start_step`` still profiles, from where it
    started) and stops after ``num_steps`` steps, or at teardown when the
    run ends first; one window per instance. The trace goes to
    ``<log_dir or default_root_dir/profile>/trace-step<N>.json``
    (``trace_path``). Rank 0 only.
    """

    def __init__(self, start_step: int = 5, num_steps: int = 3,
                 log_dir: Optional[str] = None):
        self.start_step = start_step
        self.num_steps = num_steps
        self.log_dir = log_dir
        self._active = False
        self._done = False
        self._started_at: Optional[int] = None
        self._profiler = None
        self.trace_dir: Optional[str] = None
        self.trace_path: Optional[str] = None

    def on_train_batch_start(self, trainer, pl_module, batch,
                             batch_idx: int) -> None:
        if trainer.global_rank != 0 or self._active or self._done:
            return
        if trainer.global_step >= self.start_step:
            self.trace_dir = self.log_dir or os.path.join(
                trainer.default_root_dir, "profile")
            os.makedirs(self.trace_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._active = True
            self._started_at = trainer.global_step

    def on_train_batch_end(self, trainer, pl_module, outputs, batch,
                           batch_idx: int) -> None:
        if self._active and \
                trainer.global_step >= self._started_at + self.num_steps:
            trainer.block_until_ready()
            self._stop()

    def teardown(self, trainer, pl_module, stage: str) -> None:
        if self._active:  # window larger than the run: close cleanly
            self._stop()

    def _stop(self) -> None:
        self._profiler.stop()
        self.trace_path = os.path.join(
            self.trace_dir, f"trace-step{self._started_at}.json")
        self._profiler.export_chrome_trace(self.trace_path)
        self._active = False
        self._done = True
