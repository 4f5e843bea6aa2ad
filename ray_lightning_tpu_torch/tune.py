"""Ray Tune integration (counterpart of ``ray_lightning_tpu/tune.py``).

The reference's ``ray_lightning/tune.py:13-241`` on the port's launchers:

- :func:`get_tune_resources` builds a trial's ``PlacementGroupFactory``:
  one ``{"CPU": 1}`` bundle for the trial's driver and one bundle per
  worker (its CPUs, and one GPU for a card worker), ``PACK``ed, with
  ``resources_per_worker`` overriding as in the strategies
  (``strategies/base.py``).
- :class:`TuneReportCallback` reports trainer metrics to Tune, and
  :class:`TuneReportCheckpointCallback` a full trainer checkpoint with
  them. ``tune.report`` must run in the trial's process while the
  metrics come from the workers, so rank 0 puts the report into the
  session queue (``session.py``) and the driver runs it while it waits on
  the workers (``util.process_results``; in one process, the local
  launcher drains it between batches).

What a worker puts is data and a module-level function of this module
(``functools.partial(_deliver_report, ...)``): it pickles without
cloudpickle and needs no Tune in the worker. The function runs in the
driver and looks Tune up there, at that moment (this module's ``tune``
attribute, which a test may replace with a fake), and it is the driver
that chooses between the legacy API (``tune.checkpoint_dir`` and
``tune.report(**metrics)``, two calls) and Ray 2.x's (one
``report(metrics, checkpoint=)``). The JAX package's callbacks put
lambdas over its ``tune`` module and look Tune up in the worker
(``ray_lightning_tpu/tune.py:286-287``), which works in one process only
(``ROADMAP.md`` C).

A checkpoint is dumped on every rank, because under ZeRO and FSDP2 the
dump is a collective; only rank 0 serializes it and puts it. The
backend's queue carries the bytes (a temporary file under
``ProcessRay``, the object store under Ray); the driver writes them into
the trial's checkpoint directory and then reports, checkpoint first, so
Tune registers the checkpoint with the report. A worker whose session
has no queue (no Tune session on the driver) reports nothing.

Importing this module always succeeds; ``TUNE_INSTALLED`` says whether
Ray Tune is there, and what needs it raises when it runs.
"""
from __future__ import annotations

import functools
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Union

from ray_lightning_tpu_torch import session
from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.strategies.base import worker_resources
from ray_lightning_tpu_torch.util import to_state_stream

try:
    from ray import tune
    TUNE_INSTALLED = True
except ImportError:
    tune = None
    TUNE_INSTALLED = False

#: one record per item the driver delivered to Tune, in order:
#: ``kind`` ("report" or "checkpoint"), ``global_step``, the worker's
#: ``hooked_at`` and ``put_at`` and the driver's ``delivered_at``
#: (``time.time()``), and for a checkpoint its ``bytes``, the worker's
#: ``serialize_s`` and the driver's ``write_s``. The caller may clear it.
DELIVERIES: List[Dict[str, Any]] = []


def _require_tune():
    """The Tune module (this module's attribute, so a test can fake it)."""
    if tune is None:
        raise RuntimeError(
            "`ray.tune` is required for this functionality but is not "
            "installed. Install ray[tune], or remove the Tune callbacks / "
            "placement factory from your setup.")
    return tune


def _is_legacy_tune(tune_mod) -> bool:
    """Ray 1.x has ``tune.is_session_enabled``; Ray 2.x removed it along
    with ``tune.report(**kw)`` and ``tune.checkpoint_dir``."""
    return hasattr(tune_mod, "is_session_enabled")


def is_session_enabled() -> bool:
    """True in a Tune trial's process (either Ray generation)."""
    if tune is None:
        return False
    from ray_lightning_tpu_torch.reliability import log_suppressed
    if _is_legacy_tune(tune):
        try:
            return bool(tune.is_session_enabled())
        except Exception as exc:
            log_suppressed("tune.session_probe", exc,
                           "legacy is_session_enabled failed")
            return False
    try:
        ctx = tune.get_context()
        if ctx is not None and ctx.get_trial_id() is not None:
            return True
    except Exception as exc:
        log_suppressed("tune.session_probe", exc,
                       "get_context raised outside a session")
    try:
        from ray.train._internal.session import _get_session
        return _get_session() is not None
    except Exception as exc:
        log_suppressed("tune.session_probe", exc,
                       "private _get_session fallback failed")
        return False


def _report(tune_mod, metrics: Dict[str, Any],
            checkpoint_dir: Optional[str] = None) -> None:
    """One report through the API ``tune_mod`` has: legacy keywords, or
    Ray 2.x's metrics dict with an optional checkpoint directory."""
    if _is_legacy_tune(tune_mod):
        tune_mod.report(**metrics)
        return
    train_mod = None
    try:
        from ray import train as _train
        if hasattr(_train, "report"):
            train_mod = _train
    except ImportError:
        pass
    checkpoint = None
    if checkpoint_dir is not None:
        ckpt_cls = getattr(train_mod, "Checkpoint", None) or \
            getattr(tune_mod, "Checkpoint", None)
        if ckpt_cls is None:
            raise RuntimeError(
                "Cannot register the trial checkpoint: the installed ray "
                "exposes neither ray.train.Checkpoint nor "
                "ray.tune.Checkpoint. Upgrade ray[tune] or drop the "
                "checkpoint callback.")
        checkpoint = ckpt_cls.from_directory(checkpoint_dir)
    if train_mod is not None:
        train_mod.report(metrics, checkpoint=checkpoint)
    elif hasattr(tune_mod, "report"):
        tune_mod.report(metrics, checkpoint=checkpoint)
    else:
        raise RuntimeError(
            "No compatible Tune report API found: the installed ray has "
            "neither the legacy `tune.report(**kw)` nor `ray.train.report` "
            "/ `ray.tune.report(metrics, checkpoint=...)`.")


# ---------------------------------------------------------------- the driver
def _deliver_report(report: Dict[str, Any], global_step: int,
                    hooked_at: float, put_at: float) -> None:
    """Runs in the driver: one report."""
    _report(_require_tune(), report)
    DELIVERIES.append(dict(kind="report", global_step=global_step,
                           hooked_at=hooked_at, put_at=put_at,
                           delivered_at=time.time()))


def _deliver_checkpoint(stream: bytes, global_step: int, filename: str,
                        report: Optional[Dict[str, Any]], hooked_at: float,
                        put_at: float, serialize_s: float) -> None:
    """Runs in the driver: the checkpoint's bytes written into the
    trial's checkpoint directory, then ``report`` (legacy API: two calls,
    no report when there is none); under Ray 2.x one report carries both
    (``{"checkpoint_step": ...}`` when there is no report)."""
    tune_mod = _require_tune()
    t0 = time.perf_counter()
    if _is_legacy_tune(tune_mod):
        with tune_mod.checkpoint_dir(step=global_step) as checkpoint_dir:
            with open(os.path.join(checkpoint_dir, filename), "wb") as f:
                f.write(stream)
        write_s = time.perf_counter() - t0
        if report:
            _report(tune_mod, report)
    else:
        with tempfile.TemporaryDirectory() as tmpdir:
            with open(os.path.join(tmpdir, filename), "wb") as f:
                f.write(stream)
            write_s = time.perf_counter() - t0
            _report(tune_mod,
                    report if report is not None
                    else {"checkpoint_step": global_step},
                    checkpoint_dir=tmpdir)
    DELIVERIES.append(dict(kind="checkpoint", global_step=global_step,
                           bytes=len(stream), hooked_at=hooked_at,
                           put_at=put_at, serialize_s=serialize_s,
                           write_s=write_s, delivered_at=time.time()))


# ---------------------------------------------------------------- resources
def _trial_bundles(num_workers: int,
                   num_cpus_per_worker: int,
                   use_gpu: bool,
                   use_tpu: Optional[bool],
                   resources_per_worker: Optional[Dict],
                   device=None) -> List[Dict[str, Any]]:
    """The bundle math of :func:`get_tune_resources`: the head bundle,
    then one per worker with the strategies' resource rules
    (``strategies.base.worker_resources``)."""
    num_cpus, use_gpu, extra, _spec = worker_resources(
        num_cpus_per_worker, use_gpu, use_tpu, resources_per_worker, device)
    bundle: Dict[str, Any] = {"CPU": num_cpus}
    if use_gpu:
        bundle["GPU"] = 1
    bundle.update(extra)
    return [{"CPU": 1}] + [bundle] * num_workers


def get_tune_resources(num_workers: int = 1,
                       num_cpus_per_worker: int = 1,
                       use_gpu: bool = False,
                       use_tpu: Optional[bool] = None,
                       resources_per_worker: Optional[Dict] = None,
                       device=None):
    """Resources per Tune trial (the reference's ``tune.py:32-56``): a
    ``{"CPU": 1}`` bundle for the trial's driver, which launches the
    workers, and one per worker, ``PACK``ed so a trial's workers are
    scheduled together. The arguments mean what they mean to a strategy:
    ``device=None`` is a card per worker, ``device="cpu"`` CPU
    workers."""
    _require_tune()
    from ray.tune import PlacementGroupFactory
    bundles = _trial_bundles(num_workers, num_cpus_per_worker, use_gpu,
                             use_tpu, resources_per_worker, device)
    return PlacementGroupFactory(bundles, strategy="PACK")


def resume_ckpt_path(checkpoint_dir: Optional[str] = None,
                     filename: str = "checkpoint") -> Optional[str]:
    """The trial's restore point for ``Trainer.fit(ckpt_path=...)``, or
    None when Tune scheduled a fresh start (a PBT exploit or a failed
    trial's restore). Legacy Ray: pass the trainable's
    ``checkpoint_dir``; Ray 2.x: the checkpoint comes from
    ``tune.get_checkpoint()`` (or ``train.get_checkpoint()``).
    ``filename`` is the checkpoint callback's."""
    if checkpoint_dir is not None:
        path = os.path.join(checkpoint_dir, filename)
        return path if os.path.exists(path) else None
    tune_mod = _require_tune()
    get_ckpt = getattr(tune_mod, "get_checkpoint", None)
    if get_ckpt is None:
        try:
            from ray import train as _train
            get_ckpt = getattr(_train, "get_checkpoint", None)
        except ImportError:
            get_ckpt = None
    if get_ckpt is None:
        return None
    ckpt = get_ckpt()
    if ckpt is None:
        return None
    path = os.path.join(ckpt.to_directory(), filename)
    return path if os.path.exists(path) else None


# ---------------------------------------------------------------- callbacks
_HOOKS = ["fit_start", "train_start", "train_epoch_end", "validation_end",
          "validation_epoch_end", "test_epoch_end", "train_end"]


def _hooks(on: Union[str, List[str]]) -> List[str]:
    on = [on] if isinstance(on, str) else list(on)
    bad = [h for h in on if h not in _HOOKS]
    if bad:
        raise ValueError(f"Invalid hook(s) {bad}; choose from {_HOOKS}")
    return on


class _OnHooks(Callback):
    """Calls ``self._fire(trainer, module)`` at each hook in ``self._on``
    (``fit_start``, ..., ``train_end``)."""

    _on: List[str] = []

    def _fire(self, trainer, pl_module) -> None:
        raise NotImplementedError

    def on_fit_start(self, trainer, pl_module):
        if "fit_start" in self._on:
            self._fire(trainer, pl_module)

    def on_train_start(self, trainer, pl_module):
        if "train_start" in self._on:
            self._fire(trainer, pl_module)

    def on_train_epoch_end(self, trainer, pl_module):
        if "train_epoch_end" in self._on:
            self._fire(trainer, pl_module)

    def on_validation_end(self, trainer, pl_module):
        if "validation_end" in self._on:
            self._fire(trainer, pl_module)

    def on_validation_epoch_end(self, trainer, pl_module):
        if "validation_epoch_end" in self._on:
            self._fire(trainer, pl_module)

    def on_test_epoch_end(self, trainer, pl_module):
        if "test_epoch_end" in self._on:
            self._fire(trainer, pl_module)

    def on_train_end(self, trainer, pl_module):
        if "train_end" in self._on:
            self._fire(trainer, pl_module)


class TuneReportCallback(_OnHooks):
    """Report trainer metrics to Tune at the chosen hooks (the
    reference's ``tune.py:59-134``). ``metrics`` maps the name reported
    to Tune to the ``trainer.callback_metrics`` key (a str or a list:
    the same names; None: every metric). Rank 0 reports, never while the
    sanity check runs."""

    def __init__(self,
                 metrics: Union[None, str, List[str], Dict[str, str]] = None,
                 on: Union[str, List[str]] = "validation_end"):
        if isinstance(metrics, str):
            metrics = [metrics]
        self._metrics = metrics
        self._on = _hooks(on)

    def _get_report_dict(self, trainer, pl_module) -> Optional[Dict]:
        if trainer.sanity_checking:
            return None
        metrics = self._metrics
        if not metrics:
            metrics = {k: k for k in trainer.callback_metrics}
        if isinstance(metrics, list):
            metrics = {k: k for k in metrics}
        report = {}
        for tune_key, metric_key in metrics.items():
            if metric_key in trainer.callback_metrics:
                v = trainer.callback_metrics[metric_key]
                report[tune_key] = float(v) if hasattr(v, "__float__") else v
        return report or None

    def _fire(self, trainer, pl_module) -> None:
        if trainer.global_rank != 0 or not session.queue_enabled():
            return
        hooked_at = time.time()
        report = self._get_report_dict(trainer, pl_module)
        if report is None:
            return
        session.put_queue(functools.partial(
            _deliver_report, report, trainer.global_step, hooked_at,
            time.time()))


class _TuneCheckpointCallback(_OnHooks):
    """A full trainer checkpoint, dumped in the workers and written into
    the trial's checkpoint directory by the driver (the reference's
    ``tune.py:136-178``): bytes cross, no shared file system assumed."""

    def __init__(self, filename: str = "checkpoint",
                 on: Union[str, List[str]] = "validation_end"):
        self._filename = filename
        self._on = _hooks(on)

    def _checkpoint(self, trainer,
                    report: Optional[Dict[str, Any]] = None) -> None:
        """Every rank dumps (a collective under ZeRO and FSDP2); rank 0
        serializes and puts."""
        if trainer.sanity_checking or not session.queue_enabled():
            return
        hooked_at = time.time()
        ckpt = trainer.dump_checkpoint()
        if trainer.global_rank != 0:
            return
        t0 = time.perf_counter()
        stream = to_state_stream(ckpt)
        serialize_s = time.perf_counter() - t0
        del ckpt
        session.put_queue(functools.partial(
            _deliver_checkpoint, stream, trainer.global_step,
            self._filename, report, hooked_at, time.time(), serialize_s))

    def _fire(self, trainer, pl_module) -> None:
        self._checkpoint(trainer)


class TuneReportCheckpointCallback(_OnHooks):
    """A checkpoint and the metrics at each hook, as one item: the
    driver writes the checkpoint, then reports (the reference's
    ``tune.py:181-236``, checkpoint first so Tune registers it with the
    report)."""

    def __init__(self,
                 metrics: Union[None, str, List[str], Dict[str, str]] = None,
                 filename: str = "checkpoint",
                 on: Union[str, List[str]] = "validation_end"):
        self._checkpoint_cb = _TuneCheckpointCallback(filename, on)
        self._report_cb = TuneReportCallback(metrics, on)
        self._on = self._checkpoint_cb._on

    def _fire(self, trainer, pl_module) -> None:
        report = self._report_cb._get_report_dict(trainer, pl_module)
        self._checkpoint_cb._checkpoint(trainer, report=report or {})
