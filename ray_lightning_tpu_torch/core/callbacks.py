"""Trainer callbacks (counterpart of ``ray_lightning_tpu/core/callbacks.py``).

The hook base -- with the checkpoint hooks (``on_save_checkpoint``,
``on_load_checkpoint``, ``state_dict``/``load_state_dict`` for host
values, ``sharded_state``/``load_sharded_state`` for tensors that ride
the checkpoint's ``callback_arrays``) -- and every callback of the JAX
package's module: :class:`ModelCheckpoint` (epoch-end saves with
best-model tracking and top-k, ``save_last``, both formats, ``async_save``
and the rolling periodic ``every_n_train_steps`` save with
``keep_last_n`` retention), :class:`EarlyStopping`,
:class:`EMAWeightAveraging`, :class:`LearningRateMonitor`,
:class:`EpochStatsCallback` (epoch wall time and the card's peak memory)
and :class:`LambdaCallback` (the tests' probe).
"""
from __future__ import annotations

import os
import shutil
import time
import warnings
from typing import Any, Dict, Optional

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
    def on_predict_start(self, trainer, pl_module) -> None: ...
    def on_predict_end(self, trainer, pl_module) -> None: ...
    def on_predict_epoch_start(self, trainer, pl_module) -> None: ...
    def on_predict_epoch_end(self, trainer, pl_module) -> None: ...
    def on_predict_batch_start(self, trainer, pl_module, batch,
                               batch_idx: int,
                               dataloader_idx: int = 0) -> None: ...
    def on_predict_batch_end(self, trainer, pl_module, outputs, batch,
                             batch_idx: int,
                             dataloader_idx: int = 0) -> None: ...
    def on_before_optimizer_step(self, trainer, pl_module,
                                 optimizer) -> None:
        """Fired once per training batch, before its step."""
        ...
    def on_save_checkpoint(self, trainer, pl_module,
                           checkpoint: Dict[str, Any]) -> None: ...
    def on_load_checkpoint(self, trainer, pl_module,
                           checkpoint: Dict[str, Any]) -> None: ...
    def state_dict(self) -> Dict[str, Any]:
        return {}
    def load_state_dict(self, state: Dict[str, Any]) -> None: ...
    def sharded_state(self) -> Optional[Any]:
        """Optional nest of tensors to persist with the checkpoint (its
        ``callback_arrays``): unlike ``state_dict`` (host values), it
        travels the train state's path -- inside the stream file, or as
        DCP tensors of a directory."""
        return None
    def load_sharded_state(self, tree: Any) -> None: ...


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


def _remove(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        os.remove(path)


class ModelCheckpoint(Callback):
    """Epoch-end checkpointing with best-model tracking (the JAX
    package's ``ModelCheckpoint``, one process: rank 0 saves).

    ``monitor`` names a ``callback_metrics`` key ranked by ``mode``
    (without one the newest save is the best); ``save_top_k`` keeps that
    many ranked saves (-1 all, 0 none); ``save_last`` also rewrites
    ``last.<suffix>`` at each epoch end. ``save_format`` is ``"stream"``
    (``.ckpt`` files) or ``"orbax"`` (``.orbax`` directories through
    DCP); ``async_save`` overlaps a directory's write with training.
    ``every_n_train_steps`` adds an unmonitored mid-epoch save for
    crash-safe resume: with a ``monitor`` it rolls (only the newest
    survives) and never enters best-model tracking or top-k.
    ``keep_last_n`` prunes committed checkpoints beyond the newest N
    after each save, never one the callback still tracks.
    """

    def __init__(self,
                 dirpath: Optional[str] = None,
                 filename: str = "epoch={epoch}-step={step}",
                 monitor: Optional[str] = None,
                 mode: str = "min",
                 save_top_k: int = 1,
                 save_last: bool = False,
                 save_format: str = "stream",
                 async_save: bool = False,
                 every_n_train_steps: int = 0,
                 keep_last_n: Optional[int] = None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        if save_format not in ("stream", "orbax"):
            raise ValueError(
                f"save_format must be 'stream' or 'orbax', got "
                f"{save_format!r}")
        if async_save and save_format != "orbax":
            raise ValueError("async_save requires save_format='orbax'")
        if every_n_train_steps < 0:
            raise ValueError(
                f"every_n_train_steps must be >= 0, got "
                f"{every_n_train_steps}")
        if keep_last_n is not None and keep_last_n < 1:
            raise ValueError(
                f"keep_last_n must be >= 1 (the newest committed "
                f"checkpoint is never pruned), got {keep_last_n}")
        self.dirpath = dirpath
        self.filename = filename
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.save_format = save_format
        self.async_save = async_save
        self.every_n_train_steps = every_n_train_steps
        self.keep_last_n = keep_last_n
        self.best_model_path: str = ""
        self.best_model_score: Optional[float] = None
        self.last_model_path: str = ""
        self._saved: list = []  # (score, path)
        self._last_saved_path: str = ""
        self._last_periodic_path: str = ""
        self._deletes = True   # this rank removes pruned files (rank 0)

    def setup(self, trainer, pl_module, stage: str) -> None:
        if self.dirpath is None:
            self.dirpath = os.path.join(trainer.default_root_dir,
                                        "checkpoints")

    def _is_better(self, score: float) -> bool:
        if self.best_model_score is None:
            return True
        return (score < self.best_model_score if self.mode == "min" else
                score > self.best_model_score)

    def on_train_batch_end(self, trainer, pl_module, outputs, batch,
                           batch_idx: int) -> None:
        if self.every_n_train_steps < 1 or \
                trainer.global_step % self.every_n_train_steps:
            return
        self._save(trainer, monitor_val=None, periodic=True)

    def on_train_epoch_end(self, trainer, pl_module) -> None:
        self._save(trainer, monitor_val=self._monitor_value(trainer))

    _SKIP = object()  # monitored metric absent: skip this save entirely

    def _monitor_value(self, trainer):
        if self.monitor is None:
            return None
        raw = trainer.callback_metrics.get(self.monitor)
        if raw is None:
            # PTL semantics: never rank an unscored checkpoint
            warnings.warn(
                f"ModelCheckpoint: monitored metric {self.monitor!r} not "
                "found in callback_metrics; skipping checkpoint this "
                "epoch.")
            return self._SKIP
        return float(raw)

    def _save(self, trainer, monitor_val, periodic: bool = False) -> None:
        if self.save_top_k == 0 or monitor_val is self._SKIP:
            return
        # every rank saves (a collective under a process group: the
        # trainer has rank 0 write the stream file, each rank its shards
        # of a directory) and keeps the same ledger; rank 0 deletes
        self._deletes = trainer.global_rank == 0
        name = self.filename.format(
            epoch=trainer.current_epoch, step=trainer.global_step)
        if monitor_val is not None:
            name = f"{name}-{self.monitor}={monitor_val:.4f}"
        os.makedirs(self.dirpath, exist_ok=True)
        suffix = ".ckpt" if self.save_format == "stream" else ".orbax"
        path = os.path.join(self.dirpath, name + suffix)
        trainer.save_checkpoint(path, save_format=self.save_format,
                                async_save=self.async_save)
        self._last_saved_path = path
        # 'last' tracks epoch-end saves only
        if self.save_last and not periodic:
            trainer.save_checkpoint(
                os.path.join(self.dirpath, "last" + suffix),
                save_format=self.save_format, async_save=self.async_save)
        if periodic and self.monitor is not None:
            # an unmonitored crash-safety save must not compete in the
            # metric ledger (-global_step would beat every mode='min'
            # score): it rolls, only the newest one kept
            prev = self._last_periodic_path
            if prev and prev != path and prev != self.best_model_path \
                    and all(prev != p for _s, p in self._saved):
                self._wait_if_pending(prev)
                if self._deletes and os.path.exists(prev):
                    _remove(prev)
            self._last_periodic_path = path
            self._retention_prune()
            return
        score = monitor_val if monitor_val is not None else \
            -float(trainer.global_step)  # no monitor: newest is best
        if self._is_better(score):
            self.best_model_score = score
            self.best_model_path = path
        # a periodic save and an epoch-end save can land on one path
        self._saved = [(s, p) for s, p in self._saved if p != path]
        self._saved.append((score, path))
        self._prune()
        if self.save_last:
            self.last_model_path = os.path.join(self.dirpath,
                                                "last" + suffix)
        self._retention_prune()

    def _wait_if_pending(self, path: str) -> None:
        """An async save commits by renaming its staging directory into
        place: a path not on disk yet may still be in flight."""
        if self.async_save and not os.path.exists(path):
            from ray_lightning_tpu_torch.core.checkpoint import \
                wait_for_async_saves
            wait_for_async_saves()

    def _retention_prune(self) -> None:
        """``keep_last_n`` retention; everything the callback still
        tracks (top-k ledger, best, last, the rolling periodic save, the
        save just issued) is protected."""
        if not self.keep_last_n or not self.dirpath or not self._deletes:
            return
        from ray_lightning_tpu_torch.core.checkpoint import prune_checkpoints
        protect = {p for _s, p in self._saved}
        protect.update({self.best_model_path, self.last_model_path,
                        self._last_periodic_path, self._last_saved_path})
        prune_checkpoints(self.dirpath, self.keep_last_n, protect=protect)

    def _prune(self) -> None:
        if self.save_top_k < 0:
            return
        self._saved.sort(key=lambda t: t[0], reverse=self.mode == "max")
        while len(self._saved) > self.save_top_k:
            _score, path = self._saved.pop()
            if path != self.best_model_path:
                self._wait_if_pending(path)
                if self._deletes and os.path.exists(path):
                    _remove(path)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "best_model_path": self.best_model_path,
            "best_model_score": self.best_model_score,
            "last_model_path": self.last_model_path,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.best_model_path = state.get("best_model_path", "")
        self.best_model_score = state.get("best_model_score")
        self.last_model_path = state.get("last_model_path", "")


class EarlyStopping(Callback):
    """Stop training when a monitored metric stops improving (PTL's
    ``EarlyStopping``): checked at each validation end (or each train
    epoch end with ``check_on_train_epoch_end``), it sets
    ``trainer.should_stop`` after ``patience`` checks without an
    improvement larger than ``min_delta``."""

    def __init__(self,
                 monitor: str = "val_loss",
                 min_delta: float = 0.0,
                 patience: int = 3,
                 mode: str = "min",
                 check_on_train_epoch_end: bool = False,
                 verbose: bool = False,
                 strict: bool = True):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.mode = mode
        self.check_on_train_epoch_end = check_on_train_epoch_end
        self.verbose = verbose
        self.strict = strict
        self.wait_count = 0
        self.stopped_epoch = 0
        self.best_score: Optional[float] = None

    def _improved(self, score: float) -> bool:
        if self.best_score is None:
            return True
        if self.mode == "min":
            return score < self.best_score - self.min_delta
        return score > self.best_score + self.min_delta

    def _run_check(self, trainer) -> None:
        if trainer.sanity_checking:
            return
        raw = trainer.callback_metrics.get(self.monitor)
        if raw is None:
            if self.strict:
                raise RuntimeError(
                    f"EarlyStopping: monitored metric {self.monitor!r} not "
                    f"found in callback_metrics "
                    f"({sorted(trainer.callback_metrics)}); pass strict="
                    "False to skip epochs where it is absent.")
            return
        score = float(raw)
        if self._improved(score):
            self.best_score = score
            self.wait_count = 0
            return
        self.wait_count += 1
        if self.wait_count >= self.patience:
            trainer.should_stop = True
            self.stopped_epoch = trainer.current_epoch
            if self.verbose and trainer.global_rank == 0:
                print(f"EarlyStopping: {self.monitor} did not improve for "
                      f"{self.wait_count} checks (best "
                      f"{self.best_score:.6f}); stopping at epoch "
                      f"{self.stopped_epoch}.")

    def on_validation_end(self, trainer, pl_module) -> None:
        if not self.check_on_train_epoch_end:
            self._run_check(trainer)

    def on_train_epoch_end(self, trainer, pl_module) -> None:
        if self.check_on_train_epoch_end:
            self._run_check(trainer)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "wait_count": self.wait_count,
            "stopped_epoch": self.stopped_epoch,
            "best_score": self.best_score,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.wait_count = state.get("wait_count", 0)
        self.stopped_epoch = state.get("stopped_epoch", 0)
        self.best_score = state.get("best_score")


class EMAWeightAveraging(Callback):
    """An exponential moving average of the parameters, on their device.

    After every ``update_every``-th training batch, ``ema = decay·ema +
    (1 - decay)·params`` (starting from a copy of the params at train
    start). ``swap_validation=True`` runs each validation and test with
    the averaged weights: copied into the live parameters under
    ``torch.no_grad`` before the loop and the raw ones copied back after,
    so checkpoints always hold the raw params in the train state and the
    average in this callback's ``sharded_state``.
    """

    def __init__(self, decay: float = 0.999, update_every: int = 1,
                 swap_validation: bool = False):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.decay = decay
        self.update_every = max(1, int(update_every))
        self.swap_validation = swap_validation
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        self._stashed: Optional[Dict[str, torch.Tensor]] = None

    @staticmethod
    def _params(trainer) -> Dict[str, torch.Tensor]:
        return dict(trainer.model.named_parameters())

    @torch.no_grad()
    def on_train_start(self, trainer, pl_module) -> None:
        live = self._params(trainer)
        if self.ema_params is None:
            self.ema_params = {n: p.detach().clone()
                               for n, p in live.items()}
        else:  # resumed: onto the live params' device and dtype
            self.ema_params = {n: self.ema_params[n].to(p.device, p.dtype)
                               for n, p in live.items()}

    @torch.no_grad()
    def on_train_batch_end(self, trainer, pl_module, outputs, batch,
                           batch_idx: int) -> None:
        if trainer.global_step % self.update_every:
            return
        live = self._params(trainer)
        ema = list(self.ema_params.values())
        torch._foreach_mul_(ema, self.decay)
        torch._foreach_add_(ema, torch._foreach_mul(
            [live[n].detach() for n in self.ema_params], 1.0 - self.decay))

    # -- swap the averaged weights in for evaluation ------------------- #
    @torch.no_grad()
    def _swap_in(self, trainer) -> None:
        if self.swap_validation and self.ema_params is not None \
                and self._stashed is None:
            live = self._params(trainer)
            self._stashed = {n: p.detach().clone() for n, p in live.items()}
            for n, p in live.items():
                p.copy_(self.ema_params[n])

    @torch.no_grad()
    def _swap_out(self, trainer) -> None:
        if self._stashed is not None:
            for n, p in self._params(trainer).items():
                p.copy_(self._stashed[n])
            self._stashed = None

    def on_validation_start(self, trainer, pl_module) -> None:
        self._swap_in(trainer)

    def on_validation_end(self, trainer, pl_module) -> None:
        self._swap_out(trainer)

    def on_test_start(self, trainer, pl_module) -> None:
        self._swap_in(trainer)

    def on_test_end(self, trainer, pl_module) -> None:
        self._swap_out(trainer)

    def sharded_state(self) -> Optional[Any]:
        return self.ema_params

    def load_sharded_state(self, tree: Any) -> None:
        # placed onto the live params by on_train_start
        self.ema_params = dict(tree)


class LearningRateMonitor(Callback):
    """Record the scheduled learning rate (``trainer.current_lr``) into
    ``callback_metrics[key]``: needs ``configure_optimizers`` to return
    ``(factory, schedule)``. ``logging_interval``: "epoch" (default)
    records at each train-epoch end, "step" after every batch."""

    def __init__(self, logging_interval: str = "epoch",
                 key: str = "lr"):
        if logging_interval not in ("epoch", "step"):
            raise ValueError("logging_interval must be 'epoch' or 'step'")
        self.logging_interval = logging_interval
        self.key = key

    def _record(self, trainer) -> None:
        lr = trainer.current_lr
        if lr is not None:
            trainer.callback_metrics[self.key] = lr

    def on_train_batch_end(self, trainer, pl_module, outputs, batch,
                           batch_idx: int) -> None:
        if self.logging_interval == "step":
            self._record(trainer)

    def on_train_epoch_end(self, trainer, pl_module) -> None:
        if self.logging_interval == "epoch":
            self._record(trainer)
