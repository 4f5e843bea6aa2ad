"""The Trainer (counterpart of ``ray_lightning_tpu/core/trainer.py``).

``fit`` runs through the strategy's launcher, hook for hook as the JAX
trainer does: setup, the first batch, the state (model placed on the
strategy's device and initialised from a ``torch.Generator`` seeded from
``seed``, then its optimizer -- or all of it restored from a
checkpoint), optional sanity validation, then per epoch: ``set_epoch``,
the training batches through the strategy's step, validation (per epoch
or every ``val_check_interval`` batches), the epoch aggregation of the
logs -- one host transfer per epoch, not per step -- and the epoch-end
hooks. ``validate``, ``test`` and ``predict`` run their loops alone.

Everything the JAX trainer does in one process is here: crash-safe
checkpoints in two formats (``save_checkpoint``, ``ModelCheckpoint``,
``enable_checkpointing``), ``resume="auto"`` and ``ckpt_path=`` (with
``"auto"``) on ``fit``, ``validate``, ``test`` and ``predict``, a resumed
epoch fast-forwarding its loader to the saved batch, ``profiler=``, the
non-finite guard (``nonfinite_action=``), ``predict()`` with
``limit_predict_batches=``, and the fault sites ``worker.stall``,
``worker.exit``, ``train.step``, ``loader.next`` and ``ckpt.save``.

``telemetry=`` (an :class:`~ray_lightning_tpu_torch.obs.Telemetry`)
emits what the JAX trainer emits, in its order and with its payloads:
``worker.start`` and ``fit.start`` after the train-start hooks,
``epoch.start`` / ``epoch.end`` around each epoch, ``fit.end`` after
the async saves have committed, the profiler's sections as
``profile_<name>_s`` gauges, and ``ckpt.reshard`` with
``ckpt_reshards_total`` when a restored checkpoint was saved by a world
of another size; the log is flushed only in-process (a worker's copy
never writes the driver's file). The reliability seats are the JAX
trainer's too: a heartbeat after each step and each evaluation or
prediction batch when the launcher has one (a gang's worker), and the
in-memory checkpoint tier (``_memory_checkpoint`` mirrors each
committed checkpoint's host copy into an installed
:class:`~ray_lightning_tpu_torch.reliability.elastic.MemoryCheckpointStore`,
``_memory_resume`` offers its candidates to ``resume="auto"`` ahead of
the disk); uninstalled, each is one global read and a ``None`` check.

Under a multi-worker strategy every stage runs in each worker process
(``launchers/ray_launcher.py``): every rank takes its rows of each batch
(``Strategy.shard_batch``), checkpoints are written collectively (the
stream file by rank 0, a directory's shards by every rank, its commit
marker by rank 0), ``predict`` gathers the outputs in rank order, and
rank 0 returns its results with the final train state as a byte stream,
which the driver keeps as ``train_state_dict`` (and loads into a
driver-side state where there is one). Printing and the loggers stay
rank 0's.
"""
from __future__ import annotations

import collections
import itertools
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch import util as _util
from ray_lightning_tpu_torch.core.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.core.module import TpuDataModule, TpuModule
from ray_lightning_tpu_torch.core.profiler import resolve_profiler
from ray_lightning_tpu_torch.core.seed import seed_everything
from ray_lightning_tpu_torch.core.train_state import TrainState
from ray_lightning_tpu_torch.data.loader import fast_forward, tree_map
from ray_lightning_tpu_torch.launchers.utils import WorkerOutput
from ray_lightning_tpu_torch.reliability import faults as _faults
from ray_lightning_tpu_torch.reliability import log_suppressed
from ray_lightning_tpu_torch.reliability.guard import (NonFiniteError,
                                                       poison_nan)


def _normalize_step_output(out: Any):
    """training_step may return loss | (loss, logs). JAX's third value,
    the mutated ``model_state``, has no counterpart: a module's state is
    its buffers (BatchNorm's running statistics), which the forward
    moves in place."""
    if isinstance(out, tuple):
        if len(out) == 2:
            return out[0], dict(out[1])
        raise ValueError(
            f"training_step returned a {len(out)}-tuple; expected loss or "
            "(loss, logs): the module's state (the JAX step's third value, "
            "model_state) is its buffers, which the forward updates in "
            "place")
    return out, {}


def _tensor_bytes(tree: Any) -> int:
    """Bytes of every tensor in a nest."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def _detached(logs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in logs.items()}


class Trainer:
    def __init__(self,
                 strategy=None,
                 max_epochs: int = 1,
                 max_steps: int = -1,
                 callbacks: Optional[List[Callback]] = None,
                 limit_train_batches: Optional[float] = None,
                 limit_val_batches: Optional[float] = None,
                 limit_test_batches: Optional[float] = None,
                 limit_predict_batches: Optional[float] = None,
                 num_sanity_val_steps: int = 0,
                 check_val_every_n_epoch: int = 1,
                 val_check_interval=None,
                 enable_checkpointing: bool = False,
                 default_root_dir: Optional[str] = None,
                 enable_progress_bar: bool = False,
                 log_every_n_steps: int = 50,
                 precision: str = "32",
                 gradient_clip_val: Optional[float] = None,
                 accumulate_grad_batches: int = 1,
                 track_grad_norm: bool = False,
                 profiler=None,
                 seed: Optional[int] = None,
                 resume: Optional[str] = None,
                 nonfinite_action: Optional[str] = None,
                 telemetry=None):
        from ray_lightning_tpu_torch.strategies.ddp import RayStrategy
        self.strategy = strategy if strategy is not None else RayStrategy(
            num_workers=1)
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.callbacks: List[Callback] = list(callbacks or [])
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.limit_predict_batches = limit_predict_batches
        self.num_sanity_val_steps = num_sanity_val_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        if val_check_interval is not None:
            if isinstance(val_check_interval, float):
                if not 0.0 < val_check_interval <= 1.0:
                    raise ValueError(
                        f"float val_check_interval must be in (0, 1], got "
                        f"{val_check_interval}")
            elif int(val_check_interval) < 1:
                raise ValueError(
                    f"int val_check_interval must be >= 1, got "
                    f"{val_check_interval}")
        self.val_check_interval = val_check_interval
        self.enable_checkpointing = enable_checkpointing
        self.default_root_dir = default_root_dir or os.path.join(
            os.getcwd(), "tpu_lightning_logs")
        self.enable_progress_bar = enable_progress_bar
        self.log_every_n_steps = log_every_n_steps
        self.precision = str(precision)
        self.gradient_clip_val = gradient_clip_val
        self.accumulate_grad_batches = int(accumulate_grad_batches)
        self.track_grad_norm = bool(track_grad_norm)
        self.profiler = resolve_profiler(profiler)
        self.seed = seed_everything(seed) if seed is not None else None
        # resume="auto": fit() without a ckpt_path restores the newest
        # valid checkpoint (corrupt candidates skipped with a warning) and
        # continues at its step, mid-epoch saves included
        if resume not in (None, "auto"):
            raise ValueError(
                f"resume must be None or 'auto', got {resume!r}")
        self.resume = resume
        # NaN/Inf guard over the loss and every gradient: None = off (no
        # per-step host read), "raise", "skip_batch" (the update is not
        # applied) or "restore_last_ckpt" (state rolled back to the last
        # checkpoint this run saved)
        if nonfinite_action not in (None, "raise", "skip_batch",
                                    "restore_last_ckpt"):
            raise ValueError(
                "nonfinite_action must be None, 'raise', 'skip_batch' or "
                f"'restore_last_ckpt', got {nonfinite_action!r}")
        self.nonfinite_action = nonfinite_action
        self.nonfinite_batches = 0   # guarded steps that came back bad
        self.nonfinite_restores = 0  # times restore_last_ckpt fired
        # obs.Telemetry handle (None = disarmed): the fit's lifecycle
        # events; per-step stats are StepStatsCallback's
        self.telemetry = telemetry
        if self.enable_checkpointing and not any(
                isinstance(cb, ModelCheckpoint) for cb in self.callbacks):
            self.callbacks.append(ModelCheckpoint())

        # progress / results (user-visible, PTL names)
        self.current_epoch = 0
        self.global_step = 0
        self.callback_metrics: Dict[str, Any] = {}
        self.logged_metrics: Dict[str, Any] = {}
        self.sanity_checking = False
        self.should_stop = False  # settable by callbacks
        self.state = "idle"
        self.train_state: Optional[TrainState] = None
        # the final state a remote fit returned (its "state" dict), and
        # what that return cost: bytes, seconds to serialize on rank 0,
        # to reach the driver, and to load there
        self.train_state_dict: Optional[Dict[str, Any]] = None
        self.state_stream_stats: Dict[str, float] = {}

        self._module: Optional[TpuModule] = None
        self._datamodule: Optional[TpuDataModule] = None
        self._launcher = None
        self._lr_schedule = None
        self._last_ckpt_path: str = ""   # newest save_checkpoint target
        # batches completed in the current epoch (-1 = epoch boundary):
        # checkpointed so resume can fast-forward a mid-epoch save
        self._batch_in_epoch: int = -1
        self._resume_skip: int = 0
        # the in-memory checkpoint puts of the last fit: (bytes, seconds),
        # and the checkpoint it resumed from
        self.memory_puts: List[tuple] = []
        self.resumed_from: Optional[str] = None

    # ------------------------------------------------------------------ #
    # properties
    # ------------------------------------------------------------------ #
    @property
    def global_rank(self) -> int:
        return self.strategy.global_rank

    @property
    def world_size(self) -> int:
        return self.strategy.world_size

    @property
    def num_devices(self) -> int:
        """The devices this rank drives: one (a process per device)."""
        return 1

    @property
    def model(self) -> Optional[torch.nn.Module]:
        """The trained module, unwrapped from a data-parallel wrapper."""
        if self.train_state is None:
            return None
        return self.strategy.unwrap(self.train_state.model)

    @property
    def checkpoint_callback(self) -> Optional[ModelCheckpoint]:
        for cb in self.callbacks:
            if isinstance(cb, ModelCheckpoint):
                return cb
        return None

    @property
    def current_lr(self) -> Optional[float]:
        """The learning rate of the next update when the module returned
        ``(factory, schedule)``; None otherwise. The schedule advances
        once per ``accumulate_grad_batches`` batches, as optax's
        ``MultiSteps`` advances its inner schedule."""
        schedule = self._lr_schedule
        if schedule is None and self._module is not None:
            schedule = self._optimizer()[1]
        if schedule is None:
            return None
        step = self.global_step // max(1, self.accumulate_grad_batches)
        return float(schedule(step))

    def block_until_ready(self) -> None:
        device = self.strategy.device
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    # ------------------------------------------------------------------ #
    # entry points
    # ------------------------------------------------------------------ #
    def fit(self, module: TpuModule,
            datamodule: Optional[TpuDataModule] = None,
            ckpt_path: Optional[str] = None) -> None:
        if ckpt_path is None and self.resume is not None:
            ckpt_path = self.resume  # "auto": scan and restore
        self.state = "fitting"
        output = self._launch(self._fit_worker, module, datamodule,
                              ckpt_path)
        self._recover_results(output)
        self.state = "finished"

    def validate(self, module: TpuModule,
                 datamodule: Optional[TpuDataModule] = None,
                 ckpt_path: Optional[str] = None) -> List[Dict[str, Any]]:
        return self._run_evaluate(module, datamodule, ckpt_path, "validate")

    def test(self, module: TpuModule,
             datamodule: Optional[TpuDataModule] = None,
             ckpt_path: Optional[str] = None) -> List[Dict[str, Any]]:
        return self._run_evaluate(module, datamodule, ckpt_path, "test")

    def predict(self, module: TpuModule,
                datamodule: Optional[TpuDataModule] = None,
                ckpt_path: Optional[str] = None) -> List[Any]:
        """``module.predict_step`` over ``predict_dataloader`` (at most
        ``limit_predict_batches`` batches), each output moved to the
        host, in order."""
        self.state = "predicting"
        output = self._launch(self._predict_worker, module, datamodule,
                              ckpt_path)
        self.state = "finished"
        return output.results

    def _launch(self, fn, *args) -> WorkerOutput:
        if self._launcher is None:
            self._launcher = self.strategy.configure_launcher()
        return self._launcher.launch(fn, *args, trainer=self)

    def _run_evaluate(self, module, datamodule, ckpt_path,
                      stage: str) -> List[Dict[str, Any]]:
        self.state = f"{stage[:-1] if stage.endswith('e') else stage}ing"
        output = self._launch(self._evaluate_worker, module, datamodule,
                              ckpt_path, stage)
        self.callback_metrics.update(output.callback_metrics)
        self.state = "finished"
        return output.results

    # ------------------------------------------------------------------ #
    # setup
    # ------------------------------------------------------------------ #
    def _attach(self, module: TpuModule,
                datamodule: Optional[TpuDataModule]) -> None:
        module.trainer = self
        self._module = module
        self._datamodule = datamodule

    def _dataloader(self, name: str):
        if self._datamodule is not None:
            loader = getattr(self._datamodule, name)()
            if loader is not None:
                return loader
        return getattr(self._module, name)()

    @staticmethod
    def _peek_first_batch(loader):
        """First batch + a loader safe to iterate from the start: a bare
        iterator gets its consumed head chained back on."""
        it = iter(loader)
        first = next(it)
        if it is loader:  # non-re-iterable: iter() returned self
            loader = itertools.chain([first], it)
        return first, loader

    def _optimizer(self):
        """The module's optimizer factory and optional schedule."""
        out = self._module.configure_optimizers()
        return out if isinstance(out, tuple) else (out, None)


    def _to_device(self, batch: Any) -> Any:
        """This rank's rows of a global batch (all of it in one process),
        numpy/tensor leaves onto the strategy's device; floating leaves
        cast to bf16 under ``precision="bf16..."``."""
        batch = self.strategy.shard_batch(batch)
        device = self.strategy.root_device
        bf16 = self.precision.startswith("bf16")

        def move(x):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.asarray(x))
            if bf16 and t.is_floating_point():
                t = t.to(torch.bfloat16)
            return t.to(device, non_blocking=True)

        return tree_map(move, batch)

    def _seeds(self):
        """(init generator, step generator, eval seed) from ``seed``: the
        init generator is seeded with ``seed`` itself, so
        ``model.reset_parameters(torch.Generator().manual_seed(seed))``
        rebuilds the trainer's initial weights."""
        seed = self.seed if self.seed is not None else 0
        step_seed, eval_seed = (int(s) for s in np.random.SeedSequence(
            seed).generate_state(2, np.uint64) >> np.uint64(1))
        return (torch.Generator().manual_seed(seed),
                torch.Generator().manual_seed(step_seed), eval_seed)

    def _setup_state(self, sample_batch: Any,
                     restored: Optional[Dict[str, Any]] = None
                     ) -> TrainState:
        """Place and initialise the model, wrap it for the strategy,
        build its optimizer and the training and evaluation steps; then
        copy a checkpoint's ``state`` in when one is given."""
        module = self._module
        device = self.strategy.root_device
        model = module.configure_model()
        if any(p.is_meta for p in model.parameters()):
            model = model.to_empty(device=device)
        else:
            model = model.to(device)
        init_gen, step_gen, self._eval_seed = self._seeds()
        module.init_variables(model, init_gen, self._to_device(sample_batch))
        strategy = self.strategy
        strategy.bind_batch_stats(model)
        model = strategy.wrap_model(model)
        factory, lr_schedule = self._optimizer()
        self._lr_schedule = lr_schedule
        optimizer = strategy.make_optimizer(factory, model)

        def loss_fn(model, batch, generator):
            out = module.training_step(model, batch, generator)
            logged = module._log_buffer.drain()
            loss, logs = _normalize_step_output(out)
            return loss, _detached({**logs, **logged})

        def eval_fn_builder(step_name):
            def eval_fn(model, batch, generator):
                logs = getattr(module, step_name)(model, batch, generator)
                logged = module._log_buffer.drain()
                return _detached({**(logs or {}), **logged})
            return eval_fn

        self._train_step = strategy.make_train_step(
            loss_fn, log_grad_norm=self.track_grad_norm,
            gradient_clip_val=self.gradient_clip_val,
            accumulate_grad_batches=self.accumulate_grad_batches,
            lr_schedule=lr_schedule,
            guard_nonfinite=self.nonfinite_action is not None)
        self._val_step = strategy.make_eval_step(
            eval_fn_builder("validation_step"))
        self._test_step = strategy.make_eval_step(
            eval_fn_builder("test_step"))
        state = TrainState(step=0, model=model, optimizer=optimizer,
                           generator=step_gen)
        if restored is not None:
            # re-shard on restore: the loaders return the whole state, so
            # a checkpoint saved N-way lands on this run's world of M
            from ray_lightning_tpu_torch.core.checkpoint import \
                reshard_state
            reshard_state(state, restored, strategy)
        self.train_state = state
        return state

    # ------------------------------------------------------------------ #
    # fit loop
    # ------------------------------------------------------------------ #
    def _fit_worker(self, module: TpuModule,
                    datamodule: Optional[TpuDataModule],
                    ckpt_path: Optional[str]) -> WorkerOutput:
        self._attach(module, datamodule)
        self.should_stop = False
        self.memory_puts = []
        self.profiler.reset()  # per-fit scope
        module.prepare_data()
        if datamodule is not None:
            datamodule.prepare_data()
            datamodule.setup("fit")
        module.setup("fit")
        for cb in self.callbacks:
            cb.setup(self, module, "fit")

        train_loader = self._dataloader("train_dataloader")
        val_loader = self._dataloader("val_dataloader")
        sample_batch, train_loader = self._peek_first_batch(train_loader)
        restored_ckpt = None
        if ckpt_path == "auto":
            ckpt_path, restored_ckpt = self._resolve_auto_resume()
        elif ckpt_path is not None:
            restored_ckpt = self._read_checkpoint(ckpt_path)
        state = self._setup_state(
            sample_batch,
            restored_ckpt["state"] if restored_ckpt else None)
        # where the fit resumed from: a path, "<memory:step=N>", or None
        self.resumed_from = ckpt_path if restored_ckpt is not None else None
        start_epoch = 0
        self._resume_skip = 0
        tel = self.telemetry
        if restored_ckpt is not None:
            saved_world = int(
                (restored_ckpt.get("world") or {}).get("world_size") or 0)
            if saved_world and saved_world != self.strategy.num_workers \
                    and tel is not None:
                from ray_lightning_tpu_torch.reliability.elastic import (
                    COUNTER_RESHARDS, EVENT_CKPT_RESHARD)
                tel.event(EVENT_CKPT_RESHARD, from_world=saved_world,
                          to_world=self.strategy.num_workers,
                          global_step=int(
                              restored_ckpt.get("global_step", 0)))
                tel.metrics.counter(
                    COUNTER_RESHARDS,
                    help="checkpoints re-sharded onto a different world "
                         "size on restore").inc()
            saved_epoch = int(restored_ckpt.get("epoch", -1))
            # a mid-epoch save recorded how many batches of its epoch were
            # done: resume re-enters that epoch and fast-forwards the
            # loader; -1 = saved at the epoch boundary
            bie = int((restored_ckpt.get("loop") or {})
                      .get("batch_in_epoch", -1))
            if bie < 0:
                start_epoch = saved_epoch + 1
            else:
                start_epoch = max(0, saved_epoch)
                self._resume_skip = bie
            self.global_step = int(restored_ckpt.get("global_step", 0))
            for cb in self.callbacks:
                cb_state = restored_ckpt.get("callbacks", {}).get(
                    type(cb).__name__)
                if cb_state:
                    cb.load_state_dict(cb_state)
                cb_tree = (restored_ckpt.get("callback_arrays") or {}).get(
                    type(cb).__name__)
                if cb_tree is not None:
                    cb.load_sharded_state(cb_tree)
            module.on_load_checkpoint(restored_ckpt.get("module", {}))

        module.on_fit_start()
        for cb in self.callbacks:
            cb.on_fit_start(self, module)

        if val_loader is not None and self.num_sanity_val_steps > 0:
            self.sanity_checking = True
            for cb in self.callbacks:
                cb.on_sanity_check_start(self, module)
            self._run_validation(val_loader, module,
                                 limit=self.num_sanity_val_steps)
            for cb in self.callbacks:
                cb.on_sanity_check_end(self, module)
            self.sanity_checking = False

        module.on_train_start()
        for cb in self.callbacks:
            cb.on_train_start(self, module)

        if tel is not None:
            tel.event("worker.start", rank=self.global_rank,
                      world_size=self.world_size,
                      num_devices=self.num_devices)
            tel.event("fit.start", max_epochs=self.max_epochs,
                      max_steps=self.max_steps, start_epoch=start_epoch,
                      global_step=self.global_step,
                      resumed=restored_ckpt is not None)

        # gang supervision seat: a gang's worker shim beats to the
        # driver's watchdog; other launchers have no heartbeat
        _beat = getattr(self._launcher, "heartbeat", None)
        _rank = self.global_rank

        stop = False
        for epoch in range(start_epoch, self.max_epochs):
            self.current_epoch = epoch
            if tel is not None:
                tel.event("epoch.start", epoch=epoch,
                          global_step=self.global_step)
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            module.on_train_epoch_start()
            for cb in self.callbacks:
                cb.on_train_epoch_start(self, module)

            epoch_logs: List[Dict[str, Any]] = []
            n_batches = self._resolve_limit(train_loader,
                                            self.limit_train_batches)
            # float f = every int(f * n_batches) batches of this epoch;
            # int N = every N train batches counted across epochs;
            # check_val_every_n_epoch still gates which epochs validate
            epoch_validates = (epoch + 1) % self.check_val_every_n_epoch \
                == 0
            val_every = 0
            if self.val_check_interval is not None and \
                    val_loader is not None and epoch_validates:
                if isinstance(self.val_check_interval, float):
                    if n_batches >= 2**31:
                        raise ValueError(
                            "a float val_check_interval needs a sized "
                            "train dataloader (or an integer "
                            "limit_train_batches) to resolve the epoch "
                            "length; pass an int interval instead")
                    val_every = max(1, int(self.val_check_interval
                                           * n_batches))
                else:
                    val_every = int(self.val_check_interval)
            # resume fast-forward: skip exactly the batches the mid-epoch
            # checkpoint had done (the loader is deterministic per epoch,
            # so the rest matches the uninterrupted run)
            skip = self._resume_skip if epoch == start_epoch else 0
            self._batch_in_epoch = skip
            feed = fast_forward(train_loader, skip)
            t0 = time.perf_counter()
            for batch_idx, batch in enumerate(
                    self.profiler.profile_iterable(
                        self._prefetch(feed, max(0, n_batches - skip)),
                        "get_train_batch"), start=skip):
                # worker-class chaos sites fire before the step: "stall"
                # wedges this loop (heartbeats stop), "exit" ends the
                # process outright
                _faults.fire("worker.stall", rank=_rank)
                _faults.fire("worker.exit", rank=_rank)
                if _faults.fire("train.step") == _faults.MODE_NAN:
                    batch = poison_nan(batch)
                module.on_train_batch_start(batch, batch_idx)
                for cb in self.callbacks:
                    cb.on_train_batch_start(self, module, batch, batch_idx)
                module.on_before_optimizer_step(state.optimizer)
                for cb in self.callbacks:
                    cb.on_before_optimizer_step(self, module,
                                                state.optimizer)
                with self.profiler.profile("train_step"):
                    state, logs = self._train_step(state, batch)
                if self.nonfinite_action is not None and \
                        bool(logs["nonfinite"]):
                    state = self._handle_nonfinite(state)
                self.train_state = state
                self.global_step += 1
                self._batch_in_epoch = batch_idx + 1
                if _beat is not None:   # step completed: tick liveness
                    _beat(self.global_step)
                epoch_logs.append(logs)
                module.on_train_batch_end(logs, batch, batch_idx)
                for cb in self.callbacks:
                    cb.on_train_batch_end(self, module, logs, batch,
                                          batch_idx)
                self._launcher.drain_queue()
                if val_every:
                    count = (batch_idx + 1 if isinstance(
                        self.val_check_interval, float)
                        else self.global_step)
                    if count % val_every == 0:
                        with self.profiler.profile("validation"):
                            self._run_validation(val_loader, module)
                if 0 <= self.max_steps <= self.global_step:
                    stop = True
                    break
                if self.should_stop:
                    break

            # checkpoints taken from here on (epoch-end saves) resume at
            # the next epoch, not inside this one
            self._batch_in_epoch = -1

            # epoch aggregation: one host transfer per epoch
            agg = self._aggregate_epoch_logs(epoch_logs, prefix="train_")
            self.callback_metrics.update(agg)
            if epoch_logs:
                self.logged_metrics = self._aggregate_epoch_logs(
                    epoch_logs[-1:])
            if self.enable_progress_bar and self.global_rank == 0:
                dt = time.perf_counter() - t0
                msg = ", ".join(f"{k}={v:.4f}" for k, v in agg.items())
                print(f"epoch {epoch}: {msg} ({dt:.1f}s)")

            run_epoch_val = val_loader is not None and not stop and \
                not self.should_stop and epoch_validates
            if val_every:
                # interval mode owns validation; the epoch boundary only
                # adds one for a float interval that doesn't divide the
                # epoch
                run_epoch_val = (run_epoch_val
                                 and isinstance(self.val_check_interval,
                                                float)
                                 and n_batches % val_every != 0)
            if run_epoch_val:
                with self.profiler.profile("validation"):
                    self._run_validation(val_loader, module)

            module.on_train_epoch_end()
            with self.profiler.profile("epoch_end_callbacks"):
                for cb in self.callbacks:
                    cb.on_train_epoch_end(self, module)
            if tel is not None:
                tel.event("epoch.end", epoch=epoch,
                          global_step=self.global_step)
            if stop or self.should_stop:
                break

        module.on_train_end()
        for cb in self.callbacks:
            cb.on_train_end(self, module)
        module.on_fit_end()
        for cb in self.callbacks:
            cb.on_fit_end(self, module)
        module.teardown("fit")
        for cb in self.callbacks:
            cb.teardown(self, module, "fit")
        from ray_lightning_tpu_torch.core.checkpoint import \
            wait_for_async_saves
        wait_for_async_saves()
        if tel is not None:
            tel.event("fit.end", epoch=self.current_epoch,
                      global_step=self.global_step,
                      stopped_early=self.should_stop)
            # the profiler's sections become gauges
            for name, (_count, total) in self.profiler.records().items():
                tel.metrics.gauge(
                    f"profile_{name}_s",
                    help="SimpleProfiler section total (s)").set(total)
            # in-process only: a worker's trainer is a copy, and its
            # flush would overwrite the driver's log with this rank's
            # events (the driver flushes after launch.done)
            if not self.strategy.is_remote:
                tel.flush()
        if self.global_rank == 0:
            self.profiler.describe()
        return self._collect_results()

    def _handle_nonfinite(self, state: TrainState) -> TrainState:
        """Apply ``nonfinite_action`` to a step whose loss or gradients
        were not finite. The step already left params and optimizer state
        untouched, so ``skip_batch`` only accounts for it;
        ``restore_last_ckpt`` also rolls the state back to the newest
        checkpoint this run saved."""
        self.nonfinite_batches += 1
        where = (f"global step {self.global_step} "
                 f"(epoch {self.current_epoch})")
        if self.nonfinite_action == "raise":
            raise NonFiniteError(
                f"non-finite loss/gradients at {where}; use "
                "nonfinite_action='skip_batch' or 'restore_last_ckpt' "
                "to continue past poisoned batches instead")
        if self.nonfinite_action == "skip_batch":
            log_suppressed("train.step",
                           NonFiniteError(f"non-finite update at {where}"),
                           "update skipped, weights untouched")
            return state
        path = self._last_ckpt_path
        if path and not os.path.exists(path):
            # pruned under us (top-k kept better ones): fall back to the
            # newest valid candidate in the same directory
            from ray_lightning_tpu_torch.core.checkpoint import \
                find_resume_candidates
            candidates = find_resume_candidates(os.path.dirname(path))
            path = candidates[0] if candidates else ""
        if not path:
            raise NonFiniteError(
                f"non-finite loss/gradients at {where} and "
                "nonfinite_action='restore_last_ckpt', but no checkpoint "
                "is available -- enable checkpointing (e.g. "
                "ModelCheckpoint(every_n_train_steps=...)) or use "
                "'skip_batch'")
        self.strategy.load_state_dict(state,
                                      self._read_checkpoint(path)["state"])
        self.nonfinite_restores += 1
        log_suppressed("train.step",
                       NonFiniteError(f"non-finite update at {where}"),
                       f"state rolled back to {path}")
        return state

    def _resolve_auto_resume(self):
        """``resume="auto"``: the newest *valid* checkpoint -- the
        in-memory tier first, then the on-disk scan -- or ``(None,
        None)`` for a fresh start. Only corruption-class errors skip to an
        older candidate; anything else propagates."""
        from ray_lightning_tpu_torch.core.checkpoint import (
            CorruptCheckpointError, find_resume_candidates)
        ckpt_cb = self.checkpoint_callback
        root = ckpt_cb.dirpath if ckpt_cb is not None and ckpt_cb.dirpath \
            else os.path.join(self.default_root_dir, "checkpoints")
        candidates = find_resume_candidates(root)
        mem = self._memory_resume(candidates)
        if mem is not None:
            return mem
        for path in candidates:
            try:
                return path, self._read_checkpoint(path)
            except (CorruptCheckpointError, OSError, EOFError,
                    ValueError) as exc:
                log_suppressed(
                    "ckpt.load", exc,
                    f"resume='auto' skipping corrupt candidate {path}")
        return None, None

    def _memory_resume(self, disk_candidates):
        """The in-memory checkpoint tier of ``resume="auto"``.

        With a :class:`~ray_lightning_tpu_torch.reliability.elastic.
        MemoryCheckpointStore` (or a worker's client) installed, its
        candidates come ahead of the disk. The disk still wins with
        strictly newer progress (the memory tier can die with its host
        while the disk copy survives), and whenever its names carry no
        ``step=`` to order against. Only the candidate restored is
        copied. Uninstalled: one global read and a ``None`` check."""
        from ray_lightning_tpu_torch.reliability import elastic as _elastic
        store = _elastic.get_memory_store()
        if store is None:
            return None
        from ray_lightning_tpu_torch.core.checkpoint import step_of
        disk_best = step_of(disk_candidates[0]) if disk_candidates else -1
        if disk_candidates and disk_best < 0:
            # disk checkpoints we cannot order against: resuming from
            # memory could roll back committed progress
            return None
        for step, ckpt in store.resume_candidates(copy_payloads=False):
            if step < disk_best:
                break   # the disk holds newer committed progress
            if not isinstance(ckpt, dict) or ckpt.get("state") is None:
                log_suppressed(
                    "ckpt.memory",
                    ValueError(f"malformed in-memory candidate at "
                               f"step {step}"),
                    "skipping to the next memory candidate")
                continue
            import copy
            ckpt = copy.deepcopy(ckpt)   # callbacks and the restore mutate
            for cb in self.callbacks:
                cb.on_load_checkpoint(self, self._module, ckpt)
            if self.telemetry is not None:
                from ray_lightning_tpu_torch.reliability.elastic import \
                    EVENT_MEMORY_RESUME
                self.telemetry.event(EVENT_MEMORY_RESUME, step=step)
            return f"<memory:step={step}>", ckpt
        return None

    def _run_validation(self, val_loader, module, limit=None):
        module.on_validation_epoch_start()
        for cb in self.callbacks:
            cb.on_validation_start(self, module)
            cb.on_validation_epoch_start(self, module)
        n = self._resolve_limit(
            val_loader, self.limit_val_batches if limit is None else limit)
        agg = self._eval_loop(val_loader, self._val_step, n, module=module,
                              mode="validation")
        if not self.sanity_checking:
            # sanity metrics never reach callback_metrics
            self.callback_metrics.update(agg)
        module.on_validation_epoch_end()
        for cb in self.callbacks:
            cb.on_validation_epoch_end(self, module)
            cb.on_validation_end(self, module)
        self._launcher.drain_queue()
        return agg

    def _eval_loop(self, loader, step_fn, n_batches: int, module=None,
                   mode: Optional[str] = None) -> Dict[str, Any]:
        """``mode`` ("validation" | "test") fires the per-batch hooks. The
        steps draw from a generator seeded from (seed, global_step): fresh
        per evaluation, the same from run to run."""
        logs_list: List[Dict[str, Any]] = []
        # gang liveness during evaluation: no global_step advances, but
        # a rank working through batches is not hung (clamped to >= 1 so
        # the watchdog leaves its startup grace; sanity checking beats
        # -1 and keeps it)
        _beat = getattr(self._launcher, "heartbeat", None)
        generator = torch.Generator().manual_seed(
            (self._eval_seed + self.global_step) % 2**63)
        for batch_idx, batch in enumerate(self._prefetch(loader, n_batches)):
            if mode is not None:
                getattr(module, f"on_{mode}_batch_start",
                        lambda *a: None)(batch, batch_idx)
                for cb in self.callbacks:
                    getattr(cb, f"on_{mode}_batch_start")(
                        self, module, batch, batch_idx)
            logs = step_fn(self.train_state, batch, generator)
            logs_list.append(logs)
            if _beat is not None:
                _beat(-1 if self.sanity_checking
                      else max(1, self.global_step))
            if mode is not None:
                getattr(module, f"on_{mode}_batch_end",
                        lambda *a: None)(logs, batch, batch_idx)
                for cb in self.callbacks:
                    getattr(cb, f"on_{mode}_batch_end")(
                        self, module, logs, batch, batch_idx)
        return self._aggregate_epoch_logs(logs_list)

    @staticmethod
    def _aggregate_epoch_logs(logs_list: List[Dict[str, Any]],
                              prefix: str = "") -> Dict[str, float]:
        """Per key, the mean over batches of each batch's mean, as Python
        floats: the device values cross to the host in one transfer."""
        if not logs_list:
            return {}
        keys = list(logs_list[0].keys())
        means = []
        for k in keys:
            vals = [torch.as_tensor(h[k]).float().mean()
                    for h in logs_list if k in h]
            means.append(torch.stack([v.to(vals[0].device)
                                      for v in vals]).mean())
        host = torch.stack([m.to(means[0].device) for m in means]).tolist()
        return {(k if (k != "loss" or not prefix) else prefix + k): v
                for k, v in zip(keys, host)}

    def _prefetch(self, loader, n_batches: int, depth: int = 2):
        """Move up to ``depth`` batches to the device ahead of the step
        (copies overlap the step's queued work)."""
        buf = collections.deque()
        count = 0
        for batch in loader:
            if count >= n_batches:
                break
            if _faults.fire("loader.next") == _faults.MODE_NAN:
                batch = poison_nan(batch)
            buf.append(self._to_device(batch))
            count += 1
            if len(buf) >= depth:
                yield buf.popleft()
        while buf:
            yield buf.popleft()

    @staticmethod
    def _resolve_limit(loader, limit) -> int:
        try:
            total = len(loader)
        except TypeError:
            total = float("inf")
        if limit is None:
            return total if total != float("inf") else 2**31
        if isinstance(limit, float) and 0 <= limit <= 1:
            if total == float("inf"):
                raise ValueError(
                    "A fractional batch limit requires a dataloader with "
                    "__len__; pass an integer limit instead.")
            return int(total * limit)
        return int(limit)

    # ------------------------------------------------------------------ #
    # evaluate / predict
    # ------------------------------------------------------------------ #
    def _prepare_eval(self, module, datamodule, ckpt_path, stage: str,
                      loader_name: str):
        self._attach(module, datamodule)
        module.prepare_data()
        if datamodule is not None:
            datamodule.prepare_data()
            datamodule.setup(stage)
        module.setup(stage)
        loader = self._dataloader(loader_name)
        if loader is None:
            raise ValueError(f"No {loader_name} defined for {stage}")
        if ckpt_path == "auto":
            _path, restored = self._resolve_auto_resume()
        elif ckpt_path:
            restored = self._read_checkpoint(ckpt_path)
        elif self.train_state is None and self.train_state_dict is not None:
            restored = {"state": self.train_state_dict}  # a remote fit's
        else:
            restored = None
        if self.train_state is None or restored is not None:
            sample, loader = self._peek_first_batch(loader)
            self._setup_state(sample, restored["state"] if restored
                              else None)
        return loader

    def _evaluate_worker(self, module, datamodule, ckpt_path,
                         stage: str) -> WorkerOutput:
        loader_name = ("val_dataloader" if stage == "validate" else
                       "test_dataloader")
        loader = self._prepare_eval(module, datamodule, ckpt_path, stage,
                                    loader_name)
        if stage == "validate":
            agg = self._run_validation(loader, module)
        else:
            n = self._resolve_limit(loader, self.limit_test_batches)
            for cb in self.callbacks:
                cb.on_test_start(self, module)
                cb.on_test_epoch_start(self, module)
            agg = self._eval_loop(loader, self._test_step, n, module=module,
                                  mode="test")
            self.callback_metrics.update(agg)
            for cb in self.callbacks:
                cb.on_test_epoch_end(self, module)
                cb.on_test_end(self, module)
        return WorkerOutput(
            best_model_path=None, state_stream=None,
            trainer_state=dict(epoch=self.current_epoch,
                               global_step=self.global_step),
            callback_metrics=dict(self.callback_metrics),
            logged_metrics={}, results=[agg])

    def _predict_worker(self, module, datamodule,
                        ckpt_path) -> WorkerOutput:
        loader = self._prepare_eval(module, datamodule, ckpt_path, "predict",
                                    "predict_dataloader")
        model = self.model
        generator = torch.Generator().manual_seed(
            (self._eval_seed + self.global_step) % 2**63)
        n = self._resolve_limit(loader, self.limit_predict_batches)
        outs = []
        _beat = getattr(self._launcher, "heartbeat", None)
        for cb in self.callbacks:
            cb.on_predict_start(self, module)
            cb.on_predict_epoch_start(self, module)
        model.eval()
        for batch_idx, batch in enumerate(loader):
            if batch_idx >= n:
                break
            for cb in self.callbacks:
                cb.on_predict_batch_start(self, module, batch, batch_idx)
            batch = self._to_device(batch)
            with torch.no_grad():
                out = self.strategy.gather_outputs(
                    module.predict_step(model, batch, generator))
            out = tree_map(lambda t: t.cpu() if isinstance(
                t, torch.Tensor) else t, out)
            outs.append(out)
            if _beat is not None:   # gang liveness during prediction
                _beat(max(1, self.global_step))
            for cb in self.callbacks:
                cb.on_predict_batch_end(self, module, out, batch,
                                        batch_idx)
        for cb in self.callbacks:
            cb.on_predict_epoch_end(self, module)
            cb.on_predict_end(self, module)
        return WorkerOutput(
            best_model_path=None, state_stream=None,
            trainer_state=dict(epoch=self.current_epoch,
                               global_step=self.global_step),
            callback_metrics={}, logged_metrics={}, results=outs)

    # ------------------------------------------------------------------ #
    # results and checkpoints (the worker <-> driver contract)
    # ------------------------------------------------------------------ #
    def _collect_results(self) -> WorkerOutput:
        """Best checkpoint path, progress counters, metrics as plain
        numbers, callback states and, in a worker, the final train state
        as a byte stream (the reference's ``ray_launcher.py:313-350``).
        Every rank calls it -- the full state is a collective where the
        state is sharded -- and only rank 0 serializes; the stream's
        serialize seconds and send time ride in ``trainer_state``."""
        ckpt_cb = self.checkpoint_callback
        trainer_state = dict(epoch=self.current_epoch,
                             global_step=self.global_step,
                             should_stop=self.should_stop,
                             memory_puts=list(self.memory_puts),
                             resumed_from=self.resumed_from)
        stream = None
        if self.strategy.is_remote:
            state = self.strategy.state_dict(self.train_state, full=True)
            if self.global_rank == 0:
                t0 = time.perf_counter()
                stream = _util.to_state_stream(state)
                trainer_state.update(
                    state_stream_serialize_s=time.perf_counter() - t0,
                    state_stream_sent_at=time.time())
            del state
        return WorkerOutput(
            best_model_path=ckpt_cb.best_model_path if ckpt_cb else None,
            state_stream=stream,
            trainer_state=trainer_state,
            callback_metrics=_util.tensor_metrics_to_numpy(
                self.callback_metrics),
            logged_metrics=_util.tensor_metrics_to_numpy(
                self.logged_metrics),
            callback_states={type(cb).__name__: cb.state_dict()
                             for cb in self.callbacks})

    def _recover_results(self, output: WorkerOutput) -> None:
        """Progress counters, metrics, callback states and a remote fit's
        final state back into the driver-side objects (the same objects
        in-process; the reference's ``ray_launcher.py:352-380``)."""
        state = dict(output.trainer_state)
        sent_at = state.pop("state_stream_sent_at", None)
        serialize_s = state.pop("state_stream_serialize_s", None)
        self.current_epoch = state.get("epoch", self.current_epoch)
        self.global_step = state.get("global_step", self.global_step)
        self.should_stop = state.get("should_stop", self.should_stop)
        self.memory_puts = list(state.get("memory_puts", self.memory_puts))
        self.resumed_from = state.get("resumed_from", self.resumed_from)
        self.callback_metrics.update(
            _util.numpy_metrics_to_device(output.callback_metrics))
        self.logged_metrics.update(
            _util.numpy_metrics_to_device(output.logged_metrics))
        for cb in self.callbacks:
            st = (output.callback_states or {}).get(type(cb).__name__)
            if st:
                cb.load_state_dict(st)
        if output.state_stream is not None:
            arrived = time.time()
            t0 = time.perf_counter()
            restored = _util.load_state_stream(output.state_stream,
                                               map_location="cpu")
            self.state_stream_stats = dict(
                bytes=len(output.state_stream), serialize_s=serialize_s,
                transfer_s=arrived - sent_at,
                load_s=time.perf_counter() - t0)
            if self.train_state is not None:
                self.strategy.load_state_dict(self.train_state, restored)
            self.train_state_dict = restored

    def save_checkpoint(self, filepath: str,
                        save_format: str = "stream",
                        async_save: bool = False) -> None:
        """Write a full resumable checkpoint.

        ``save_format="stream"``: one ``torch.save`` file, written to a
        tmp file and ``os.replace``\\ d into place. ``"orbax"``: a committed
        directory through ``torch.distributed.checkpoint``
        (:mod:`ray_lightning_tpu_torch.core.checkpoint`); ``async_save``
        (directories only) overlaps the write with training, and the
        trainer waits for it at fit end. Under a process group every rank
        calls it: rank 0 writes the stream file, every rank its shards of
        a directory.
        """
        if async_save and save_format != "orbax":
            raise ValueError(
                "async_save requires save_format='orbax' (the stream "
                "format is one synchronous host write)")
        ckpt = self.dump_checkpoint(consolidate=save_format != "orbax")
        if save_format == "orbax":
            from ray_lightning_tpu_torch.core.checkpoint import \
                save_sharded_checkpoint
            save_sharded_checkpoint(filepath, ckpt, async_save=async_save,
                                    strategy=self.strategy)
        else:
            if self.global_rank == 0:
                os.makedirs(os.path.dirname(os.path.abspath(filepath)),
                            exist_ok=True)
                tmp = f"{filepath}.tmp-{os.getpid()}"
                try:
                    with open(tmp, "wb") as f:
                        _util.save_state_stream(ckpt, f)
                    # pre-commit fault seat + atomic publish: a crash
                    # mid-write leaves only the tmp file, which scans
                    # ignore
                    _faults.fire("ckpt.save")
                    os.replace(tmp, filepath)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            self.strategy.barrier()   # on disk before any rank reads it
        self._last_ckpt_path = filepath
        self._memory_checkpoint(ckpt)

    def _memory_checkpoint(self, ckpt: Dict[str, Any]) -> None:
        """Mirror a just-committed checkpoint into the in-memory tier.

        Runs after the disk commit (the memory entry is never the only
        copy of progress the disk lacks) and only with a store or a
        worker's client installed -- otherwise one global read and a
        ``None`` check. The payload is a host copy: every tensor is
        copied to the CPU first (``core/checkpoint.py:host_copy``; FSDP's
        shards of a directory checkpoint are gathered to full tensors
        first, a collective every rank reaches here), so the store and
        its channel never hold a CUDA tensor. Best-effort: a failure is
        logged and the disk copy stands alone. Each put's payload bytes
        and copy-and-put seconds are appended to ``memory_puts`` (rank
        0's reach the driver with the fit's results)."""
        from ray_lightning_tpu_torch.reliability import elastic as _elastic
        store = _elastic.get_memory_store()
        if store is None:
            return
        try:
            t0 = time.perf_counter()
            from ray_lightning_tpu_torch.core.checkpoint import host_copy
            from ray_lightning_tpu_torch.strategies.sharding import \
                full_state
            state = ckpt.get("state")
            if self.strategy.in_world:
                state = full_state(state)
            payload = host_copy({**ckpt, "state": state})
            store.put(int(self.global_step), payload,
                      rank=self.global_rank,
                      world_size=self.strategy.num_workers)
            self.memory_puts.append((_tensor_bytes(payload),
                                     time.perf_counter() - t0))
        except Exception as exc:  # noqa: BLE001 - the tier is best-effort
            log_suppressed("ckpt.memory", exc,
                           "in-memory checkpoint skipped; the disk copy "
                           "is intact")

    def dump_checkpoint(self, consolidate: bool = True) -> Dict[str, Any]:
        """The checkpoint dict: progress, loop position, world size, the
        train state, callback states and tensors, and the module's own
        state. Its tensors alias the live ones. A collective under a
        process group where the state is sharded; ``consolidate=False``
        keeps FSDP's shards (the directory format writes them)."""
        module_state: Dict[str, Any] = {}
        if self._module is not None:
            self._module.on_save_checkpoint(module_state)
        ckpt = {
            "epoch": self.current_epoch,
            "global_step": self.global_step,
            "loop": {"batch_in_epoch": int(self._batch_in_epoch)},
            "world": {"world_size": int(self.strategy.num_workers)},
            "state": self.strategy.state_dict(self.train_state,
                                              full=consolidate),
            "callbacks": {type(cb).__name__: cb.state_dict()
                          for cb in self.callbacks},
            "module": module_state,
        }
        cb_arrays = {type(cb).__name__: cb.sharded_state()
                     for cb in self.callbacks
                     if cb.sharded_state() is not None}
        if cb_arrays:
            ckpt["callback_arrays"] = cb_arrays
        for cb in self.callbacks:
            cb.on_save_checkpoint(self, self._module, ckpt)
        return ckpt

    def _read_checkpoint(self, path: str) -> Dict[str, Any]:
        """A checkpoint file or directory, its tensors on the CPU (the
        train state's ``load_state_dict`` puts each on its param's
        device)."""
        from ray_lightning_tpu_torch.core.checkpoint import (
            CorruptCheckpointError, is_sharded_checkpoint,
            load_sharded_checkpoint, wait_for_async_saves)
        wait_for_async_saves()  # never read a half-committed directory
        self.strategy.barrier()  # nor one another rank still commits
        if is_sharded_checkpoint(path):
            ckpt = load_sharded_checkpoint(path, map_location="cpu")
        else:
            with open(path, "rb") as f:
                try:
                    ckpt = _util.load_state_stream(f, map_location="cpu")
                except (RuntimeError, EOFError, ValueError) as exc:
                    raise CorruptCheckpointError(
                        f"unreadable checkpoint {path}: "
                        f"{type(exc).__name__}: {exc}") from exc
        for cb in self.callbacks:
            cb.on_load_checkpoint(self, self._module, ckpt)
        return ckpt
