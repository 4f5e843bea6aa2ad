"""The Trainer (counterpart of ``ray_lightning_tpu/core/trainer.py``).

``fit`` runs through the strategy's launcher, hook for hook as the JAX
trainer does: setup, the first batch, the state (model placed on the
strategy's device and initialised from a ``torch.Generator`` seeded from
``seed``, then its optimizer), optional sanity validation, then per
epoch: ``set_epoch``, the training batches through the strategy's step,
validation (per epoch or every ``val_check_interval`` batches), the epoch
aggregation of the logs -- one host transfer per epoch, not per step --
and the epoch-end hooks. ``validate`` and ``test`` run the evaluation
loop alone.

Not ported in this slice (each raises ``NotImplementedError`` naming its
``ROADMAP.md`` item): checkpointing (``enable_checkpointing=True``,
``ckpt_path=``, ``resume=``), ``nonfinite_action=``, ``telemetry=``, a
``profiler=``, and ``predict()`` with ``limit_predict_batches=``.
"""
from __future__ import annotations

import collections
import itertools
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.module import TpuDataModule, TpuModule
from ray_lightning_tpu_torch.core.seed import seed_everything
from ray_lightning_tpu_torch.core.train_state import TrainState
from ray_lightning_tpu_torch.data.loader import tree_map
from ray_lightning_tpu_torch.launchers.utils import WorkerOutput


def _normalize_step_output(out: Any):
    """training_step may return loss | (loss, logs)."""
    if isinstance(out, tuple):
        if len(out) == 2:
            return out[0], dict(out[1])
        raise ValueError(
            f"training_step returned a {len(out)}-tuple; expected loss or "
            "(loss, logs) (the module holds its own state)")
    return out, {}


def _detached(logs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in logs.items()}


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md {item})")


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
        unported = {
            "enable_checkpointing=True (ModelCheckpoint)":
                (enable_checkpointing, "T1"),
            "resume=": (resume is not None, "T1"),
            "nonfinite_action=": (nonfinite_action is not None, "T5"),
            "telemetry=": (telemetry is not None, "T5"),
            "profiler=": (profiler is not None, "T5"),
            "limit_predict_batches= (predict)":
                (limit_predict_batches is not None, "T4"),
        }
        for what, (bad, item) in unported.items():
            if bad:
                raise _unported(f"Trainer({what})", item)
        from ray_lightning_tpu_torch.strategies.ddp import RayStrategy
        self.strategy = strategy if strategy is not None else RayStrategy(
            num_workers=1)
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.callbacks: List[Callback] = list(callbacks or [])
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
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
        self.default_root_dir = default_root_dir or os.path.join(
            os.getcwd(), "tpu_lightning_logs")
        self.enable_progress_bar = enable_progress_bar
        self.log_every_n_steps = log_every_n_steps
        self.precision = str(precision)
        self.gradient_clip_val = gradient_clip_val
        self.accumulate_grad_batches = int(accumulate_grad_batches)
        self.track_grad_norm = bool(track_grad_norm)
        self.seed = seed_everything(seed) if seed is not None else None

        # progress / results (user-visible, PTL names)
        self.current_epoch = 0
        self.global_step = 0
        self.callback_metrics: Dict[str, Any] = {}
        self.logged_metrics: Dict[str, Any] = {}
        self.sanity_checking = False
        self.should_stop = False  # settable by callbacks
        self.state = "idle"
        self.train_state: Optional[TrainState] = None

        self._module: Optional[TpuModule] = None
        self._datamodule: Optional[TpuDataModule] = None
        self._launcher = None

    # ------------------------------------------------------------------ #
    # properties
    # ------------------------------------------------------------------ #
    @property
    def global_rank(self) -> int:
        return self.strategy.global_rank

    @property
    def model(self) -> Optional[torch.nn.Module]:
        return None if self.train_state is None else self.train_state.model

    def block_until_ready(self) -> None:
        if self.strategy.root_device.type == "cuda":
            torch.cuda.synchronize(self.strategy.root_device)

    # ------------------------------------------------------------------ #
    # entry points
    # ------------------------------------------------------------------ #
    def fit(self, module: TpuModule,
            datamodule: Optional[TpuDataModule] = None,
            ckpt_path: Optional[str] = None) -> None:
        if ckpt_path is not None:
            raise _unported("fit(ckpt_path=) (checkpoint resume)", "T1")
        self.state = "fitting"
        output = self._launch(self._fit_worker, module, datamodule)
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

    def predict(self, module: TpuModule, datamodule=None, ckpt_path=None):
        raise _unported("Trainer.predict()", "T4")

    def _launch(self, fn, *args) -> WorkerOutput:
        if self._launcher is None:
            self._launcher = self.strategy.configure_launcher()
        return self._launcher.launch(fn, *args, trainer=self)

    def _run_evaluate(self, module, datamodule, ckpt_path,
                      stage: str) -> List[Dict[str, Any]]:
        if ckpt_path is not None:
            raise _unported(f"{stage}(ckpt_path=) (checkpoint restore)",
                            "T1")
        self.state = f"{stage[:-1] if stage.endswith('e') else stage}ing"
        output = self._launch(self._evaluate_worker, module, datamodule,
                              stage)
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
        """numpy/tensor leaves onto the strategy's device; floating leaves
        cast to bf16 under ``precision="bf16..."``."""
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

    def _setup_state(self, sample_batch: Any) -> TrainState:
        """Place and initialise the model, build its optimizer and the
        training and evaluation steps."""
        module = self._module
        device = self.strategy.root_device
        model = module.configure_model()
        if any(p.is_meta for p in model.parameters()):
            model = model.to_empty(device=device)
        else:
            model = model.to(device)
        init_gen, step_gen, self._eval_seed = self._seeds()
        module.init_variables(model, init_gen, self._to_device(sample_batch))
        factory, lr_schedule = self._optimizer()
        optimizer = factory(model.parameters())

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

        strategy = self.strategy
        self._train_step = strategy.make_train_step(
            loss_fn, log_grad_norm=self.track_grad_norm,
            gradient_clip_val=self.gradient_clip_val,
            accumulate_grad_batches=self.accumulate_grad_batches,
            lr_schedule=lr_schedule)
        self._val_step = strategy.make_eval_step(
            eval_fn_builder("validation_step"))
        self._test_step = strategy.make_eval_step(
            eval_fn_builder("test_step"))
        self.train_state = TrainState(step=0, model=model,
                                      optimizer=optimizer,
                                      generator=step_gen)
        return self.train_state

    # ------------------------------------------------------------------ #
    # fit loop
    # ------------------------------------------------------------------ #
    def _fit_worker(self, module: TpuModule,
                    datamodule: Optional[TpuDataModule]) -> WorkerOutput:
        self._attach(module, datamodule)
        self.should_stop = False
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
        state = self._setup_state(sample_batch)

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

        stop = False
        for epoch in range(self.max_epochs):
            self.current_epoch = epoch
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
            t0 = time.perf_counter()
            for batch_idx, batch in enumerate(
                    self._prefetch(train_loader, n_batches)):
                module.on_train_batch_start(batch, batch_idx)
                for cb in self.callbacks:
                    cb.on_train_batch_start(self, module, batch, batch_idx)
                module.on_before_optimizer_step(state.optimizer)
                for cb in self.callbacks:
                    cb.on_before_optimizer_step(self, module,
                                                state.optimizer)
                state, logs = self._train_step(state, batch)
                self.train_state = state
                self.global_step += 1
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
                        self._run_validation(val_loader, module)
                if 0 <= self.max_steps <= self.global_step:
                    stop = True
                    break
                if self.should_stop:
                    break

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
                self._run_validation(val_loader, module)

            module.on_train_epoch_end()
            for cb in self.callbacks:
                cb.on_train_epoch_end(self, module)
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
        return self._collect_results()

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
    # evaluate
    # ------------------------------------------------------------------ #
    def _evaluate_worker(self, module, datamodule,
                         stage: str) -> WorkerOutput:
        self._attach(module, datamodule)
        module.prepare_data()
        if datamodule is not None:
            datamodule.prepare_data()
            datamodule.setup(stage)
        module.setup(stage)
        loader_name = ("val_dataloader" if stage == "validate" else
                       "test_dataloader")
        loader = self._dataloader(loader_name)
        if loader is None:
            raise ValueError(f"No {loader_name} defined for {stage}")
        if self.train_state is None:
            sample, loader = self._peek_first_batch(loader)
            self._setup_state(sample)
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

    # ------------------------------------------------------------------ #
    # results (the worker <-> driver contract)
    # ------------------------------------------------------------------ #
    def _collect_results(self) -> WorkerOutput:
        return WorkerOutput(
            best_model_path=None, state_stream=None,
            trainer_state=dict(epoch=self.current_epoch,
                               global_step=self.global_step,
                               should_stop=self.should_stop),
            callback_metrics=dict(self.callback_metrics),
            logged_metrics=dict(self.logged_metrics),
            callback_states={type(cb).__name__: cb.state_dict()
                             for cb in self.callbacks})

    def _recover_results(self, output: WorkerOutput) -> None:
        """Progress counters, metrics and callback states back into the
        driver-side objects (the same objects in-process)."""
        self.current_epoch = output.trainer_state.get(
            "epoch", self.current_epoch)
        self.global_step = output.trainer_state.get(
            "global_step", self.global_step)
        self.should_stop = output.trainer_state.get(
            "should_stop", self.should_stop)
        self.callback_metrics.update(output.callback_metrics)
        self.logged_metrics.update(output.logged_metrics)
        for cb in self.callbacks:
            st = (output.callback_states or {}).get(type(cb).__name__)
            if st:
                cb.load_state_dict(st)
