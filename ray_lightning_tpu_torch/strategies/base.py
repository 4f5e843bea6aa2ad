"""Strategy base class (counterpart of ``ray_lightning_tpu/strategies/base.py``).

This slice runs one process on one device: ranks are 0 and the world
size is 1, ``configure_launcher()`` returns the in-process
:class:`~ray_lightning_tpu_torch.launchers.local.LocalLauncher`, and the
strategy is the seat of the training step (:meth:`Strategy.make_train_step`)
and the evaluation step. Data parallelism (``num_workers > 1``), Ray
(``use_ray=True``), gang supervision (``gang=``), warm standbys
(``standby=``) and the per-worker resource arguments raise
``NotImplementedError``: they come with ``ROADMAP.md`` T6.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_lightning_tpu_torch.core.optim import (clip_by_global_norm_,
                                                global_norm)
from ray_lightning_tpu_torch.core.train_state import TrainState
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.launchers.local import LocalLauncher

_DDP_ITEM = "ROADMAP.md T6, data parallel"


class Strategy:
    strategy_name = "base"

    def __init__(self,
                 num_workers: int = 1,
                 num_cpus_per_worker: int = 1,
                 use_gpu: bool = False,
                 use_tpu: Optional[bool] = None,
                 init_hook: Optional[Callable] = None,
                 resources_per_worker: Optional[Dict] = None,
                 worker_runtime_env: Optional[Dict] = None,
                 use_ray: Optional[bool] = None,
                 allow_colocated_workers: bool = False,
                 gang: Optional[Any] = None,
                 standby: Optional[Any] = None,
                 device=None,
                 **kwargs: Any):
        """``device=None`` means ``"cuda"`` and raises ``RuntimeError``
        without a card; pass ``device="cpu"`` to train on the CPU."""
        unported = {
            "num_workers": int(num_workers) != 1,
            "num_cpus_per_worker": num_cpus_per_worker != 1,
            "use_gpu": bool(use_gpu), "use_tpu": use_tpu is not None,
            "resources_per_worker": bool(resources_per_worker),
            "worker_runtime_env": bool(worker_runtime_env),
            "use_ray": bool(use_ray),
            "allow_colocated_workers": bool(allow_colocated_workers),
            "gang": gang is not None, "standby": standby is not None,
        }
        unported.update(dict.fromkeys(kwargs, True))
        bad = sorted(k for k, v in unported.items() if v)
        if bad:
            raise NotImplementedError(
                f"{type(self).__name__}({', '.join(bad)}=...) is not ported "
                f"yet: this slice runs one process on one device "
                f"({_DDP_ITEM})")
        self.num_workers = 1
        self.init_hook = init_hook
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ #
    # launcher and rank model (one process, rank 0)
    # ------------------------------------------------------------------ #
    def configure_launcher(self) -> LocalLauncher:
        return LocalLauncher(self)

    @property
    def world_size(self) -> int:
        return 1

    @property
    def global_rank(self) -> int:
        return 0

    @property
    def root_device(self) -> torch.device:
        return self.device

    def teardown(self) -> None:
        """Nothing to release in one process."""

    # ------------------------------------------------------------------ #
    # steps
    # ------------------------------------------------------------------ #
    def make_train_step(self, loss_fn: Callable, *,
                        log_grad_norm: bool = False,
                        gradient_clip_val: Optional[float] = None,
                        accumulate_grad_batches: int = 1,
                        lr_schedule: Optional[Callable] = None
                        ) -> Callable[[TrainState, Any],
                                      Tuple[TrainState, Dict[str, Any]]]:
        """The training step: ``state, logs = step(state, batch)``.

        ``loss_fn(model, batch, generator) -> (loss, logs)``. The step runs
        forward and loss, ``backward``, logs the batch's global gradient
        norm (``log_grad_norm``), then follows optax's ``MultiSteps(chain(
        clip_by_global_norm, tx), k)``: the gradients of k batches are
        averaged (running mean, as optax's ``use_grad_mean``) and the
        optimizer steps on every k-th batch, after clipping the mean with
        optax's rule. ``lr_schedule(n)`` sets the learning rate of the
        n-th update. Returns ``{"loss": ..., **logs}`` as device tensors.
        """
        k = int(accumulate_grad_batches)
        if k < 1:
            raise ValueError(f"accumulate_grad_batches must be >= 1, got {k}")
        acc: List[torch.Tensor] = []
        updates = 0

        def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
            nonlocal acc, updates
            model, opt = state.model, state.optimizer
            params = [p for g in opt.param_groups for p in g["params"]]
            model.train()
            for p in params:
                p.grad = None
            loss, logs = loss_fn(model, batch, state.generator)
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if log_grad_norm:
                logs = {**logs, "grad_norm": global_norm(grads).detach()}
            mini = state.step % k
            if k > 1:
                if not acc:
                    acc = [torch.zeros_like(g) for g in grads]
                with torch.no_grad():
                    for a, g in zip(acc, grads):
                        a.add_((g - a) / (mini + 1))
                grads = acc
            if mini == k - 1:
                if gradient_clip_val:
                    clip_by_global_norm_(grads, gradient_clip_val)
                for p, g in zip(params, grads):
                    p.grad = g
                if lr_schedule is not None:
                    for group in opt.param_groups:
                        group["lr"] = float(lr_schedule(updates))
                opt.step()
                updates += 1
                for p in params:
                    p.grad = None
                if k > 1:
                    acc = []
            state.step += 1
            return state, {"loss": loss.detach(), **logs}

        return step

    def make_eval_step(self, eval_fn: Callable) -> Callable:
        """The evaluation step: ``logs = eval_step(state, batch,
        generator)``, without gradients."""

        def step(state: TrainState, batch, generator) -> Dict[str, Any]:
            state.model.eval()
            with torch.no_grad():
                return eval_fn(state.model, batch, generator)

        return step
