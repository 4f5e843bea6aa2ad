"""Picklable modules and callbacks for the port's multi-process tests.

A spawned worker unpickles the trainer and its module by import path, so
what it runs must live at module level in a module the worker can import
without jax: this one imports torch and the port only (the test files,
which import both packages, are never imported by a worker).
"""
import numpy as np
import torch
import torch.distributed as dist

from ray_lightning_tpu_torch import BoringModel, GPTModule, gpt2_config
from ray_lightning_tpu_torch.core import Callback
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.launchers import (ExecutorBase, ProcessRay,
                                               RayLauncher)

NANO = dict(vocab_size=256, max_seq_len=32)
SGD_LR = 0.5


def nano_cfg():
    return gpt2_config("nano", attention_impl="flash", dtype=torch.float32,
                       **NANO)


class Nano(GPTModule):
    """nano GPT on the flash path, started from a flax-layout tree of
    numpy arrays (the JAX trainer's initial params) when one is given,
    trained with SGD (``opt="sgd"``), SGD with momentum (``"momentum"``:
    optimizer state that moves linearly with the gradients) or the
    module's AdamW; ``schedule`` returns ``(factory, lr schedule)``."""

    def __init__(self, init=None, opt="adamw", schedule=False, **kw):
        super().__init__(config=nano_cfg(), **kw)
        self.init = init
        self.opt = opt
        self.schedule = schedule

    def init_variables(self, model, generator, batch):
        if self.init is None:
            return super().init_variables(model, generator, batch)
        load_flax_params(model, self.init)

    def configure_optimizers(self):
        if self.opt == "sgd":
            factory = lambda p: torch.optim.SGD(p, lr=SGD_LR)  # noqa: E731
        elif self.opt == "momentum":
            factory = lambda p: torch.optim.SGD(  # noqa: E731
                p, lr=0.1, momentum=0.9)
        else:
            factory = super().configure_optimizers()
        if self.schedule:
            return factory, lr_schedule
        return factory

    def predict_dataloader(self):
        return self.val_dataloader()

    def predict_step(self, model, batch, generator):
        return model(batch[0])


def lr_schedule(n):
    return 1e-2 / (1.0 + n)


class Poisoned(BoringModel):
    """BoringModel whose loss value turns NaN at its ``poison_at``-th
    training step on rank ``poison_rank`` alone (rank 0 in one process),
    its gradients left finite: only the verdict reduced over ranks makes
    the other ranks skip that update too."""

    def __init__(self, poison_at=2, poison_rank=1, **kw):
        super().__init__(**kw)
        self.poison_at = poison_at
        self.poison_rank = poison_rank
        self.steps = 0

    def training_step(self, model, batch, generator):
        loss = super().training_step(model, batch, generator)
        self.steps += 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        if self.steps == self.poison_at and rank == self.poison_rank:
            loss = loss + loss.detach() * float("nan")
        return loss


class Failing(BoringModel):
    """BoringModel whose rank ``fail_rank`` raises in its first step."""

    def __init__(self, fail_rank=1, **kw):
        super().__init__(**kw)
        self.fail_rank = fail_rank

    def training_step(self, model, batch, generator):
        if dist.get_rank() == self.fail_rank:
            raise ValueError(f"rank {self.fail_rank} failed on purpose")
        return super().training_step(model, batch, generator)


class LossRecorder(Callback):
    """Per-step losses, carried back to the driver as this callback's
    state (the worker -> driver channel for callback states)."""

    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch,
                           batch_idx):
        self.losses.append(float(outputs["loss"]))

    def state_dict(self):
        return {"losses": list(self.losses)}

    def load_state_dict(self, state):
        self.losses = list(state["losses"])


class SaveAt(Callback):
    """``trainer.save_checkpoint(path, ...)`` after global step ``step``,
    on every rank (a collective under a process group)."""

    def __init__(self, step, path, save_format="stream", async_save=False):
        self.step = step
        self.path = path
        self.save_format = save_format
        self.async_save = async_save

    def on_train_batch_end(self, trainer, module, outputs, batch,
                           batch_idx):
        if trainer.global_step == self.step:
            trainer.save_checkpoint(self.path, save_format=self.save_format,
                                    async_save=self.async_save)


class OptStateBytes(Callback):
    """Each rank's ``opt_state_bytes`` and the world's sum, into
    ``callback_metrics`` (rank 0's reach the driver)."""

    def on_train_end(self, trainer, module):
        from ray_lightning_tpu_torch.core.optim import opt_state_bytes
        mine = opt_state_bytes(trainer.train_state.optimizer)
        t = torch.tensor([float(mine)])
        if dist.is_initialized():
            dist.all_reduce(t)
        trainer.callback_metrics["opt_state_bytes"] = float(mine)
        trainer.callback_metrics["opt_state_bytes_world"] = float(t)


class World:
    """Two spawned worker processes, made on first use and reused by
    every fit of a test file (``RayLauncher(workers=)``); a failed launch
    kills them, and the next fit spawns a fresh pair."""

    def __init__(self):
        self.ray = ProcessRay(num_threads=1)
        self.ray.init()
        self.workers = []

    def launcher(self, strategy):
        if not self.workers or any(w._killed for w in self.workers):
            self.workers = [self.ray.remote(ExecutorBase).remote()
                            for _ in range(2)]
        return RayLauncher(strategy, ray_module=self.ray,
                           workers=self.workers)

    def run(self, trainer, stage, *args, **kwargs):
        """``trainer.<stage>(*args, **kwargs)`` on this world's workers.

        The launcher probes the rendezvous port on worker 0, and rank 0's
        store binds it a moment later; a world of another test file
        running beside this one (``pytest -n``) may take the port in
        between. Rank 0 then fails at once with EADDRINUSE, the failed
        launch kills the pair, and the stage runs once more, on a fresh
        pair and a fresh port. Any other failure raises."""
        for attempt in range(2):
            trainer._launcher = self.launcher(trainer.strategy)
            try:
                return getattr(trainer, stage)(*args, **kwargs)
            except Exception as exc:
                if attempt or "EADDRINUSE" not in str(exc):
                    raise


def host(tree):
    """A state dict's tensors as numpy arrays, by name."""
    return {k: np.asarray(v.detach().cpu()) for k, v in tree.items()}


class TwoArgError(Exception):
    """An exception whose ``__init__`` pickle cannot call (it passes only
    the message): it pickles in the worker but does not unpickle."""

    def __init__(self, what, why):
        super().__init__(f"{what}: {why}")


def raise_two_arg_error():
    raise TwoArgError("worker", "failed")
