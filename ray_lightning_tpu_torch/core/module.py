"""User-facing module contract (counterpart of ``ray_lightning_tpu/core/module.py``).

The names stay the JAX package's, so user code moves over by changing its
import; the contract follows PyTorch, where a module holds its
parameters:

- ``configure_model()`` returns an ``nn.Module`` (build it on
  ``device="meta"`` to let the trainer place it: the trainer moves it to
  the strategy's device and then calls ``init_variables``).
- ``configure_optimizers()`` returns an *optimizer factory*: a callable
  from the model's parameters to a ``torch.optim.Optimizer`` (the
  counterpart of an optax transform, which exists before it sees the
  params), or ``(factory, schedule)`` where ``schedule(n)`` is the
  learning rate of the n-th optimizer update.
- ``init_variables(model, generator, batch)`` initialises the placed
  model in place from a ``torch.Generator``; by default it calls
  ``model.reset_parameters(generator)``. It is also the seam to load
  weights made elsewhere.
- ``training_step(model, batch, generator)`` returns a scalar loss or
  ``(loss, logs)``; ``validation_step``/``test_step(model, batch,
  generator)`` return a dict of metric scalars. JAX's ``variables``
  argument is gone: the model holds its parameters.
- ``predict_step(model, batch, generator)`` returns what
  ``Trainer.predict`` collects (default: ``model(batch)``).
- ``self.log(name, value)`` keeps the device tensor; the trainer reduces
  every logged value once per epoch, not per step.
- ``on_save_checkpoint(checkpoint)`` / ``on_load_checkpoint(checkpoint)``
  put the module's own state into a checkpoint's ``module`` entry and
  read it back.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional


class _LogBuffer:
    """Metrics logged during one step, drained by the trainer."""

    def __init__(self):
        self._buf: Dict[str, Any] = {}

    def log(self, name: str, value: Any) -> None:
        self._buf[name] = value

    def drain(self) -> Dict[str, Any]:
        buf, self._buf = self._buf, {}
        return buf


class TpuModule:
    """Base class for user models. See the module docstring."""

    def __init__(self):
        self.trainer = None  # set by Trainer.fit
        self._log_buffer = _LogBuffer()

    # ------------------------------------------------------------------ #
    # configuration (called once per fit)
    # ------------------------------------------------------------------ #
    def configure_model(self):
        """Return the ``nn.Module``."""
        raise NotImplementedError

    def configure_optimizers(self):
        """Return an optimizer factory (default: Adam 1e-3, eps 1e-8)."""
        import torch
        return lambda params: torch.optim.Adam(params, lr=1e-3, eps=1e-8)

    def init_variables(self, model, generator, batch) -> None:
        """Initialise ``model`` in place from ``generator`` (a CPU
        ``torch.Generator`` seeded from ``Trainer(seed=)``); ``batch`` is
        the first training batch on the device."""
        del batch
        model.reset_parameters(generator)

    def setup(self, stage: str) -> None:
        """Called before model construction."""

    def teardown(self, stage: str) -> None:
        """Called after the stage completes."""

    def prepare_data(self) -> None:
        """Host-side data preparation, once per process before fitting."""

    # ------------------------------------------------------------------ #
    # steps
    # ------------------------------------------------------------------ #
    def training_step(self, model, batch, generator):
        """Return a scalar loss or ``(loss, logs)``."""
        raise NotImplementedError

    def validation_step(self, model, batch, generator) -> Dict[str, Any]:
        """Return a dict of metric scalars (or use ``self.log``)."""
        return {}

    def test_step(self, model, batch, generator) -> Dict[str, Any]:
        return self.validation_step(model, batch, generator)

    def predict_step(self, model, batch, generator):
        """What ``Trainer.predict`` collects for one batch (run under
        ``torch.no_grad`` with the model in eval mode)."""
        return model(batch)

    # ------------------------------------------------------------------ #
    # logging
    # ------------------------------------------------------------------ #
    def log(self, name: str, value: Any, on_step: bool = False,
            on_epoch: bool = True, prog_bar: bool = False,
            sync_dist: bool = True) -> None:
        """Log a metric from a step; it is reduced over the epoch.
        ``on_step``, ``on_epoch``, ``prog_bar`` and ``sync_dist`` are
        accepted for API parity: one process computes every metric on the
        whole batch, and the epoch mean is what the trainer keeps."""
        del on_step, on_epoch, prog_bar, sync_dist
        self._log_buffer.log(name, value)

    # ------------------------------------------------------------------ #
    # data
    # ------------------------------------------------------------------ #
    def train_dataloader(self) -> Iterable:
        raise NotImplementedError

    def val_dataloader(self) -> Optional[Iterable]:
        return None

    def test_dataloader(self) -> Optional[Iterable]:
        return None

    def predict_dataloader(self) -> Optional[Iterable]:
        return None

    # ------------------------------------------------------------------ #
    # hooks
    # ------------------------------------------------------------------ #
    def on_fit_start(self) -> None: ...
    def on_fit_end(self) -> None: ...
    def on_train_start(self) -> None: ...
    def on_train_end(self) -> None: ...
    def on_train_epoch_start(self) -> None: ...
    def on_train_epoch_end(self) -> None: ...
    def on_validation_epoch_start(self) -> None: ...
    def on_validation_epoch_end(self) -> None: ...
    def on_train_batch_start(self, batch, batch_idx: int) -> None: ...
    def on_train_batch_end(self, outputs, batch, batch_idx: int) -> None: ...
    def on_validation_batch_start(self, batch, batch_idx: int) -> None: ...
    def on_validation_batch_end(self, outputs, batch,
                                batch_idx: int) -> None: ...
    def on_before_optimizer_step(self, optimizer) -> None:
        """Per training batch, before the step (the optimizer exists from
        the first batch on)."""
        ...

    # checkpointable custom state: written into / read from the
    # checkpoint's "module" entry
    def on_save_checkpoint(self, checkpoint: Dict[str, Any]) -> None: ...
    def on_load_checkpoint(self, checkpoint: Dict[str, Any]) -> None: ...


class TpuDataModule:
    """Datamodule: the loaders, apart from the model."""

    def prepare_data(self) -> None: ...

    def setup(self, stage: str) -> None: ...

    def train_dataloader(self) -> Iterable:
        raise NotImplementedError

    def val_dataloader(self) -> Optional[Iterable]:
        return None

    def test_dataloader(self) -> Optional[Iterable]:
        return None

    def predict_dataloader(self) -> Optional[Iterable]:
        return None
