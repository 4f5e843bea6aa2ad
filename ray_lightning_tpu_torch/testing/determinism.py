"""Determinism checking (counterpart of ``ray_lightning_tpu/testing/determinism.py``).

The reference's closest thing to a race detector is its deterministic
seed plumbing; this turns it into an assertion users run against their
own modules: two fits from the same seed must end with the same
parameters. Fixed shapes on one card run the same kernels in the same
order, so same-seed same-params is the expected contract there too; a
failure means host-side state leaked into the step (an unseeded numpy
or Python generator, a time-dependent data order, a stateful module).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np


def fit_fingerprint(trainer) -> np.ndarray:
    """A flat float64 host digest of the trainer's final parameters, in
    ``named_parameters()`` order: from the live model (an in-process fit)
    or from the state a remote fit leaves on the driver
    (``trainer.train_state_dict["params"]``)."""
    if trainer.train_state is not None:
        leaves = [p for _, p in trainer.model.named_parameters()]
    elif getattr(trainer, "train_state_dict", None) is not None:
        leaves = list(trainer.train_state_dict["params"].values())
    else:
        raise ValueError("trainer holds no trained state — fit first")
    return np.concatenate([
        np.ravel(x.detach().cpu().double().numpy()) for x in leaves])


def assert_deterministic(module_factory: Callable[[], Any],
                         trainer_factory: Callable[[], Any],
                         rtol: float = 0.0, atol: float = 0.0,
                         datamodule_factory: Optional[Callable] = None
                         ) -> np.ndarray:
    """Fit twice from fresh modules and trainers; assert identical params.

    The factories must build the run from scratch (a reused module or
    trainer would share state and defeat the check). The default
    tolerance is EXACT (rtol = atol = 0): the same seed, device and
    kernels give bit-identical parameters; loosen it only to compare
    across layouts. Returns the fingerprint so callers can also compare
    across configurations.
    """
    prints = []
    for _ in range(2):
        trainer = trainer_factory()
        if trainer.seed is None:
            raise ValueError(
                "assert_deterministic needs Trainer(seed=...) — an "
                "unseeded run is allowed to differ from itself")
        dm = datamodule_factory() if datamodule_factory else None
        trainer.fit(module_factory(), datamodule=dm)
        prints.append(fit_fingerprint(trainer))
    if rtol == 0.0 and atol == 0.0:
        if prints[0].shape != prints[1].shape:
            raise AssertionError(
                f"two same-seed fits diverged: parameter count changed "
                f"({prints[0].size} vs {prints[1].size} elements) — the "
                "model shape itself depends on host state (e.g. a "
                "feature dim read from unseeded data)")
        # equal_nan: identical NaN patterns ARE deterministic (a NaN loss
        # is a training problem, not a determinism failure)
        if not np.array_equal(prints[0], prints[1], equal_nan=True):
            diff = np.abs(prints[0] - prints[1])
            raise AssertionError(
                f"two same-seed fits diverged: "
                f"max|Δ|={np.nanmax(diff):.3e} "
                f"over {int(np.count_nonzero(diff))}/{diff.size} "
                "elements — host-side state is leaking into training "
                "(unseeded RNG, order-dependent data loading, or "
                "stateful module attributes)")
    else:
        np.testing.assert_allclose(prints[0], prints[1], rtol=rtol,
                                   atol=atol)
    return prints[0]
