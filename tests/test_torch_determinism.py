"""The port's determinism check (``testing/determinism.py``), mirroring the JAX package's test.

Same-seed fits are bit-identical (BoringModel, and MNIST through the
trainer); a module that leaks unseeded host randomness into its data is
caught with the JAX package's diagnostic; an unseeded trainer is refused;
the fingerprint of a fit through the launcher (an in-process world of
one, whose final state comes back as ``train_state_dict``) equals the
local fit's, parameter for parameter in ``named_parameters()`` order.
"""
import os

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (BoringModel, LightningMNISTClassifier,
                                     RayStrategy, Trainer,
                                     assert_deterministic, fit_fingerprint)
from ray_lightning_tpu_torch.launchers import RayLauncher
from ray_lightning_tpu_torch.launchers.utils import set_executable_cls
from ray_lightning_tpu_torch.testing import FakeRay, RecordingExecutor

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port


def _trainer(tmp_path, seed=7, steps=3):
    return Trainer(strategy=RayStrategy(device="cpu"), max_epochs=1,
                   limit_train_batches=steps, limit_val_batches=0,
                   enable_checkpointing=False, seed=seed,
                   default_root_dir=str(tmp_path))


class LeakyModel(BoringModel):
    def _data(self):
        # unseeded: different data every run -- the leak the check exists
        # to catch
        return np.random.default_rng(
            int.from_bytes(os.urandom(4), "little")).standard_normal(
            (self.num_samples, 32)).astype(np.float32)


def test_assert_deterministic_passes_and_catches_leaks(tmp_path):
    fp = assert_deterministic(BoringModel, lambda: _trainer(tmp_path))
    assert fp.dtype == np.float64 and fp.size == 32 * 2 + 2
    with pytest.raises(AssertionError, match="same-seed fits diverged"):
        assert_deterministic(LeakyModel, lambda: _trainer(tmp_path))
    with pytest.raises(ValueError, match="seed"):
        assert_deterministic(BoringModel,
                             lambda: _trainer(tmp_path, seed=None))


def test_a_tolerance_compares_by_allclose(tmp_path):
    """A nonzero tolerance still fails a real divergence, through
    ``np.testing.assert_allclose``."""
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        assert_deterministic(LeakyModel, lambda: _trainer(tmp_path),
                             rtol=1e-9)


def test_mnist_fits_are_deterministic(tmp_path):
    """The MLP's seeded fit repeats bitwise, and the fingerprint is its
    parameters in ``named_parameters()`` order."""
    def module():
        return LightningMNISTClassifier(config={"batch_size": 16},
                                        num_samples=128)

    fp = assert_deterministic(module, lambda: _trainer(tmp_path, steps=5))
    trainer = _trainer(tmp_path, steps=5)
    trainer.fit(module())
    want = np.concatenate([p.detach().double().numpy().ravel()
                           for _, p in trainer.model.named_parameters()])
    assert np.array_equal(fp, want) and fp.size == 784 * 128 + 128 + \
        128 * 256 + 256 + 256 * 10 + 10


def test_fingerprint_of_a_remote_fit(tmp_path):
    """Through the launcher (an in-process world of one) the driver holds
    no live model: the fingerprint reads ``train_state_dict``."""
    local = _trainer(tmp_path)
    local.fit(BoringModel())
    RecordingExecutor.instances = []
    set_executable_cls(RecordingExecutor)
    try:
        strategy = RayStrategy(num_workers=1, device="cpu")
        remote = Trainer(strategy=strategy, max_epochs=1,
                         limit_train_batches=3, limit_val_batches=0,
                         enable_checkpointing=False, seed=7,
                         default_root_dir=str(tmp_path))
        remote._launcher = RayLauncher(strategy, ray_module=FakeRay())
        remote.fit(BoringModel())
    finally:
        set_executable_cls(None)
    assert remote.train_state is None
    assert np.array_equal(fit_fingerprint(remote), fit_fingerprint(local))


def test_fingerprint_needs_a_fit(tmp_path):
    with pytest.raises(ValueError, match="fit first"):
        fit_fingerprint(_trainer(tmp_path))
