"""The port's ``FitSupervisor`` against the JAX package's.

``tests/test_reliability.py``'s supervisor cases on both packages, the
nano GPT fit (flash attention, f32, SGD, the port started from the JAX
run's initial params) and ``BoringModel``:

- one injected ``train.step`` crash: attempt 1 dies, attempt 2 resumes
  from the epoch-end checkpoint (``ckpt_path="auto"``) and finishes;
  attempts, the failures each hook saw and the final params equal the
  JAX supervisor's (params at 1e-5, f32) and the port's own
  uninterrupted fit bitwise; the module given as a factory and as an
  instance (deep-copied per attempt, the caller's never touched);
- a module that cannot be deep-copied is reused, with one warning;
- a plan that crashes every attempt exhausts the policy with
  ``RetriesExhausted`` after the same number of attempts as JAX;
- the subclass hooks ``_prepare_trainer``, ``_on_retry`` and
  ``_record_failure`` fire where JAX's do.
"""
import logging
import os
import threading

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import \
    ModelCheckpoint as JaxModelCheckpoint
from ray_lightning_tpu.models import BoringModel as JaxBoringModel
from ray_lightning_tpu.models.gpt import GPTModule as JaxGPTModule
from ray_lightning_tpu.models.gpt import gpt2_config as jax_gpt2_config
from ray_lightning_tpu.reliability import FaultPlan as JaxFaultPlan
from ray_lightning_tpu.reliability import FitSupervisor as JaxFitSupervisor
from ray_lightning_tpu.reliability import \
    RetriesExhausted as JaxRetriesExhausted
from ray_lightning_tpu.reliability import RetryPolicy as JaxRetryPolicy
from ray_lightning_tpu_torch import (BoringModel, GPTModule, ModelCheckpoint,
                                     RayStrategy, Trainer, gpt2_config)
from ray_lightning_tpu_torch.interop import flax_state_dict, load_flax_params
from ray_lightning_tpu_torch.reliability import (FaultPlan, FitSupervisor,
                                                 RetriesExhausted,
                                                 RetryPolicy)

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

NANO = dict(vocab_size=256, max_seq_len=32)
FIT = dict(max_epochs=3, limit_train_batches=4, limit_val_batches=0, seed=0)
SGD_LR = 0.5


class _JaxNano(JaxGPTModule):
    def configure_optimizers(self):
        return optax.sgd(SGD_LR)


class _Nano(GPTModule):
    def __init__(self, init, **kw):
        super().__init__(**kw)
        self.init = init

    def init_variables(self, model, generator, batch):
        load_flax_params(model, self.init)

    def configure_optimizers(self):
        return lambda p: torch.optim.SGD(p, lr=SGD_LR)


class _JaxPoisoning(JaxBoringModel):
    def on_train_start(self):
        if getattr(self, "poisoned", False):
            raise RuntimeError("poisoned module state leaked into retry")
        self.poisoned = True


class _Poisoning(BoringModel):
    """Mutates itself during an attempt, as a crashed module can be
    left half-configured."""

    def on_train_start(self):
        if getattr(self, "poisoned", False):
            raise RuntimeError("poisoned module state leaked into retry")
        self.poisoned = True


class _Uncopyable(BoringModel):
    def __init__(self):
        super().__init__()
        self.lock = threading.Lock()   # deepcopy refuses a lock


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """The JAX trainer's initial nano params (a fit of no epoch)."""
    t = JaxTrainer(strategy=JaxRayStrategy(num_workers=1), max_epochs=0,
                   limit_train_batches=4, seed=0,
                   default_root_dir=str(tmp_path_factory.mktemp("init")))
    t.fit(_modules("nano", "jax", None)())
    return jax.tree_util.tree_map(np.array, t.train_state.params)


def _modules(kind, side, init):
    """A zero-argument factory of the case's module on one side."""
    if kind == "nano":
        if side == "jax":
            cfg = jax_gpt2_config("nano", attention_impl="flash",
                                  dtype=jnp.float32, **NANO)
            return lambda: _JaxNano(config=cfg, batch_size=4)
        cfg = gpt2_config("nano", attention_impl="flash",
                          dtype=torch.float32, **NANO)
        return lambda: _Nano(init, config=cfg, batch_size=4)
    if kind == "poisoning":
        return _JaxPoisoning if side == "jax" else _Poisoning
    return JaxBoringModel if side == "jax" else BoringModel


class _Recording:
    """Records the subclass hooks' calls (either package's base)."""

    def __init__(self, base, *a, **kw):
        self.calls = []
        outer = self

        class Sup(base):
            def _prepare_trainer(self, trainer):
                outer.calls.append(("prepare", self.attempts))
                return super()._prepare_trainer(trainer)

            def _on_retry(self, attempt):
                outer.calls.append(("retry", attempt))

            def _record_failure(self, exc):
                outer.calls.append(("failure", type(exc).__name__))

        self.sup = Sup(*a, **kw)


def _supervised(side, root, module, ticks, attempts=3):
    ck = os.path.join(root, "ck")
    if side == "jax":
        def make_trainer():
            return JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                              default_root_dir=root,
                              callbacks=[JaxModelCheckpoint(dirpath=ck)],
                              **FIT)
        base, policy, plan = JaxFitSupervisor, JaxRetryPolicy, JaxFaultPlan
    else:
        def make_trainer():
            return Trainer(strategy=RayStrategy(device="cpu"),
                           default_root_dir=root,
                           callbacks=[ModelCheckpoint(dirpath=ck)], **FIT)
        base, policy, plan = FitSupervisor, RetryPolicy, FaultPlan
    rec = _Recording(base, make_trainer,
                     policy(max_attempts=attempts, base_delay=0.0),
                     sleep=lambda s: None)
    with plan.at("train.step", ticks).armed():
        trainer = rec.sup.fit(module)
    return trainer, rec


def _final(side, trainer):
    if side == "jax":
        params = jax.tree_util.tree_map(np.array, trainer.train_state.params)
        return flax_state_dict(params) if "Dense_0" not in params \
            else params
    return {k: v.detach().numpy() for k, v in
            trainer.model.state_dict().items()}


@pytest.mark.parametrize("kind,as_instance", [
    ("nano", False), ("nano", True), ("boring", False),
    ("poisoning", True)])
def test_supervised_fit_matches_jax(tmp_path, jax_init, kind, as_instance):
    """One ``train.step`` crash at tick 5: two attempts on both sides,
    the same hook calls, the final params equal to JAX's at 1e-5 and
    to the port's uninterrupted fit bitwise; an instance is fitted as a
    deep copy per attempt and is never touched itself."""
    out = {}
    for side in ("jax", "port"):
        factory = _modules(kind, side, jax_init)
        module = factory() if as_instance else factory
        trainer, rec = _supervised(side, str(tmp_path / side), module, [5])
        assert trainer.state == "finished" and trainer.global_step == 12
        if as_instance:
            assert not getattr(module, "poisoned", False)
            assert getattr(module, "trainer", None) is None
        out[side] = (rec.sup.attempts, rec.calls, _final(side, trainer))
    (ja, jcalls, jfinal), (pa, pcalls, pfinal) = out["jax"], out["port"]
    assert pa == ja == 2
    assert pcalls == jcalls == [("prepare", 1), ("failure", "InjectedFault"),
                                ("retry", 2), ("prepare", 2)]
    if kind == "nano":
        assert pfinal.keys() == jfinal.keys()
        for name, want in jfinal.items():
            np.testing.assert_allclose(pfinal[name], want, atol=1e-5,
                                       rtol=0, err_msg=name)
    if kind != "poisoning":
        ref = Trainer(strategy=RayStrategy(device="cpu"),
                      default_root_dir=str(tmp_path / "ref"), **FIT)
        ref.fit(_modules(kind, "port", jax_init)())
        for name, t in ref.model.state_dict().items():
            assert torch.equal(torch.from_numpy(pfinal[name]), t), name


def test_boring_final_params_match_jax(tmp_path):
    """The boring case's supervised params against JAX's, the port
    started from the JAX trainer's initial params (at 1e-5)."""
    start = JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                       default_root_dir=str(tmp_path / "init"),
                       max_epochs=0, limit_train_batches=4, seed=0)
    start.fit(JaxBoringModel())      # no epoch: the initial params
    dense = jax.tree_util.tree_map(np.array,
                                   start.train_state.params)["Dense_0"]
    init = {"weight": torch.from_numpy(dense["kernel"].T.copy()),
            "bias": torch.from_numpy(dense["bias"].copy())}

    class Same(BoringModel):
        def init_variables(self, model, generator, batch):
            model.load_state_dict(init)

    jt, _ = _supervised("jax", str(tmp_path / "jax"), JaxBoringModel, [5])
    pt, _ = _supervised("port", str(tmp_path / "port"), Same, [5])
    want = jax.tree_util.tree_map(np.array, jt.train_state.params)
    got = pt.model.state_dict()
    np.testing.assert_allclose(got["weight"].numpy(),
                               want["Dense_0"]["kernel"].T, atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got["bias"].numpy(), want["Dense_0"]["bias"],
                               atol=1e-5, rtol=0)


def test_exhaustion_matches_jax(tmp_path):
    """A crash in every attempt: ``RetriesExhausted`` after the policy's
    attempts on both sides."""
    for side, exc in (("jax", JaxRetriesExhausted),
                      ("port", RetriesExhausted)):
        module = _modules("boring", side, None)
        with pytest.raises(exc) as ei:
            _supervised(side, str(tmp_path / side), module,
                        list(range(0, 200)), attempts=2)
        assert ei.value.attempts == 2


def test_uncopyable_module_is_reused_with_one_warning(tmp_path, caplog):
    """A module deepcopy refuses is fitted as-is on every attempt, with
    one logged warning (the JAX rule); the fit still finishes."""
    module = _Uncopyable()
    with caplog.at_level(logging.WARNING,
                         logger="ray_lightning_tpu_torch.reliability"):
        trainer, rec = _supervised("port", str(tmp_path), module, [5])
    assert rec.sup.attempts == 2 and trainer.state == "finished"
    warned = [r for r in caplog.records
              if "supervisor.module_copy" in r.getMessage()]
    assert len(warned) == 1
