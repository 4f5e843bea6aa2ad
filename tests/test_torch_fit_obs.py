"""The port's fit telemetry (``Trainer(telemetry=)``, ``StepStatsCallback``) against the JAX package.

- The nano GPT fit (flash attention, f32, SGD) writes, on the tick clock
  (``Telemetry(clock=None)``), the same JSONL event log as the JAX
  trainer's, line for line: ``launch.start``, ``worker.start``,
  ``fit.start``, ``epoch.start``/``epoch.end``, ``fit.end``,
  ``launch.done`` (as ``tests/test_obs.py``'s trainer cases drive it), a
  fit resumed from its own checkpoint (``fit.start`` with ``resumed``,
  the epochs from the saved one), and a fit with a ``StepStatsCallback``
  fed one injected clock sequence on both sides, whose
  ``train.straggler`` events and ``train_step_ms`` histogram agree too.
  The profiler's sections become the same ``profile_*_s`` gauge names.
- ``StepStatsCallback`` against JAX's, driven hook by hook with the same
  injected clock (``tests/test_obs.py``'s cases, merged as parameters):
  callback metrics, anomalies, events and instruments; token inference
  from a torch batch against JAX's from the numpy batch; the argument
  checks; ``block=True`` synchronizing through the trainer.
- Disarmed (``telemetry=None``, the default) a fit emits nothing, even
  into an activated global handle, and allocates no instrument.
"""
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import \
    ModelCheckpoint as JaxModelCheckpoint
from ray_lightning_tpu.models.gpt import GPTModule as JaxGPTModule
from ray_lightning_tpu.models.gpt import gpt2_config as jax_gpt2_config
from ray_lightning_tpu.obs import StepStatsCallback as JaxStepStats
from ray_lightning_tpu.obs import Telemetry as JaxTelemetry
from ray_lightning_tpu_torch import (BoringModel, GPTModule, ModelCheckpoint,
                                     RayStrategy, StepStatsCallback,
                                     Telemetry, Trainer, gpt2_config)
from ray_lightning_tpu_torch.interop import load_flax_params

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

NANO = dict(vocab_size=256, max_seq_len=32)
FIT = dict(max_epochs=2, limit_train_batches=3, limit_val_batches=1,
           seed=0, batch_size=4)
SGD_LR = 0.5


class _JaxNano(JaxGPTModule):
    def configure_optimizers(self):
        return optax.sgd(SGD_LR)


class _Nano(GPTModule):
    """The port's nano GPT from the JAX run's initial params, with SGD."""

    def __init__(self, init, **kw):
        super().__init__(**kw)
        self.init = init

    def init_variables(self, model, generator, batch):
        load_flax_params(model, self.init)

    def configure_optimizers(self):
        return lambda p: torch.optim.SGD(p, lr=SGD_LR)


def _clock(step_times, waits=0.002):
    """An injected clock: ``on_train_batch_start`` and ``_end`` read it
    in turn, so the k-th step takes ``step_times[k]`` and the wait
    before it ``waits`` (seconds)."""
    seq, t = [], 0.0
    for st in step_times:
        t += waits
        seq.append(t)
        t += st
        seq.append(t)
    it = iter(seq)
    return lambda: next(it)


STEP_TIMES = [0.010, 0.011, 0.010, 0.009, 0.010, 0.080]


def _fit(side, root, tel, init, stepstats=False, resume=False,
         profiler=None):
    """The nano fit on one side (``"jax"`` or ``"port"``), its event log
    under ``root``; ``resume``: a first fit of one epoch with a
    checkpoint, then the measured fit resumed from it."""
    fit = dict(FIT)
    bs = fit.pop("batch_size")
    ck = os.path.join(root, "ck")
    if side == "jax":
        cfg = jax_gpt2_config("nano", attention_impl="flash",
                              dtype=jnp.float32, **NANO)

        def trainer(telemetry, **kw):
            return JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                              default_root_dir=root, telemetry=telemetry,
                              **{**fit, **kw})
        module = lambda: _JaxNano(config=cfg, batch_size=bs)  # noqa: E731
        mc, ss = JaxModelCheckpoint, JaxStepStats
    else:
        cfg = gpt2_config("nano", attention_impl="flash",
                          dtype=torch.float32, **NANO)

        def trainer(telemetry, **kw):
            return Trainer(strategy=RayStrategy(device="cpu"),
                           default_root_dir=root, telemetry=telemetry,
                           **{**fit, **kw})
        module = lambda: _Nano(init, config=cfg,  # noqa: E731
                               batch_size=bs)
        mc, ss = ModelCheckpoint, StepStatsCallback
    callbacks = []
    if resume:
        trainer(None, max_epochs=1,
                callbacks=[mc(dirpath=ck)]).fit(module())
        callbacks.append(mc(dirpath=ck))
    if stepstats:
        callbacks.append(ss(tel, warmup_steps=3,
                            clock=_clock(STEP_TIMES)))
    t = trainer(tel, callbacks=callbacks, profiler=profiler)
    t.fit(module(), ckpt_path="auto" if resume else None)
    tel.flush()
    return t


@pytest.fixture(scope="module")
def jax_init():
    """The JAX nano fit's initial params (flax layout, numpy)."""
    import jax
    cfg = jax_gpt2_config("nano", attention_impl="flash",
                          dtype=jnp.float32, **NANO)
    mod = _JaxNano(config=cfg, batch_size=4)
    model = mod.configure_model()
    batch = next(iter(mod.train_dataloader()))
    params = model.init(jax.random.PRNGKey(0), batch[0])["params"]
    return jax.tree_util.tree_map(np.array, params)


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("case", ["plain", "resumed", "stepstats"])
def test_nano_fit_event_log_matches_jax_line_for_line(tmp_path, jax_init,
                                                      case):
    """The tick-clock JSONL logs of the two trainers are equal line for
    line (the JAX trainer's own initial params do not enter its log, so
    the port starting from them changes nothing there)."""
    logs, snaps = {}, {}
    for side, tel_cls in (("jax", JaxTelemetry), ("port", Telemetry)):
        root = str(tmp_path / side)
        path = os.path.join(root, "events.jsonl")
        tel = tel_cls(jsonl_path=path)
        t = _fit(side, root, tel, jax_init, stepstats=case == "stepstats",
                 resume=case == "resumed")
        assert t.global_step == 6
        logs[side] = _lines(path)
        snaps[side] = tel.metrics.snapshot()
    assert logs["port"] == logs["jax"]
    sites = [e["site"] for e in logs["port"]]
    assert sites[:3] == ["launch.start", "worker.start", "fit.start"]
    assert sites[-2:] == ["fit.end", "launch.done"]
    start = next(e for e in logs["port"] if e["site"] == "fit.start")
    assert start["payload"]["resumed"] == (case == "resumed")
    assert sites.count("epoch.start") == (1 if case == "resumed" else 2)
    if case == "stepstats":
        assert sites.count("train.straggler") == 1
        assert snaps["port"]["train_step_ms"] == snaps["jax"]["train_step_ms"]
        for name in ("train_step_anomalies_total", "train_tokens_per_sec",
                     "train_data_wait_frac"):
            assert snaps["port"][name] == pytest.approx(
                snaps["jax"][name], rel=1e-12), name


def test_profile_gauges_are_named_as_jax(tmp_path, jax_init):
    """``profiler="simple"``: each section becomes the JAX trainer's
    ``profile_<name>_s`` gauge (wall time, so only names and signs
    compare)."""
    names = {}
    for side, tel_cls in (("jax", JaxTelemetry), ("port", Telemetry)):
        tel = tel_cls()
        _fit(side, str(tmp_path / side), tel, jax_init, profiler="simple")
        snap = tel.metrics.snapshot()
        names[side] = sorted(k for k in snap if k.startswith("profile_"))
        assert all(snap[k] >= 0 for k in names[side])
    assert names["port"] == names["jax"]
    assert {"profile_train_step_s", "profile_get_train_batch_s",
            "profile_validation_s"} <= set(names["port"])


# ------------------------------------------------- StepStatsCallback
class _FakeTrainer:
    def __init__(self):
        self.callback_metrics = {}
        self.global_step = 0
        self.synced = 0

    def block_until_ready(self):
        self.synced += 1


def _drive(cb, trainer, step_times, waits=None, batch=None):
    """The JAX test's driver: the hooks of one epoch around the given
    step and wait times of the injected clock."""
    t = [0.0]
    cb._clock = lambda: t[0]
    waits = waits or [0.0] * len(step_times)
    cb.on_train_start(trainer, None)
    cb.on_train_epoch_start(trainer, None)
    for i, (wait, step) in enumerate(zip(waits, step_times)):
        t[0] += wait
        cb.on_train_batch_start(trainer, None, batch, i)
        t[0] += step
        trainer.global_step = i + 1
        cb.on_train_batch_end(trainer, None, {}, batch, i)


STEPSTATS_CASES = {
    # tests/test_obs.py's cases: 8 calm steps then a 100 ms straggler;
    # a spike inside the warmup; token rates from the batch and from a
    # tokens_fn; a tight threshold that flags a slow step and a fast one
    "straggler": (dict(warmup_steps=5, z_threshold=3.0),
                  [0.010, 0.011, 0.010, 0.009, 0.010, 0.011, 0.010, 0.010,
                   0.100], [0.002] * 9, True),
    "warmup": (dict(warmup_steps=5), [0.01, 0.01, 0.5, 0.01, 0.01], None,
               False),
    "tokens": (dict(warmup_steps=1), [0.5], None, True),
    "tokens_fn": (dict(tokens_fn=lambda b: 1000), [0.25], None, True),
    "two_sided": (dict(warmup_steps=2, z_threshold=1.0, ewma_alpha=0.5,
                       min_sigma_frac=0.0),
                  [0.02, 0.021, 0.02, 0.09, 0.001, 0.02], [0.001] * 6,
                  True),
}


@pytest.mark.parametrize("name", sorted(STEPSTATS_CASES))
def test_stepstats_matches_jax(name):
    """The same hooks at the same clock readings give the same
    callback metrics, anomalies, events and instruments; the port infers
    tokens from a torch batch as JAX does from the numpy one."""
    kw, times, waits, armed = STEPSTATS_CASES[name]
    batch = {"x": np.zeros((4, 16), np.float32),
             "y": np.zeros((4,), np.float32)}
    out = {}
    for side, cls, tel_cls in (("jax", JaxStepStats, JaxTelemetry),
                               ("port", StepStatsCallback, Telemetry)):
        tel = tel_cls() if armed else None
        cb = cls(tel, **kw)
        trainer = _FakeTrainer()
        b = batch if side == "jax" else {k: torch.from_numpy(v)
                                         for k, v in batch.items()}
        _drive(cb, trainer, times, waits, batch=b)
        out[side] = (cb, trainer, tel)
    (jcb, jtr, jtel), (pcb, ptr, ptel) = out["jax"], out["port"]
    assert ptr.callback_metrics == jtr.callback_metrics
    assert pcb.anomalies == jcb.anomalies
    assert pcb.state_dict() == jcb.state_dict()
    if armed:
        assert [(e.site, e.payload) for e in ptel.events()] == \
            [(e.site, e.payload) for e in jtel.events()]
        assert ptel.metrics.snapshot() == jtel.metrics.snapshot()
    if name == "straggler":
        assert pcb.anomalies == 1 and ptr.callback_metrics[
            "data_wait_frac"] == pytest.approx(0.002 / 0.102)
    if name == "tokens":
        assert ptr.callback_metrics["tokens_per_sec"] == 128.0


@pytest.mark.parametrize("kw,match", [
    (dict(ewma_alpha=0.0), "ewma_alpha"), (dict(ewma_alpha=1.5),
                                           "ewma_alpha"),
    (dict(z_threshold=0), "z_threshold"),
    (dict(min_sigma_frac=-1), "min_sigma_frac")])
def test_stepstats_refuses_what_jax_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        JaxStepStats(**kw)
    with pytest.raises(ValueError, match=match):
        StepStatsCallback(**kw)


def test_stepstats_block_synchronizes_through_the_trainer():
    """``block=True`` calls ``Trainer.block_until_ready`` once a step
    before the clock is read; the default never does."""
    for block, want in ((True, 3), (False, 0)):
        trainer = _FakeTrainer()
        _drive(StepStatsCallback(block=block), trainer, [0.01] * 3)
        assert trainer.synced == want
    # the real trainer's sync is a no-op on the CPU and a synchronize of
    # the rank's card otherwise
    t = Trainer(strategy=RayStrategy(device="cpu"))
    t.block_until_ready()


def test_stepstats_state_rides_the_checkpoint():
    """The anomaly count is the callback's checkpointed state, restored
    by ``load_state_dict`` (a missing count reads 0), as in JAX."""
    for state in ({"anomalies": 4}, {}):
        cbs = (JaxStepStats(), StepStatsCallback())
        for cb in cbs:
            cb.load_state_dict(state)
        assert cbs[1].state_dict() == cbs[0].state_dict() == {
            "anomalies": state.get("anomalies", 0)}


# ------------------------------------------------------- disarmed
def test_disarmed_fit_has_zero_surface(tmp_path):
    """No handle: the trainer holds none, and a fit emits nothing even
    into an activated global handle (the lifecycle events go only to
    the trainer's own)."""
    t = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=1,
                limit_train_batches=2, seed=0,
                default_root_dir=str(tmp_path))
    assert t.telemetry is None
    glob = Telemetry()
    with glob.activated():
        t.fit(BoringModel())
    assert glob.events() == []
    assert set(glob.metrics.snapshot()) == {"obs_events_dropped_total"}
