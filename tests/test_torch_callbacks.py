"""The port's callbacks, logger and profilers against the JAX package.

Each case runs the same ``BoringModel`` fit in both trainers -- the
port's started from the JAX run's initial params -- and compares what
the JAX package's own tests (``tests/test_loggers_checkpoint.py``)
check:

- ``ModelCheckpoint``: the files on disk, ``best_model_path``,
  ``best_model_score`` (1e-5), top-k pruning and ``last``, both modes;
- ``EarlyStopping``: the epoch and step it stops at;
- ``EMAWeightAveraging``: the average after N steps at 1e-6; evaluation
  with the averaged weights swapped in and the raw ones back after; the
  average riding a checkpoint into a resumed fit;
- ``LearningRateMonitor``: the recorded rates under a schedule (and with
  gradient accumulation) at rtol 1e-6, the final params at 1e-5;
- ``CSVLogger``: header and rows (metrics at 1e-5), versions, non-numeric
  values skipped;
- ``SimpleProfiler``: the section names and their call counts;
- ``TorchProfilerCallback`` (the counterpart of ``JaxProfilerCallback``):
  a trace written, a window past the run's end closed, a run resumed past
  ``start_step`` profiled once;
- ``Trainer.predict``: the outputs at 1e-5, ``limit_predict_batches``
  and the predict hooks.
"""
import csv
import os
import types

import numpy as np
import optax
import pytest
import torch

import jax
from ray_lightning_tpu import EarlyStopping as JaxEarlyStopping
from ray_lightning_tpu import EMAWeightAveraging as JaxEMA
from ray_lightning_tpu import ModelCheckpoint as JaxModelCheckpoint
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import LambdaCallback as JaxLambda
from ray_lightning_tpu.core.callbacks import \
    LearningRateMonitor as JaxLRMonitor
from ray_lightning_tpu.core.loggers import CSVLogger as JaxCSVLogger
from ray_lightning_tpu.models import BoringModel as JaxBoringModel
from ray_lightning_tpu_torch import (BoringModel, CSVLogger, EarlyStopping,
                                     EMAWeightAveraging, LearningRateMonitor,
                                     ModelCheckpoint, RayStrategy, Trainer)
from ray_lightning_tpu_torch.core import LambdaCallback
from ray_lightning_tpu_torch.core.loggers import TorchProfilerCallback

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

FIT = dict(max_epochs=3, limit_train_batches=4, limit_val_batches=2, seed=0)


def _to_port(params):
    dense = params["Dense_0"]
    return {"weight": torch.from_numpy(np.array(dense["kernel"]).T.copy()),
            "bias": torch.from_numpy(np.array(dense["bias"]))}


def _sched(n):
    """``optax.exponential_decay(1e-2, transition_steps=2, decay_rate=0.5)``."""
    return 1e-2 * 0.5 ** (n / 2)


class _JaxBoring(JaxBoringModel):
    def __init__(self, scheduled=False):
        super().__init__()
        self.scheduled = scheduled

    def configure_optimizers(self):
        if self.scheduled:
            schedule = optax.exponential_decay(
                init_value=1e-2, transition_steps=2, decay_rate=0.5)
            return optax.sgd(schedule), schedule
        return optax.sgd(0.1)


class _Boring(BoringModel):
    def __init__(self, init, scheduled=False):
        super().__init__()
        self.init, self.scheduled = init, scheduled

    def init_variables(self, model, generator, batch):
        model.load_state_dict(self.init)

    def configure_optimizers(self):
        if self.scheduled:
            return (lambda p: torch.optim.SGD(p, lr=1e-2)), _sched
        return super().configure_optimizers()


def _both(tmp_path, jax_cbs=(), port_cbs=(), scheduled=False, **kw):
    """The same fit in both trainers; returns (jax trainer, port trainer,
    the JAX run's initial params as the port's)."""
    fit = {**FIT, **kw}
    init = {}
    grab = JaxLambda(on_fit_start=lambda tr, m: init.update(_to_port(
        jax.tree_util.tree_map(np.array, tr.train_state.params))))
    jt = JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                    default_root_dir=str(tmp_path / "jax"),
                    callbacks=[grab, *jax_cbs], **fit)
    jt.fit(_JaxBoring(scheduled))
    pt = Trainer(strategy=RayStrategy(device="cpu"),
                 default_root_dir=str(tmp_path / "port"),
                 callbacks=list(port_cbs), **fit)
    pt.fit(_Boring(init, scheduled))
    return jt, pt, init


def _port_params(jax_params):
    return _to_port(jax.tree_util.tree_map(np.array, jax_params))


def _close(port_sd, want, atol):
    for n, w in want.items():
        np.testing.assert_allclose(port_sd[n].detach().numpy(), w.numpy(),
                                   atol=atol, rtol=0, err_msg=n)


# ------------------------------------------------------- ModelCheckpoint
@pytest.mark.parametrize("mode", ["min", "max"])
def test_model_checkpoint_files_and_best_match_jax(tmp_path, mode):
    kw = dict(monitor="x", mode=mode, save_top_k=2, save_last=True)
    jcb = JaxModelCheckpoint(dirpath=str(tmp_path / "jck"), **kw)
    pcb = ModelCheckpoint(dirpath=str(tmp_path / "pck"), **kw)
    _both(tmp_path, [jcb], [pcb])
    assert sorted(os.listdir(tmp_path / "pck")) == \
        sorted(os.listdir(tmp_path / "jck"))
    assert len(os.listdir(tmp_path / "pck")) == 3  # top-2 + last
    assert os.path.basename(pcb.best_model_path) == \
        os.path.basename(jcb.best_model_path)
    np.testing.assert_allclose(pcb.best_model_score, jcb.best_model_score,
                               atol=1e-5, rtol=0)
    assert os.path.basename(pcb.last_model_path) == "last.ckpt"


# --------------------------------------------------------- EarlyStopping
@pytest.mark.parametrize("kw", [
    dict(monitor="x", mode="max", patience=2),
    dict(monitor="train_loss", mode="min", min_delta=0.05, patience=1,
         check_on_train_epoch_end=True)], ids=["val-max", "train-min-delta"])
def test_early_stopping_stops_where_jax_does(tmp_path, kw):
    jes, pes = JaxEarlyStopping(**kw), EarlyStopping(**kw)
    jt, pt, _ = _both(tmp_path, [jes], [pes], max_epochs=8)
    assert jt.should_stop and pt.should_stop
    assert pes.stopped_epoch == jes.stopped_epoch < 7
    assert (pt.current_epoch, pt.global_step) == \
        (jt.current_epoch, jt.global_step)
    assert pes.wait_count == jes.wait_count
    np.testing.assert_allclose(pes.best_score, jes.best_score, atol=1e-5)


def test_early_stopping_strict_raises_on_missing_metric(tmp_path):
    t = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=2,
                limit_train_batches=2, limit_val_batches=1, seed=0,
                default_root_dir=str(tmp_path),
                callbacks=[EarlyStopping(monitor="nope")])
    with pytest.raises(RuntimeError, match="nope"):
        t.fit(BoringModel())


# ------------------------------------------------------------------ EMA
def test_ema_matches_jax(tmp_path):
    jema, pema = JaxEMA(decay=0.5), EMAWeightAveraging(decay=0.5)
    _both(tmp_path, [jema], [pema], max_epochs=1, limit_train_batches=3)
    _close(pema.ema_params, _port_params(jema.ema_params), 1e-6)


@pytest.mark.parametrize("fmt", ["stream", "orbax"])
def test_ema_swap_validation_and_resume(tmp_path, fmt):
    """swap_validation evaluates with the averaged weights and restores
    the raw ones after; the average rides the checkpoint (both formats)
    into a resumed fit, which keeps updating it."""
    root = tmp_path / fmt
    ema = EMAWeightAveraging(decay=0.9, swap_validation=True)
    seen = []
    probe = LambdaCallback(on_validation_epoch_start=lambda tr, m:
                           seen.append({n: p.detach().clone() for n, p in
                                        tr.model.named_parameters()}))
    t = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=2,
                limit_train_batches=3, limit_val_batches=1, seed=0,
                default_root_dir=str(root),
                callbacks=[ema, probe,
                           ModelCheckpoint(save_format=fmt)])
    t.fit(BoringModel())
    for n, p in t.model.named_parameters():
        assert torch.equal(seen[-1][n], ema.ema_params[n])
        assert not torch.equal(p, ema.ema_params[n])  # raw back
    best = t.checkpoint_callback.best_model_path
    saved = {n: v.clone() for n, v in ema.ema_params.items()}
    ema2 = EMAWeightAveraging(decay=0.9)
    at_start = {}
    t2 = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=3,
                 limit_train_batches=3, limit_val_batches=0, seed=0,
                 default_root_dir=str(root),
                 callbacks=[ema2, LambdaCallback(
                     on_train_start=lambda tr, m: at_start.update(
                         {n: v.clone()
                          for n, v in ema2.ema_params.items()}))])
    t2.fit(BoringModel(), ckpt_path=best)
    assert t2.global_step == 9
    for n, v in saved.items():
        assert torch.equal(at_start[n], v)
        assert not torch.equal(ema2.ema_params[n], v)  # kept updating


# -------------------------------------------------- LearningRateMonitor
def test_lr_monitor_matches_jax_under_a_schedule(tmp_path):
    jseen, pseen = [], []

    def spy(base, seen):
        class Spy(base):
            def on_train_epoch_end(self, trainer, pl_module):
                super().on_train_epoch_end(trainer, pl_module)
                seen.append(trainer.callback_metrics.get(self.key))
        return Spy()

    jt, pt, _ = _both(tmp_path, [spy(JaxLRMonitor, jseen)],
                      [spy(LearningRateMonitor, pseen)], scheduled=True,
                      limit_train_batches=2, limit_val_batches=0)
    np.testing.assert_allclose(pseen, [5e-3, 2.5e-3, 1.25e-3], rtol=1e-6)
    np.testing.assert_allclose(pseen, jseen, rtol=1e-6)
    assert pt.current_lr == pytest.approx(jt.current_lr, rel=1e-6)
    _close(pt.model.state_dict(), _port_params(jt.train_state.params), 1e-5)


def test_lr_respects_grad_accumulation_and_plain_has_none(tmp_path):
    jt, pt, _ = _both(tmp_path, scheduled=True, max_epochs=1,
                      limit_train_batches=4, limit_val_batches=0,
                      accumulate_grad_batches=2)
    assert pt.current_lr == pytest.approx(jt.current_lr, rel=1e-6)
    assert pt.current_lr == pytest.approx(_sched(2), rel=1e-6)
    _close(pt.model.state_dict(), _port_params(jt.train_state.params), 1e-5)
    plain = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=1,
                    limit_train_batches=1, limit_val_batches=0, seed=0,
                    default_root_dir=str(tmp_path / "plain"))
    plain.fit(BoringModel())
    assert plain.current_lr is None


# ------------------------------------------------------------ CSVLogger
def _rows(logger):
    with open(os.path.join(logger.log_dir, "metrics.csv")) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_csv_logger_matches_jax(tmp_path):
    """Header (extended when validation's metric first appears) and rows
    as the JAX logger writes them."""
    jl = JaxCSVLogger(save_dir=str(tmp_path / "jlogs"))
    pl = CSVLogger(save_dir=str(tmp_path / "plogs"))
    _both(tmp_path, [jl], [pl], max_epochs=3, limit_train_batches=3,
          limit_val_batches=None, check_val_every_n_epoch=2)
    (jf, jrows), (pf, prows) = _rows(jl), _rows(pl)
    assert pf == jf and "x" in pf
    assert len(prows) == len(jrows) == 3
    for p, j in zip(prows, jrows):
        assert (p["epoch"], p["step"]) == (j["epoch"], j["step"])
        assert (p["x"] == "") == (j["x"] == "")
        for k in pf:
            if p[k] != "":
                np.testing.assert_allclose(float(p[k]), float(j[k]),
                                           atol=1e-5, err_msg=k)


def test_csv_logger_versions_and_non_numeric(tmp_path):
    loggers = [CSVLogger(), CSVLogger()]
    for lg in loggers:
        Trainer(strategy=RayStrategy(device="cpu"), max_epochs=1,
                limit_train_batches=2, seed=0,
                default_root_dir=str(tmp_path),
                callbacks=[lg]).fit(BoringModel())
    assert loggers[0].log_dir.endswith("version_0")
    assert loggers[1].log_dir.endswith("version_1")
    logger = CSVLogger(save_dir=str(tmp_path / "s"))
    trainer = types.SimpleNamespace(
        global_rank=0, default_root_dir=str(tmp_path), current_epoch=0,
        global_step=3, callback_metrics={"loss": 1.5, "status": "diverged",
                                         "acc": torch.tensor(0.25)})
    logger.setup(trainer, None, "fit")
    logger.on_train_epoch_end(trainer, None)
    _fields, rows = _rows(logger)
    assert float(rows[0]["loss"]) == 1.5 and float(rows[0]["acc"]) == 0.25
    assert "status" not in rows[0]


# ------------------------------------------------------------ profilers
def test_simple_profiler_sections_match_jax(tmp_path, capsys):
    jt, pt, _ = _both(tmp_path, max_epochs=2, limit_train_batches=3,
                      profiler="simple")
    counts = {k: c for k, (c, _t) in pt.profiler.records().items()}
    assert counts == {k: c for k, (c, _t) in jt.profiler.records().items()}
    assert counts["train_step"] == 6 and counts["validation"] == 2
    assert "SimpleProfiler report" in capsys.readouterr().out
    pt.fit(BoringModel())  # a reused trainer reports each fit alone
    assert pt.profiler.records()["train_step"][0] == 6


def test_profiler_argument_validation():
    with pytest.raises(ValueError, match="profiler"):
        Trainer(strategy=RayStrategy(device="cpu"), profiler="advanced")
    with pytest.raises(ValueError, match="lacks required"):
        Trainer(strategy=RayStrategy(device="cpu"), profiler=True)


def test_torch_profiler_captures_a_trace_and_closes(tmp_path):
    cb = TorchProfilerCallback(start_step=1, num_steps=2)
    Trainer(strategy=RayStrategy(device="cpu"), max_epochs=1,
            limit_train_batches=4, limit_val_batches=0, seed=0,
            default_root_dir=str(tmp_path),
            callbacks=[cb]).fit(BoringModel())
    assert not cb._active and os.path.getsize(cb.trace_path) > 0
    assert cb.trace_path.startswith(str(tmp_path / "profile"))
    past = TorchProfilerCallback(start_step=2, num_steps=100)
    Trainer(strategy=RayStrategy(device="cpu"), max_epochs=1,
            limit_train_batches=3, limit_val_batches=0, seed=0,
            default_root_dir=str(tmp_path / "past"),
            callbacks=[past]).fit(BoringModel())
    assert not past._active and past._done  # teardown closed the window


def test_torch_profiler_starts_when_resumed_past_start_step(tmp_path,
                                                            monkeypatch):
    calls = []

    class Fake:
        def __init__(self, activities):
            pass

        def start(self):
            calls.append("start")

        def stop(self):
            calls.append("stop")

        def export_chrome_trace(self, path):
            calls.append(("export", path))

    monkeypatch.setattr(torch.profiler, "profile", Fake)
    cb = TorchProfilerCallback(start_step=5, num_steps=2)
    trainer = types.SimpleNamespace(global_rank=0, global_step=10,
                                    default_root_dir=str(tmp_path),
                                    block_until_ready=lambda: None)
    cb.on_train_batch_start(trainer, None, None, 0)
    assert cb._active and calls == ["start"]
    trainer.global_step = 11
    cb.on_train_batch_end(trainer, None, None, None, 0)
    assert cb._active                 # 11 < 10 (actual start) + 2
    cb.on_train_batch_start(trainer, None, None, 1)
    trainer.global_step = 12
    cb.on_train_batch_end(trainer, None, None, None, 1)
    assert not cb._active and cb._done
    assert calls[1:] == ["stop", ("export", cb.trace_path)]
    cb.on_train_batch_start(trainer, None, None, 2)
    cb.teardown(trainer, None, "fit")
    assert calls.count("start") == calls.count("stop") == 1


# --------------------------------------------------------------- predict
def test_predict_matches_jax(tmp_path):
    seen = []
    probe = LambdaCallback(
        on_predict_start=lambda tr, m: seen.append("start"),
        on_predict_batch_end=lambda tr, m, out, b, i: seen.append(i),
        on_predict_end=lambda tr, m: seen.append("end"))
    jt, pt, _ = _both(tmp_path, [], [probe])
    jt.limit_predict_batches = pt.limit_predict_batches = 3
    want = jt.predict(_JaxBoring())
    got = pt.predict(BoringModel())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and tuple(g.shape) == (8, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    assert seen == ["start", 0, 1, 2, "end"]
    assert pt.state == "finished"
