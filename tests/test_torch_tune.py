"""The port's Ray Tune integration against the JAX package's, with fake Tune modules.

Every test of ``tests/test_tune.py`` has its counterpart here, with the
same legacy fake (``tune.report(**metrics)``, ``tune.checkpoint_dir``)
and Ray 2.x fake (``report(metrics, checkpoint=)``), installed as the
module attribute the driver-side delivery reads. Where both packages
compute a value they are held against each other: the trial bundles
(the JAX package's ``TPU`` read as ``GPU``), and, in one process, the
nano GPT fit by both trainers from the same initial weights and numpy
batches: the same reports (keys, values within 1e-5 relative) and
checkpoints at the same global steps. A trial checkpoint resumed
through ``resume_ckpt_path`` -> ``fit(ckpt_path=)`` equals the
uninterrupted fit bitwise.

Port only: two spawned gloo workers (no Tune of their own) report
through the session queue from rank 0 alone, in order, the last report
put at ``train_end`` included (the driver's final drain); the same
with checkpoints under ZeRO and FSDP2, whose dump is a collective on
every rank; ``use_ray=True`` on the threaded fake; an item above
``INLINE_BYTES`` crossing ``ProcessRay``'s queue; a delivery that
raises failing the fit. And the reference's own fault: its callbacks
put lambdas and look Tune up in the worker, which its ``ProcessRay``
cannot carry (``ROADMAP.md`` C).
"""
import contextlib
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ray_lightning_tpu.tune as jax_tune
import ray_lightning_tpu_torch.tune as tune_mod
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import LambdaCallback as JaxLambda
from ray_lightning_tpu.models import BoringModel as JaxBoringModel
from ray_lightning_tpu.models.gpt import GPTModule as JaxGPTModule
from ray_lightning_tpu.models.gpt import gpt2_config as jax_gpt2_config
from ray_lightning_tpu_torch import (BoringModel, FSDPStrategy,
                                     RayShardedStrategy, RayStrategy, Trainer)
from ray_lightning_tpu_torch import session as _session
from ray_lightning_tpu_torch.launchers import (ExecutorBase, ProcessRay,
                                               ray_launcher as rl)
from ray_lightning_tpu_torch.launchers.process_backend import INLINE_BYTES
from ray_lightning_tpu_torch.launchers.utils import set_executable_cls
from ray_lightning_tpu_torch.testing import (RecordingExecutor,
                                             ThreadedFakeRay)
from ray_lightning_tpu_torch.tune import (TuneReportCallback,
                                          TuneReportCheckpointCallback,
                                          _trial_bundles, get_tune_resources,
                                          resume_ckpt_path)
from ray_lightning_tpu_torch.util import load_state_stream

import torch_world as tw

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

# seconds a two-worker fit with collective checkpoints may take before
# the test kills the world and fails (such a fit takes ~10 s on a CPU)
HANG_S = 240


class FakeTune:
    """Legacy Tune (Ray 1.x): ``report(**kw)``, ``checkpoint_dir``."""

    def __init__(self, tmpdir):
        self.reports = []
        self.tmpdir = tmpdir
        self._ckpt_count = 0

    def report(self, **metrics):
        self.reports.append(metrics)

    def is_session_enabled(self):
        return True

    @contextlib.contextmanager
    def checkpoint_dir(self, step):
        d = os.path.join(self.tmpdir, f"checkpoint_{step}")
        os.makedirs(d, exist_ok=True)
        self._ckpt_count += 1
        yield d


class _FakeCheckpoint2:
    def __init__(self, path):
        self.path = path
        # the contents, read before the temporary directory goes
        self.files = {name: open(os.path.join(path, name), "rb").read()
                      for name in os.listdir(path)}

    @classmethod
    def from_directory(cls, path):
        return cls(path)


class FakeTune2:
    """Ray >= 2.x Tune: no ``is_session_enabled``, no ``checkpoint_dir``;
    ``report`` takes a metrics dict and a checkpoint."""

    Checkpoint = _FakeCheckpoint2

    def __init__(self):
        self.reports = []

    def report(self, metrics, checkpoint=None):
        self.reports.append((dict(metrics), checkpoint))

    def get_context(self):
        class _Ctx:
            @staticmethod
            def get_trial_id():
                return "trial_0001"
        return _Ctx()


@pytest.fixture
def fake_tune(tmp_path, monkeypatch):
    fake = FakeTune(str(tmp_path))
    monkeypatch.setattr(tune_mod, "tune", fake)
    return fake


@pytest.fixture
def fake_tune2(monkeypatch):
    fake = FakeTune2()
    monkeypatch.setattr(tune_mod, "tune", fake)
    return fake


@pytest.fixture(scope="module")
def world():
    w = tw.World()
    yield w
    w.ray.shutdown()
    assert w.ray.live_actor_count() == 0


def _fit1(tmp_path, callbacks, epochs=2, module=None, **kw):
    trainer = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=epochs,
                      limit_train_batches=2, seed=0,
                      default_root_dir=str(tmp_path), callbacks=callbacks,
                      **kw)
    trainer.fit(module if module is not None else BoringModel())
    return trainer


# ------------------------------------------------------------ bundle math
def _jax_as_gpu(bundles):
    return [{("GPU" if k == "TPU" else k): v for k, v in b.items()}
            for b in bundles]


@pytest.mark.parametrize("jax_args,port_args", [
    # no chips: JAX's CPU workers are the port's device="cpu" workers
    ((2, 1, False, None, None), (2, 1, False, None, None, "cpu")),
    # one chip a worker: JAX's use_tpu is the port's default, a card
    ((4, 2, False, True, None), (4, 2, False, None, None, None)),
    # resources_per_worker beats the dedicated arguments
    ((1, 1, True, None, {"CPU": 3, "TPU": 1, "extra": 1}),
     (1, 1, True, None, {"CPU": 3, "GPU": 1, "extra": 1}, None)),
])
def test_trial_bundles_match_the_jax_package(jax_args, port_args):
    want = _jax_as_gpu(jax_tune._trial_bundles(*jax_args))
    assert _trial_bundles(*port_args) == want
    assert want[0] == {"CPU": 1}                 # the trial's driver


def test_trial_bundles_default():
    assert _trial_bundles(2, 1, False, None, None) == [
        {"CPU": 1}, {"CPU": 1, "GPU": 1}, {"CPU": 1, "GPU": 1}]


@pytest.mark.parametrize("kw", [
    dict(use_tpu=True), dict(resources_per_worker={"TPU": 1}),
    dict(resources_per_worker={"GPU": 4}),
    dict(use_gpu=True, device="cpu")])
def test_trial_bundles_refuse_what_the_strategies_refuse(kw):
    args = dict(num_workers=1, num_cpus_per_worker=1, use_gpu=False,
                use_tpu=None, resources_per_worker=None)
    args.update(kw)
    with pytest.raises(ValueError):
        _trial_bundles(**args)


def test_get_tune_resources_requires_tune(monkeypatch):
    monkeypatch.setattr(tune_mod, "tune", None)
    with pytest.raises(RuntimeError, match="ray.tune"):
        get_tune_resources(num_workers=2)


# ------------------------------------------------------ report callback
def test_report_each_epoch(fake_tune, tmp_path):
    """One report per fired hook, as the JAX trainer makes (the
    reference's ``training_iteration == max_epochs``)."""
    _fit1(tmp_path, [TuneReportCallback(on="train_epoch_end")], epochs=3)
    assert len(fake_tune.reports) == 3
    assert all("train_loss" in r for r in fake_tune.reports)
    jax_fake = FakeTune(str(tmp_path / "jax"))
    jax_tune.tune, saved = jax_fake, jax_tune.tune
    try:
        JaxTrainer(strategy=JaxRayStrategy(num_workers=1), max_epochs=3,
                   limit_train_batches=2, seed=0,
                   default_root_dir=str(tmp_path / "jax"),
                   callbacks=[jax_tune.TuneReportCallback(
                       on="train_epoch_end")]).fit(JaxBoringModel())
    finally:
        jax_tune.tune = saved
    assert [sorted(r) for r in fake_tune.reports] == [
        sorted(r) for r in jax_fake.reports]


def test_report_metric_mapping(fake_tune, tmp_path):
    cb = TuneReportCallback(metrics={"objective": "train_loss"},
                            on="train_epoch_end")
    _fit1(tmp_path, [cb], epochs=1)
    assert list(fake_tune.reports[0].keys()) == ["objective"]


def test_invalid_hook_rejected():
    with pytest.raises(ValueError, match="Invalid hook"):
        TuneReportCallback(on="not_a_hook")
    with pytest.raises(ValueError, match="Invalid hook"):
        TuneReportCheckpointCallback(on="not_a_hook")


@pytest.fixture
def session_queue():
    """A session with a queue, as a launch in a Tune trial opens."""
    import queue
    q = queue.Queue()
    _session.shutdown_session()
    _session.init_session(rank=0, queue=q)
    yield q
    _session.shutdown_session()


def _fake_trainer(sanity, rank):
    class T:
        sanity_checking = sanity
        global_rank = rank
        global_step = 3
        callback_metrics = {"loss": 1.0}

        def dump_checkpoint(self):
            return {"global_step": 3}
    return T()


def test_sanity_check_suppressed(fake_tune, session_queue):
    TuneReportCallback(on="validation_end").on_validation_end(
        _fake_trainer(True, 0), None)
    TuneReportCheckpointCallback(on="validation_end").on_validation_end(
        _fake_trainer(True, 0), None)
    assert session_queue.empty()


def test_non_rank_zero_suppressed(fake_tune, session_queue):
    """Rank 1 puts nothing; it still dumps a checkpoint (a collective
    under ZeRO and FSDP2)."""
    dumps = []
    trainer = _fake_trainer(False, 1)
    trainer.dump_checkpoint = lambda: dumps.append(1) or {}
    TuneReportCallback(on="validation_end").on_validation_end(trainer, None)
    TuneReportCheckpointCallback(on="validation_end").on_validation_end(
        trainer, None)
    assert session_queue.empty() and dumps == [1]


def test_no_session_queue_reports_nothing(fake_tune):
    """A worker whose session has no queue (no Tune session on the
    driver) neither reports nor dumps."""
    _session.shutdown_session()
    _session.init_session(rank=0)
    try:
        trainer = _fake_trainer(False, 0)
        trainer.dump_checkpoint = None   # would raise if called
        TuneReportCheckpointCallback(on="validation_end").on_validation_end(
            trainer, None)
        TuneReportCallback(on="validation_end").on_validation_end(
            trainer, None)
    finally:
        _session.shutdown_session()
    assert fake_tune.reports == []


# ------------------------------------------ checkpoint + report callback
def test_checkpoint_and_report(fake_tune, tmp_path):
    """Checkpoint bytes land in ``tune.checkpoint_dir`` on the driver and
    the report follows."""
    _fit1(tmp_path, [TuneReportCheckpointCallback(on="train_epoch_end")])
    assert len(fake_tune.reports) == 2
    assert fake_tune._ckpt_count == 2
    last = os.path.join(str(tmp_path), "checkpoint_4", "checkpoint")
    with open(last, "rb") as f:
        ckpt = load_state_stream(f.read())
    assert ckpt["global_step"] == 4
    assert "state" in ckpt and "params" in ckpt["state"]
    kinds = [d["kind"] for d in tune_mod.DELIVERIES[-2:]]
    assert kinds == ["checkpoint", "checkpoint"]
    assert tune_mod.DELIVERIES[-1]["bytes"] == os.path.getsize(last)


def test_is_session_enabled_false_without_tune(monkeypatch):
    monkeypatch.setattr(tune_mod, "tune", None)
    assert tune_mod.is_session_enabled() is False


# ------------------------------------------------------- Ray 2.x's API
def test_tune2_session_detected(fake_tune2):
    assert tune_mod.is_session_enabled() is True


def test_tune2_report_dict_api(fake_tune2, tmp_path):
    _fit1(tmp_path, [TuneReportCallback(on="train_epoch_end")])
    assert len(fake_tune2.reports) == 2
    metrics, checkpoint = fake_tune2.reports[0]
    assert "train_loss" in metrics and checkpoint is None


def test_tune2_checkpoint_travels_with_report(fake_tune2, tmp_path):
    _fit1(tmp_path, [TuneReportCheckpointCallback(on="train_epoch_end")])
    assert len(fake_tune2.reports) == 2      # one combined call an epoch
    metrics, checkpoint = fake_tune2.reports[-1]
    assert "train_loss" in metrics and checkpoint is not None
    ckpt = load_state_stream(checkpoint.files["checkpoint"])
    assert ckpt["global_step"] == 4
    assert "state" in ckpt and "params" in ckpt["state"]


# ---------------------------------------------------------- resume point
def test_resume_ckpt_path_legacy_dir(tmp_path):
    d = tmp_path / "ckpt_0"
    d.mkdir()
    assert resume_ckpt_path(str(d)) is None
    (d / "checkpoint").write_bytes(b"x")
    assert resume_ckpt_path(str(d)) == str(d / "checkpoint")


def test_resume_ckpt_path_tune2(fake_tune2, tmp_path, monkeypatch):
    assert resume_ckpt_path() is None  # FakeTune2 has no get_checkpoint
    d = tmp_path / "cloned"
    d.mkdir()
    (d / "checkpoint").write_bytes(b"x")

    class _Ckpt:
        def to_directory(self):
            return str(d)

    monkeypatch.setattr(fake_tune2, "get_checkpoint", lambda: _Ckpt(),
                        raising=False)
    assert resume_ckpt_path() == str(d / "checkpoint")
    monkeypatch.setattr(fake_tune2, "get_checkpoint", lambda: None,
                        raising=False)
    assert resume_ckpt_path() is None


# --------------------------------------------- against the JAX trainer
NANO_FIT = dict(max_epochs=2, limit_train_batches=2, limit_val_batches=1,
                seed=0)


def _jax_nano_fit(tmpdir):
    """The JAX trainer's nano fit with its Tune callback on the legacy
    fake: (reports, checkpoint steps, initial params)."""
    fake = FakeTune(tmpdir)
    out = {}

    def on_start(trainer, module):
        out["init"] = jax.tree_util.tree_map(np.array,
                                             trainer.train_state.params)

    jax_tune.tune, saved = fake, jax_tune.tune
    try:
        JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                   callbacks=[JaxLambda(on_fit_start=on_start),
                              jax_tune.TuneReportCheckpointCallback()],
                   default_root_dir=tmpdir, **NANO_FIT).fit(
            JaxGPTModule(config=jax_gpt2_config(
                "nano", attention_impl="flash", dtype=jnp.float32,
                **tw.NANO)))
    finally:
        jax_tune.tune = saved
    return fake.reports, sorted(os.listdir(tmpdir)), out["init"]


def test_nano_reports_match_the_jax_trainer(fake_tune, tmp_path):
    want, want_ckpts, init = _jax_nano_fit(str(tmp_path / "jax"))
    trainer = Trainer(strategy=RayStrategy(device="cpu"),
                      callbacks=[TuneReportCheckpointCallback()],
                      default_root_dir=str(tmp_path), **NANO_FIT)
    trainer.fit(tw.Nano(init=init))
    got = fake_tune.reports
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("checkpoint_")) == [
        d for d in want_ckpts if d.startswith("checkpoint_")]


def test_trial_checkpoint_resumes_bitwise(fake_tune, tmp_path):
    """The last trial checkpoint of a 2-epoch fit, through
    ``resume_ckpt_path`` -> ``fit(ckpt_path=)`` for a third epoch, equals
    an uninterrupted 3-epoch fit bitwise, params and losses."""
    def fit(epochs, callbacks, ckpt_path=None):
        rec = tw.LossRecorder()
        trainer = Trainer(strategy=RayStrategy(device="cpu"),
                          callbacks=[rec, *callbacks],
                          default_root_dir=str(tmp_path),
                          **{**NANO_FIT, "max_epochs": epochs})
        trainer.fit(tw.Nano(), ckpt_path=ckpt_path)
        return trainer, rec.losses

    _, first = fit(2, [TuneReportCheckpointCallback()])
    path = resume_ckpt_path(str(tmp_path / "checkpoint_4"))
    assert path is not None
    # the resumed recorder starts from the checkpoint's copy of its state
    resumed, losses = fit(3, [], ckpt_path=path)
    whole, want = fit(3, [])
    assert first == want[:4] and losses == want
    assert resumed.global_step == whole.global_step == 6
    for name, t in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], t), name


# ------------------------------------------------ two spawned workers
def _run_or_kill(world, trainer, module, seconds=HANG_S):
    """``world.run(trainer, "fit", module)``, failing the test after
    ``seconds`` (its workers killed) instead of hanging."""
    box = {}

    def target():
        try:
            world.run(trainer, "fit", module)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box["error"] = exc

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(seconds)
    if thread.is_alive():
        for w in world.workers:
            world.ray.kill(w)
        thread.join(30)
        pytest.fail(f"the two-worker fit did not end in {seconds} s")
    if "error" in box:
        raise box["error"]


@pytest.mark.multiproc
def test_two_workers_report_from_rank_zero_in_order(world, fake_tune,
                                                    tmp_path):
    """Spawned workers (no Tune in them) report through the session
    queue: rank 0 alone, in order, the ``train_end`` report put last
    included; the driver drains it all."""
    cb = TuneReportCallback(metrics=["train_loss", "rank",
                                     "worker_has_tune"],
                            on=["train_epoch_end", "train_end"])
    trainer = Trainer(strategy=RayStrategy(num_workers=2, device="cpu"),
                      callbacks=[tw.RankProbe(), cb],
                      default_root_dir=str(tmp_path), max_epochs=3,
                      limit_train_batches=2, limit_val_batches=0, seed=0)
    tune_mod.DELIVERIES.clear()
    _run_or_kill(world, trainer, tw.Nano(opt="sgd"))
    got = fake_tune.reports
    assert len(got) == 4                      # 3 epochs + train_end
    assert all(r["rank"] == 0.0 and r["worker_has_tune"] == 0.0
               for r in got)
    assert [d["global_step"] for d in tune_mod.DELIVERIES] == [2, 4, 6, 6]
    assert got[-1]["train_loss"] == trainer.callback_metrics["train_loss"]
    assert trainer._launcher.queue is None    # shut down at teardown


@pytest.mark.multiproc
@pytest.mark.parametrize("cls", [RayShardedStrategy, FSDPStrategy])
def test_two_workers_checkpoint_under_sharded_state(world, fake_tune,
                                                    tmp_path, cls):
    """Under ZeRO and FSDP2 every rank dumps the checkpoint (a
    collective) and rank 0 puts it: two checkpoints arrive, each the
    full one-process state, equal to what the driver got back."""
    cb = TuneReportCheckpointCallback(metrics={"loss": "val_loss"},
                                      on="validation_end")
    trainer = Trainer(strategy=cls(num_workers=2, device="cpu"),
                      callbacks=[cb], default_root_dir=str(tmp_path),
                      max_epochs=2, limit_train_batches=2,
                      limit_val_batches=1, seed=0)
    _run_or_kill(world, trainer, tw.Nano(optimizer="adafactor"))
    assert len(fake_tune.reports) == 2 and fake_tune._ckpt_count == 2
    with open(tmp_path / "checkpoint_4" / "checkpoint", "rb") as f:
        ckpt = load_state_stream(f)
    assert ckpt["global_step"] == 4
    final = trainer.train_state_dict
    for name, t in final["params"].items():
        assert torch.equal(ckpt["state"]["params"][name], t), name
    assert fake_tune.reports[-1]["loss"] == \
        trainer.callback_metrics["val_loss"]


@pytest.mark.multiproc
def test_a_delivery_that_raises_fails_the_fit(world, monkeypatch, tmp_path):
    """An error of the driver-side delivery (here Tune's ``report``)
    fails the fit with that error, in one process and across two."""
    class Broken(FakeTune):
        def report(self, **metrics):
            raise KeyError("tune refused the report")

    monkeypatch.setattr(tune_mod, "tune", Broken(str(tmp_path)))
    cb = TuneReportCallback(on="train_epoch_end")
    with pytest.raises(KeyError, match="tune refused"):
        _fit1(tmp_path, [cb], epochs=1)
    trainer = Trainer(strategy=RayStrategy(num_workers=2, device="cpu"),
                      callbacks=[cb], max_epochs=1, limit_train_batches=2,
                      limit_val_batches=0, seed=0,
                      default_root_dir=str(tmp_path))
    with pytest.raises(KeyError, match="tune refused"):
        _run_or_kill(world, trainer, tw.Nano(opt="sgd"))


def _spilled(d):
    return [f for f in os.listdir(d) if f.startswith("processray-")]


@pytest.mark.multiproc
def test_a_large_item_crosses_the_process_queue(tmp_path, monkeypatch):
    """An item above ``INLINE_BYTES`` (a GPT-2-small trial checkpoint is
    1.49 GB) put by a worker reaches the driver through a temporary file
    (in the worker's ``TMPDIR``, here a directory of this test's own, set
    before the worker is spawned), removed once read; one left undrained
    is removed at shutdown."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    ray = ProcessRay(num_threads=1)
    ray.init()
    try:
        worker = ray.remote(ExecutorBase).remote()
        q = ray.make_queue()
        size = INLINE_BYTES + 4096
        item = bytes(range(256)) * (size // 256)
        assert ray.get(worker.execute.remote(tw.put_into, q, item))
        rank, got = q.get(timeout=60)
        assert rank == 0 and got == item
        assert not _spilled(tmp_path)
        assert ray.get(worker.execute.remote(tw.put_into, q, item))
        assert len(_spilled(tmp_path)) == 1
        q.shutdown()
        assert q.empty() and not _spilled(tmp_path)
    finally:
        ray.shutdown()
    assert ray.live_actor_count() == 0


@pytest.mark.multiproc
def test_the_process_queue_keeps_every_item_of_concurrent_workers(world):
    """Both workers put 300 items each at once while the driver drains
    (``util.process_results``): every item runs in the driver, each
    worker's in the order it put them."""
    from ray_lightning_tpu_torch.util import process_results
    world.launcher(RayStrategy(num_workers=2, device="cpu"))
    q = world.ray.make_queue()
    tw.RECEIVED.clear()
    try:
        futures = [w.execute.remote(tw.put_many, q, rank, 300)
                   for rank, w in enumerate(world.workers)]
        assert process_results(futures, world.ray, queue=q) == [300, 300]
    finally:
        q.shutdown()
    assert len(tw.RECEIVED) == 600
    for rank in range(2):
        assert [i for r, i in tw.RECEIVED if r == rank] == list(range(300))


def test_use_ray_reports_through_the_fake_queue(fake_tune, monkeypatch,
                                                tmp_path):
    """``use_ray=True`` with a Ray runtime attached (the threaded fake:
    task arguments pickled, the queue by reference): the launch makes a
    queue, the worker thread reports, the driver delivers."""
    ray = ThreadedFakeRay()
    ray.init()
    monkeypatch.setattr(rl, "_import_ray", lambda: ray)
    # an executor that asks the fake nothing of Ray's (node address)
    set_executable_cls(RecordingExecutor)
    monkeypatch.setattr(RecordingExecutor, "instances", [])
    trainer = Trainer(strategy=RayStrategy(num_workers=1, device="cpu",
                                           use_ray=True),
                      callbacks=[TuneReportCallback(on="train_epoch_end")],
                      max_epochs=2, limit_train_batches=2, seed=0,
                      default_root_dir=str(tmp_path))
    try:
        trainer.fit(BoringModel())
    finally:
        set_executable_cls(None)
    assert isinstance(trainer._launcher, rl.RayLauncher)
    assert len(fake_tune.reports) == 2
    assert trainer._launcher.queue is None


@pytest.mark.multiproc
def test_the_jax_callbacks_do_not_cross_its_process_backend(world,
                                                            monkeypatch):
    """The JAX package's callbacks put a lambda over its ``tune`` module
    (``ray_lightning_tpu/tune.py:287``), which a ``multiprocessing``
    queue cannot pickle, and they look Tune up in the worker
    (``_require_tune()``), where a fake installed in the driver is not:
    a spawned worker's JAX ``tune`` module finds none. The port puts a
    module-level function and data, and looks Tune up in the driver."""
    import functools
    import pickle
    with pytest.raises((pickle.PicklingError, AttributeError)):
        pickle.dumps((0, lambda: jax_tune._report(None, {})))
    monkeypatch.setattr(jax_tune, "tune", FakeTune("unused"))
    assert tw.jax_tune_found_here()
    world.launcher(RayStrategy(num_workers=2, device="cpu"))
    assert world.ray.get(world.workers[0].execute.remote(
        tw.jax_tune_found_here), timeout=120) is False
    item = functools.partial(tune_mod._deliver_report, {"a": 1.0}, 1,
                             0.0, 0.0)
    assert pickle.loads(pickle.dumps(item)).func is tune_mod._deliver_report
