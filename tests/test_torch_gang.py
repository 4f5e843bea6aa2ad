"""The port's gang supervision (``reliability/gang.py``, ``RayLauncher(gang=)``) against the JAX package.

The cases of ``tests/test_gang.py``, on the port:

- the copied monitor's timeout arithmetic, postmortems and failure
  message, run on both packages' ``GangMonitor`` with one fake clock;
- the watchdog over a live threaded gang (``testing/fake_ray.py``): a
  silent rank named alone and the full gang killed, a finished rank
  never declared silent -- on both packages' launchers;
- heartbeats from the evaluation loop; a ``train.step`` crash under
  ``GangSupervisor`` on the threaded fake (a gloo group of one in a
  thread): ``worker.error`` -> ``gang.teardown`` -> ``gang.restart``,
  attempts and postmortems equal to the JAX supervisor's on its fake,
  final params bitwise the port's uninterrupted fit; a rendezvous fault
  retried on a fresh set-up; ``gang=None`` allocating nothing; the exit
  mode degrading to a raise in-process; rank-addressed fault specs;
- real worker processes (``ProcessRay``, gloo), one spawned world a
  fit: a worker ended by ``os._exit`` at step 9 (``worker.dead``), one
  wedged at step 9 (``worker.heartbeat_missed`` within the timeout) and
  the same exit with a warm standby promoted, each restarted from the
  epoch-1 checkpoint on a fresh rendezvous port to params bitwise the
  uninterrupted process fit's, with the JAX test's event order, and no
  worker process left alive after the pool's shutdown.
"""
import os
import time

import pytest
import torch

import ray_lightning_tpu.launchers.utils as jax_launcher_utils
import ray_lightning_tpu.reliability as jax_rel
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import \
    ModelCheckpoint as JaxModelCheckpoint
from ray_lightning_tpu.launchers.ray_launcher import \
    RayLauncher as JaxRayLauncher
from ray_lightning_tpu.models import BoringModel as JaxBoringModel
from ray_lightning_tpu.obs import Telemetry as JaxTelemetry
from ray_lightning_tpu.testing import fake_ray as jax_fake
import ray_lightning_tpu_torch.reliability as rel
from ray_lightning_tpu_torch import (BoringModel, ModelCheckpoint,
                                     RayStrategy, Telemetry, Trainer)
from ray_lightning_tpu_torch.launchers import (ExecutorBase, ProcessRay,
                                               RayLauncher)
from ray_lightning_tpu_torch.launchers import utils as launcher_utils
from ray_lightning_tpu_torch.reliability import (FaultPlan, GangConfig,
                                                 GangSupervisor,
                                                 InjectedFault, RetryPolicy,
                                                 StandbyPool)
from ray_lightning_tpu_torch.testing import fake_ray as port_fake

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

GANG_SITES = ("worker.dead", "worker.error", "worker.heartbeat_missed",
              "gang.teardown", "gang.restart")
PKGS = {"jax": jax_rel, "port": rel}
FIT = dict(max_epochs=3, seed=0, limit_train_batches=4, limit_val_batches=0)


@pytest.fixture(autouse=True)
def _reset_executor_seams():
    yield
    launcher_utils.set_executable_cls(None)
    jax_launcher_utils.set_executable_cls(None)
    port_fake.RecordingExecutor.instances.clear()
    jax_fake.RecordingExecutor.instances.clear()


def _gang_sites(tel):
    return [e.site for e in tel.events() if e.site in GANG_SITES]


def _bitwise(got, want):
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert torch.equal(got[name], t), name


# ----------------------------------------------- monitor arithmetic
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_gang_monitor_timeout_arithmetic(pkg):
    """Startup grace until a rank's first step beat, the timeout after;
    the same verdicts and postmortems from both packages' monitors."""
    mod = PKGS[pkg]
    t = [0.0]
    cfg = mod.GangConfig(heartbeat_timeout=1.0, startup_grace=5.0,
                         clock=lambda: t[0])
    mon = mod.GangMonitor(2, cfg, node_ips=["10.0.0.1", "10.0.0.2"])
    mon.start()
    mon.observe(0, 1, 0.0)
    mon.observe(1, -1, 0.0)
    t[0] = 2.0
    assert mon.silent_ranks() == [0]
    mon.observe(0, 2, 0.0)
    assert mon.silent_ranks() == []
    t[0] = 4.5
    mon.observe(0, 3, 0.0)
    assert mon.silent_ranks() == []
    t[0] = 5.2
    assert mon.silent_ranks() == [1]
    pms = mon.postmortems(silent=[1])
    assert pms[1].silent and not pms[0].silent
    assert (pms[1].last_step, pms[0].last_step) == (-1, 3)
    assert pms[1].node_ip == "10.0.0.2"
    assert (pms[0].beats, pms[1].beats) == (3, 1)
    mon.observe(7, 99, 0.0)       # a stray beat of an older generation
    assert 7 not in mon.postmortems()
    mon.mark_done(1)
    t[0] = 50.0
    assert mon.silent_ranks() == [0]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_gang_failure_message_carries_postmortems(pkg):
    mod = PKGS[pkg]
    mon = mod.GangMonitor(2, mod.GangConfig(heartbeat_timeout=1.0,
                                            clock=lambda: 0.0),
                          node_ips=["a", "b"])
    err = mon.heartbeat_failure([1])
    assert err.reason == "worker.heartbeat_missed"
    assert "rank 1" in str(err) and "SILENT" in str(err)
    assert err.postmortems[1].silent and not err.postmortems[0].silent


def test_collective_timeout_covers_the_startup_grace():
    """The world's rendezvous and collectives wait as long as the
    watchdog could (the longer of the timeout and the grace)."""
    assert GangConfig(heartbeat_timeout=5.0,
                      startup_grace=60.0).collective_timeout() == 60.0
    assert GangConfig(heartbeat_timeout=5.0,
                      startup_grace=None).collective_timeout() == 5.0


# ------------------------------------- the watchdog over a threaded gang
def _beat_loop(chan, rank, n, dt):
    for step in range(1, n + 1):
        chan.put((rank, step, 0.0))
        time.sleep(dt)
    return rank


def _silent_worker(hold_s):
    time.sleep(hold_s)
    return "late"


def _return_fast():
    return "fast"


def _threaded_launcher(pkg, gang_kw):
    """Two threaded fake workers under an armed gang, set up."""
    if pkg == "jax":
        fake = jax_fake.ThreadedFakeRay()
        jax_launcher_utils.set_executable_cls(jax_fake.RecordingExecutor)
        launcher = JaxRayLauncher(JaxRayStrategy(num_workers=2),
                                  ray_module=fake,
                                  gang=jax_rel.GangConfig(**gang_kw))
        launcher.setup_workers(tune_enabled=False)
    else:
        fake = port_fake.ThreadedFakeRay()
        launcher_utils.set_executable_cls(port_fake.RecordingExecutor)
        launcher = RayLauncher(RayStrategy(num_workers=2, device="cpu"),
                               ray_module=fake,
                               gang=GangConfig(**gang_kw))
        launcher.setup_workers()
    return fake, launcher


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_silent_rank_detected_and_full_gang_killed(pkg):
    """One rank beats, the other goes quiet: the watchdog raises within
    the timeout naming only the silent rank, and the teardown kills the
    whole gang."""
    fake, launcher = _threaded_launcher(
        pkg, dict(heartbeat_timeout=0.4, startup_grace=0.4))
    chan = launcher._gang_channel
    futures = [
        launcher._workers[0].execute.remote(_beat_loop, chan, 0, 60, 0.05),
        launcher._workers[1].execute.remote(_silent_worker, 8.0)]
    t0 = time.monotonic()
    with pytest.raises(Exception) as ei:
        launcher._process_results(futures, None)
    assert time.monotonic() - t0 < 6.0
    failure = ei.value
    assert failure.reason == "worker.heartbeat_missed"
    assert [r for r, pm in failure.postmortems.items() if pm.silent] == [1]
    assert failure.postmortems[0].beats > 0
    assert failure.postmortems[1].node_ip == "127.0.0.1"
    assert launcher._gang_failed
    launcher.teardown_workers()
    assert len(fake.killed_actors) == 2


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_completed_rank_is_not_declared_silent(pkg):
    fake, launcher = _threaded_launcher(
        pkg, dict(heartbeat_timeout=0.3, startup_grace=0.3))
    chan = launcher._gang_channel
    futures = [launcher._workers[0].execute.remote(_return_fast),
               launcher._workers[1].execute.remote(_beat_loop, chan, 1, 30,
                                                   0.05)]
    assert launcher._process_results(futures, None)[0] == "fast"
    launcher.teardown_workers()


class _BeatShim:
    def __init__(self):
        self.beats = []

    def drain_queue(self):
        pass

    def heartbeat(self, step):
        self.beats.append(step)


def test_evaluation_and_prediction_beat(tmp_path):
    """A rank in validation or prediction is not hung: one beat a batch,
    clamped to >= 1 (the JAX trainer's rule), as the JAX trainer
    beats."""
    beats = {}
    for side in ("jax", "port"):
        if side == "jax":
            t = JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                           max_epochs=1, seed=0, limit_train_batches=2,
                           limit_val_batches=3,
                           default_root_dir=str(tmp_path / side))
            model = JaxBoringModel()
        else:
            t = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=1,
                        seed=0, limit_train_batches=2, limit_val_batches=3,
                        default_root_dir=str(tmp_path / side))
            model = BoringModel()
        t.fit(model)
        shim = _BeatShim()
        t._launcher = shim
        t._run_validation(t._dataloader("val_dataloader"), model)
        beats[side] = list(shim.beats)
    assert beats["port"] == beats["jax"] == [2, 2, 2]
    t.limit_predict_batches = 2
    t._launcher = shim = _BeatShim()
    t._predict_worker(model, None, None)
    assert shim.beats == [2, 2]


# ------------------------------- coordinated restart on the fakes
def _make(side, fake, root, tel=None, gang=True, standby=None):
    ck = os.path.join(root, "ck")

    def make_trainer():
        if side == "jax":
            strategy = JaxRayStrategy(num_workers=1)
            trainer = JaxTrainer(
                strategy=strategy, callbacks=[JaxModelCheckpoint(dirpath=ck)],
                default_root_dir=root, telemetry=tel, **FIT)
            trainer._launcher = JaxRayLauncher(
                strategy, ray_module=fake,
                gang=jax_rel.GangConfig(heartbeat_timeout=30.0)
                if gang else None)
            return trainer
        strategy = RayStrategy(num_workers=1, device="cpu")
        trainer = Trainer(strategy=strategy,
                          callbacks=[ModelCheckpoint(dirpath=ck)],
                          default_root_dir=root, telemetry=tel, **FIT)
        config = gang if isinstance(gang, GangConfig) else (
            GangConfig(heartbeat_timeout=30.0) if gang else None)
        trainer._launcher = RayLauncher(strategy, ray_module=fake,
                                        gang=config, standby=standby)
        return trainer
    return make_trainer


def _sup(side, make_trainer, tel=None, **kw):
    cls, policy = ((jax_rel.GangSupervisor, jax_rel.RetryPolicy)
                   if side == "jax" else (GangSupervisor, RetryPolicy))
    return cls(make_trainer, policy(max_attempts=3, base_delay=0.0),
               sleep=lambda s: None, telemetry=tel, **kw)


def test_gang_restart_threaded_fake_matches_jax(tmp_path):
    """A ``train.step`` crash mid-epoch 2 under the supervisor:
    detection, the full gang's teardown, a restart resuming from the
    newest checkpoint; the same attempts, postmortem and event order as
    the JAX supervisor on its fake, and params bitwise the port's
    uninterrupted fit on the same backend."""
    ref = _make("port", port_fake.ThreadedFakeRay(), str(tmp_path / "ref"))()
    ref.fit(BoringModel())
    seen = {}
    for side, fake_mod, tel_cls, plan_cls, module in (
            ("jax", jax_fake, JaxTelemetry, jax_rel.FaultPlan,
             JaxBoringModel),
            ("port", port_fake, Telemetry, FaultPlan, BoringModel)):
        tel = tel_cls()
        sup = _sup(side, _make(side, fake_mod.ThreadedFakeRay(),
                               str(tmp_path / side), tel), tel)
        with plan_cls.at("train.step", [9]).armed():
            trainer = sup.fit(module)
        f = sup.failures[0]
        seen[side] = (sup.attempts, sup.restarts, len(sup.failures),
                      f.reason, f.postmortems[0].last_step, trainer.state,
                      _gang_sites(tel),
                      tel.metrics.snapshot()["gang_restarts_total"])
    assert seen["port"] == seen["jax"] == (
        2, 1, 1, "worker.error", 9, "finished",
        ["worker.error", "gang.teardown", "gang.restart"], 1)
    _bitwise(trainer.train_state_dict["params"],
             ref.train_state_dict["params"])


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_gang_rendezvous_fault_retried_on_fresh_setup(tmp_path, pkg):
    """A ``rendezvous.init`` failure fails the attempt without leaking
    workers; the retry sets up afresh and completes."""
    fake = (jax_fake if pkg == "jax" else port_fake).FakeRay()
    sup = _sup(pkg, _make(pkg, fake, str(tmp_path)))
    plan = PKGS[pkg].FaultPlan.at("rendezvous.init", [0])
    with plan.armed():
        trainer = sup.fit(JaxBoringModel if pkg == "jax" else BoringModel)
    assert plan.fired == 1
    assert (sup.attempts, sup.restarts) == (2, 1)
    assert trainer.state == "finished"
    assert len(fake.killed_actors) == len(fake.created_actors)
    assert sup.failures == []


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_gang_disarmed_is_zero_surface(tmp_path, pkg):
    """``gang=None``: no channel, no monitor, no gang event or counter."""
    tel = (JaxTelemetry if pkg == "jax" else Telemetry)()
    fake = (jax_fake if pkg == "jax" else port_fake).FakeRay()
    trainer = _make(pkg, fake, str(tmp_path), tel=tel, gang=False)()
    trainer.fit(JaxBoringModel() if pkg == "jax" else BoringModel())
    launcher = trainer._launcher
    assert launcher._gang_channel is None and launcher._gang_monitor is None
    assert _gang_sites(tel) == []
    assert "gang_restarts_total" not in tel.metrics.snapshot()


def test_worker_exit_mode_degrades_to_raise_in_process(tmp_path):
    assert not os.environ.get("TL_WORKER_PROCESS")
    trainer = _make("port", port_fake.FakeRay(), str(tmp_path),
                    gang=False)()
    with pytest.raises(InjectedFault):
        with FaultPlan.at("worker.exit", [0], mode="exit").armed():
            trainer.fit(BoringModel())


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_worker_fault_rank_addressing(pkg):
    mod = PKGS[pkg]
    plan = mod.FaultPlan([mod.FaultSpec("worker.stall", 0, "raise", rank=1),
                          mod.FaultSpec("worker.stall", 0, "raise", rank=2)])
    with plan.armed():
        assert plan.fire("worker.stall", rank=0) is None
    plan2 = mod.FaultPlan.at("worker.stall", [0], mode="raise", rank=1)
    with plan2.armed():
        with pytest.raises(mod.InjectedFault):
            plan2.fire("worker.stall", rank=1)
    with pytest.raises(ValueError, match="duplicate"):
        mod.FaultPlan([mod.FaultSpec("worker.stall", 0, "raise", rank=1),
                       mod.FaultSpec("worker.stall", 0, "raise", rank=1)])


# ------------------------------------- real worker processes (gloo)
def _ports(make_trainer, into):
    """``make_trainer`` recording each attempt's launcher."""
    def wrapped():
        trainer = make_trainer()
        into.append(trainer._launcher)
        return trainer
    return wrapped


@pytest.fixture(scope="module")
def process_ref(tmp_path_factory):
    """The uninterrupted fit through one spawned gloo worker, gang armed:
    the reference every chaos case ends at."""
    root = str(tmp_path_factory.mktemp("gang_ref"))
    ray_mod = ProcessRay(num_threads=1)
    ray_mod.init()
    try:
        trainer = _make("port", ray_mod, root)()
        trainer.fit(BoringModel())
    finally:
        ray_mod.shutdown()
    return trainer.train_state_dict["params"]


@pytest.mark.multiproc
@pytest.mark.parametrize("case", ["exit", "stall", "standby"])
def test_process_gang_restarts_to_the_uninterrupted_params(
        tmp_path, process_ref, case):
    """A worker ended by ``os._exit`` at step 9 (no exception: the OOM
    or preemption death), one wedged there (a 120 s stall against a 5 s
    timeout) and the exit again with a warm standby pool: detected,
    the gang torn down, restarted on a fresh rendezvous port from the
    epoch-1 checkpoint, the final params bitwise the uninterrupted
    fit's, the JAX test's event order, and no worker process left."""
    ray_mod = ProcessRay(num_threads=1)
    ray_mod.init()
    tel = Telemetry()
    launchers, pool = [], None
    plan = (FaultPlan.at("worker.stall", [9], mode="stall", stall_s=120.0)
            if case == "stall" else
            FaultPlan.at("worker.exit", [9], mode="exit"))
    if case == "standby":
        # two prefilled standbys make the promotions deterministic:
        # attempt 1 takes one, the restart the other
        pool = StandbyPool(ray_mod, num_standby=2, telemetry=tel)
        pool.fill(lambda: ray_mod.remote(ExecutorBase).options().remote())
    gang = (GangConfig(heartbeat_timeout=5.0, startup_grace=120.0)
            if case == "stall" else True)
    make = _make("port", ray_mod, str(tmp_path), tel=tel, gang=gang,
                 standby=pool)
    sup = _sup("port", _ports(make, launchers), tel, standby=pool)
    t0 = time.monotonic()
    try:
        with plan.armed():
            trainer = sup.fit(BoringModel)
        if pool is not None:
            pool.shutdown()
            assert pool.promotions == 2
        assert ray_mod.live_actor_count() == 0
    finally:
        ray_mod.shutdown()
    assert time.monotonic() - t0 < 90.0     # never waited out the stall
    assert (sup.attempts, sup.restarts) == (2, 1)
    assert trainer.state == "finished" and trainer.global_step == 12
    failure = sup.failures[0]
    pm = failure.postmortems[0]
    assert pm.last_step == 9
    if case == "stall":
        assert failure.reason == "worker.heartbeat_missed" and pm.silent
        assert 5.0 <= pm.last_beat_age_s < 10.0
    else:
        assert failure.reason == "worker.dead" and pm.dead
    assert launchers[0]._master_port != launchers[1]._master_port
    _bitwise(trainer.train_state_dict["params"], process_ref)
    sites = [e.site for e in tel.events()
             if e.site in GANG_SITES + ("standby.promoted",)]
    first = "worker.heartbeat_missed" if case == "stall" else "worker.dead"
    want = [first, "gang.teardown", "gang.restart"]
    if case == "standby":
        want = ["standby.promoted"] + want + ["standby.promoted"]
    assert sites == want
    assert tel.metrics.snapshot()["gang_restarts_total"] == 1
