"""The port's elastic recovery (``reliability/elastic.py``, ``reshard_state``, ``set_world_size``, the trainer's memory tier) against the JAX package.

The cases of ``tests/test_elastic.py``, on the port:

- the ring buddy, the memory store (keep-last eviction, the replica on
  the buddy, the channel drain, the scoped install) and the standby
  pool (fill, take, dead standbys dropped, the background refill,
  shutdown, the warm-up run in the actor), each run on both packages;
- ``GangSupervisor``'s elastic world planning (shrink to the survivors,
  the floor, error-class failures keeping capacity, standbys covering a
  loss) and its capped restart backoff, on both packages' supervisors
  with stub trainers: resizes, events and counters equal;
- ``resume="auto"`` from the in-memory tier ahead of the disk
  (``ckpt.memory_resume``), falling back to the disk when the owner and
  its buddy are gone, and losing to a disk with newer progress -- the
  JAX events, the port's params bitwise its uninterrupted fit; the
  replication through a threaded fake gang resuming with the disk
  deleted, every stored tensor on the host; standby promotion in the
  supervised restart with the JAX event order; disarmed = zero surface;
- a world change at restart, through real gloo workers (one four-worker
  world for the module): a directory checkpoint saved 4-way resumes
  2-way and one saved 2-way resumes 4-way, under ZeRO and FSDP2, with
  params and AdamW state element-identical to the checkpoint,
  ``ckpt.reshard`` and ``ckpt_reshards_total`` emitted, and
  ``global_step`` and the epochs equal to the JAX trainer's on the same
  world change.
"""
import queue
import shutil
import time

import pytest
import torch

import ray_lightning_tpu.reliability as jax_rel
from ray_lightning_tpu import FSDPStrategy as JaxFSDPStrategy
from ray_lightning_tpu import RayShardedStrategy as JaxShardedStrategy
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import \
    ModelCheckpoint as JaxModelCheckpoint
from ray_lightning_tpu.core.optim import make_optimizer as jax_make_optimizer
from ray_lightning_tpu.launchers.ray_launcher import \
    ExecutorBase as JaxExecutorBase
from ray_lightning_tpu.launchers.ray_launcher import \
    RayLauncher as JaxRayLauncher
from ray_lightning_tpu.models import BoringModel as JaxBoringModel
from ray_lightning_tpu.obs import Telemetry as JaxTelemetry
from ray_lightning_tpu.testing import fake_ray as jax_fake
import ray_lightning_tpu_torch.reliability as rel
import ray_lightning_tpu_torch.reliability.elastic as elastic
from ray_lightning_tpu_torch import (BoringModel, FSDPStrategy,
                                     ModelCheckpoint, RayShardedStrategy,
                                     RayStrategy, Telemetry, Trainer)
from ray_lightning_tpu_torch.core.checkpoint import (
    CorruptCheckpointError, find_resume_candidates, load_sharded_checkpoint,
    reshard_state)
from ray_lightning_tpu_torch.launchers import ExecutorBase, RayLauncher
from ray_lightning_tpu_torch.reliability import (GangConfig,
                                                 MemoryCheckpointStore,
                                                 StandbyPool)
from ray_lightning_tpu_torch.testing import fake_ray as port_fake

import torch_world as tw

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

PKGS = {"jax": jax_rel, "port": rel}
FAKES = {"jax": jax_fake, "port": port_fake}
EXECUTORS = {"jax": JaxExecutorBase, "port": ExecutorBase}
ELASTIC_SITES = ("worker.dead", "worker.error", "worker.heartbeat_missed",
                 "gang.teardown", "gang.restart", "gang.resize",
                 "standby.promoted", "ckpt.reshard", "ckpt.memory_resume")


def _sites(tel):
    return [e.site for e in tel.events() if e.site in ELASTIC_SITES]


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from ((f"{k}/{n}", v) for n, v in _leaves(tree[k]))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from ((f"{i}/{n}", x) for n, x in _leaves(v))
    elif isinstance(tree, torch.Tensor):
        yield "", tree


def _identical(got, want):
    """Every tensor of two nests equal element for element (and the same
    nest)."""
    a, b = dict(_leaves(got)), dict(_leaves(want))
    assert a.keys() == b.keys() and a
    for name, t in b.items():
        assert torch.equal(a[name].cpu(), t.cpu()), name


# ------------------------------------------- ring buddy, store, pool
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ring_buddy(pkg):
    ring_buddy = PKGS[pkg].ring_buddy
    assert (ring_buddy(0, 4), ring_buddy(3, 4), ring_buddy(0, 1)) == (1, 0, 0)
    with pytest.raises(ValueError):
        ring_buddy(0, 0)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_memory_store_keep_last_and_buddy_failover(pkg):
    store = PKGS[pkg].MemoryCheckpointStore(keep_last=2)
    for step in (1, 2, 3):
        store.put(step, {"state": {"a": step}}, rank=0, world_size=4)
    cands = store.resume_candidates()
    assert [s for s, _ in cands] == [3, 2]
    cands[0][1]["state"]["a"] = -1
    assert store.resume_candidates()[0][1]["state"]["a"] == 3
    store.drop_rank(0)
    assert [s for s, _ in store.resume_candidates()] == [3, 2]
    store.drop_rank(1)
    assert store.resume_candidates() == [] and store.latest_step() == -1
    with pytest.raises(ValueError):
        PKGS[pkg].MemoryCheckpointStore(keep_last=0)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_memory_store_channel_drain(pkg):
    mod = PKGS[pkg]
    chan = queue.Queue()
    mod.MemoryCheckpointClient(chan, rank=2, world_size=4).put(
        7, {"state": {"w": 7}})
    chan.put(("not-a-memckpt", 1, 2))
    store = mod.MemoryCheckpointStore(keep_last=2)
    assert store.drain(chan) == 1
    (step, ckpt), = store.resume_candidates()
    assert step == 7 and ckpt["state"]["w"] == 7
    store.drop_rank(2)
    assert [s for s, _ in store.resume_candidates()] == [7]

    class DeadChannel:
        def put(self, item):
            raise OSError("closed")
    mod.MemoryCheckpointClient(DeadChannel(), rank=0).put(1, {"state": {}})


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_memory_store_install_is_scoped(pkg):
    mod = PKGS[pkg]
    assert mod.get_memory_store() is None
    store = mod.MemoryCheckpointStore()
    with store.installed():
        assert mod.get_memory_store() is store
        inner = mod.MemoryCheckpointStore()
        with inner.installed():
            assert mod.get_memory_store() is inner
        assert mod.get_memory_store() is store
    assert mod.get_memory_store() is None


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_standby_pool_fill_take_refill_shutdown(pkg):
    fake = FAKES[pkg].FakeRay()
    pool = PKGS[pkg].StandbyPool(fake, num_standby=2, warmup=None)
    make = lambda: fake.remote(EXECUTORS[pkg]).options().remote()  # noqa
    assert pool.fill(make) == 2 and pool.available() == 2
    assert pool.fill(make) == 0
    first = pool.take()
    assert first is not None and pool.available() == 1
    assert pool.promotions == 1
    with pool._lock:
        dead_actor = pool._idle[0][0]
    fake.kill(dead_actor)
    assert pool.live_available() == 0     # the corpse is dropped
    pool.fill(make)
    got = pool.take()
    assert got is not None and not got._killed
    pool.refill_async(make)
    deadline = time.monotonic() + 5
    while pool.available() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.available() == 2
    pool.shutdown()
    assert pool.available() == 0 and pool.take() is None
    alive = {id(a) for a in fake.created_actors if not a._killed}
    assert alive == {id(first), id(got)}


def test_standby_warmup_runs_in_the_actor():
    """The pool's warm-up runs in the standby and is resolved at
    ``take``; the default warm-up on a host without a card pays the
    imports only (on the card: the context and the kernel loads)."""
    fake = port_fake.FakeRay()
    ran = []
    pool = StandbyPool(fake, num_standby=1, warmup=lambda: ran.append(1))
    pool.fill(lambda: fake.remote(ExecutorBase).options().remote())
    actor = pool.take()
    assert actor is not None and ran == [1]
    pool.shutdown()
    fake.kill(actor)
    if not torch.cuda.is_available():
        assert elastic.standby_warmup() is True


# ---------------------------------- GangSupervisor's elastic policy
def _failure(mod, world, lost, dead=True):
    pms = {r: mod.RankPostmortem(rank=r, last_step=5, last_beat_age_s=1.0,
                                 beats=5, node_ip=None,
                                 dead=dead and r in lost,
                                 silent=(not dead) and r in lost)
           for r in range(world)}
    return mod.GangFailure("worker.dead" if dead
                           else "worker.heartbeat_missed", pms)


class _StubStrategy:
    def __init__(self, n):
        self.num_workers = n

    def set_world_size(self, n):
        self.num_workers = n


class _StubTrainer:
    def __init__(self, n, failures):
        self.strategy = _StubStrategy(n)
        self._failures = failures
        self.state = "idle"

    def fit(self, module, datamodule=None, ckpt_path=None):
        if self._failures:
            raise self._failures.pop(0)
        self.state = "finished"


def _policy_runs(pkg):
    """(resizes, final world, events, counters) of the JAX test's four
    policy scenarios on one package."""
    mod = PKGS[pkg]
    tel_cls = JaxTelemetry if pkg == "jax" else Telemetry
    pol = lambda n=3: mod.RetryPolicy(max_attempts=n,  # noqa: E731
                                      base_delay=0.0)
    out = []
    for lost, dead, floor, failure in (
            ([2, 3], True, 2, None), ([1, 2, 3], False, 2, None),
            (None, None, 1, mod.GangFailure("worker.error", {
                r: mod.RankPostmortem(r, 5, 1.0, 5, None)
                for r in range(4)})),
            ([3], True, 1, "standby")):
        tel = tel_cls()
        standby = None
        if failure == "standby":
            fake = FAKES[pkg].FakeRay()
            standby = mod.StandbyPool(fake, num_standby=2, warmup=None)
            standby.fill(lambda: fake.remote(
                EXECUTORS[pkg]).options().remote())
            failure = None
        failures = [failure or _failure(mod, 4, lost, dead)]
        trainers = []

        def make():
            trainers.append(_StubTrainer(4, failures))
            return trainers[-1]
        sup = mod.GangSupervisor(make, pol(), sleep=lambda s: None,
                                 telemetry=tel, elastic=True,
                                 min_world_size=floor, standby=standby)
        assert sup.fit(object).state == "finished"
        out.append((sup.resizes, trainers[-1].strategy.num_workers,
                    [(e.site, e.payload) for e in tel.events()],
                    tel.metrics.snapshot()))
        if standby is not None:
            standby.shutdown()
    slept = []
    fails = [_failure(mod, 2, [1]) for _ in range(3)]
    sup = mod.GangSupervisor(lambda: _StubTrainer(2, fails), pol(4),
                             sleep=slept.append, restart_backoff=1.0,
                             restart_backoff_cap=3.0)
    sup.fit(object)
    out.append((sup.restart_delays, [d for d in slept if d > 0]))
    return out


def test_gang_supervisor_elastic_policy_matches_jax():
    """A 4-way gang losing two ranks shrinks to 2 (``gang.resize`` after
    ``gang.restart``); below the floor it restarts whole; a raised error
    keeps capacity; two warm standbys cover a loss; the restart backoff
    climbs 1, 2, 3 (capped) -- resizes, events and counters equal to the
    JAX supervisor's."""
    port, jax_out = _policy_runs("port"), _policy_runs("jax")
    assert port == jax_out
    assert port[0][0] == [(4, 2)] and port[0][1] == 2
    assert [s for s, _ in port[0][2]] == ["gang.restart", "gang.resize"]
    assert port[0][3]["gang_elastic_resizes_total"] == 1
    assert [r[0] for r in port[1:4]] == [[], [], []]
    assert port[4] == ([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])
    with pytest.raises(ValueError):
        rel.GangSupervisor(lambda: None, min_world_size=0)


def test_set_world_size_and_reshard_state_refusal():
    """``set_world_size`` adopts the new world (the rank map dropped, a
    world of one back in-process on the given device); a state that
    cannot adopt the live one raises ``CorruptCheckpointError``."""
    s = RayShardedStrategy(num_workers=4, device="cpu")
    s.set_global_to_local([(0, 0)] * 4)
    s.set_world_size(2)
    assert (s.num_workers, s.world_size, s.global_to_local) == (2, 2, None)
    assert s.distributed_sampler_kwargs["num_replicas"] == 2
    s.set_world_size(1)
    assert s.device == torch.device("cpu")
    with pytest.raises(ValueError):
        s.set_world_size(0)
    t = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=0, seed=0)
    t.fit(BoringModel())
    with pytest.raises(CorruptCheckpointError):
        reshard_state(t.train_state, {"params": {"nope": torch.zeros(1)}},
                      t.strategy)


# --------------------------------------- the memory tier, in-process
def _local(side, root, ck, tel=None, max_epochs=3):
    if side == "jax":
        return JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                          max_epochs=max_epochs, seed=0,
                          limit_train_batches=4, limit_val_batches=0,
                          callbacks=[JaxModelCheckpoint(dirpath=ck)],
                          default_root_dir=root, telemetry=tel)
    return Trainer(strategy=RayStrategy(device="cpu"), max_epochs=max_epochs,
                   seed=0, limit_train_batches=4, limit_val_batches=0,
                   callbacks=[ModelCheckpoint(dirpath=ck)],
                   default_root_dir=root, telemetry=tel)


def test_memory_resume_ahead_of_disk_and_buddy_fallback(tmp_path):
    """A killed fit resumes from the memory tier (``ckpt.memory_resume``
    at step 8, as in JAX) to params bitwise the uninterrupted fit's; with
    the owner and its buddy gone it falls back to the disk, bitwise
    again; every stored tensor is a host copy."""
    ref = _local("port", str(tmp_path / "ref"), str(tmp_path / "ref_ck"))
    ref.fit(BoringModel())
    events = {}
    for side in ("jax", "port"):
        mod = PKGS[side]
        tel = (JaxTelemetry if side == "jax" else Telemetry)()
        ck = str(tmp_path / side / "ck")
        store = mod.MemoryCheckpointStore(keep_last=2)
        module = JaxBoringModel if side == "jax" else BoringModel
        with store.installed():
            with pytest.raises(Exception, match="injected"):
                with mod.FaultPlan.at("train.step", [9]).armed():
                    _local(side, str(tmp_path / side), ck,
                           tel=tel).fit(module())
            assert store.puts == 2 and store.latest_step() == 8
            trainer = _local(side, str(tmp_path / side), ck, tel=tel)
            trainer.fit(module(), ckpt_path="auto")
        events[side] = [(e.site, e.payload) for e in tel.events()
                        if e.site == "ckpt.memory_resume"]
        if side == "port":
            assert trainer.resumed_from == "<memory:step=8>"
            for _s, ckpt in store.resume_candidates(copy_payloads=False):
                assert all(t.device.type == "cpu"
                           for _n, t in _leaves(ckpt))
            assert [b for b, _s in trainer.memory_puts] == [
                sum(t.numel() * t.element_size() for _n, t in
                    _leaves(store.resume_candidates()[0][1]))]
            for name, t in ref.model.state_dict().items():
                assert torch.equal(trainer.model.state_dict()[name], t)
            store.drop_rank(0)
            tel2 = Telemetry()
            with store.installed():
                t2 = _local(side, str(tmp_path / "run2"), ck, tel=tel2)
                t2.fit(module(), ckpt_path="auto")
            assert _sites(tel2) == []
            assert t2.resumed_from.endswith("epoch=2-step=12.ckpt")
            for name, t in ref.model.state_dict().items():
                assert torch.equal(t2.model.state_dict()[name], t)
    assert events["port"] == events["jax"] == [
        ("ckpt.memory_resume", {"step": 8})]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_memory_resume_prefers_newer_disk(tmp_path, pkg):
    """A stale memory tier must not win over a disk with newer
    progress."""
    ck = str(tmp_path / "ck")
    module = JaxBoringModel if pkg == "jax" else BoringModel
    _local(pkg, str(tmp_path), ck, max_epochs=2).fit(module())
    tel = (JaxTelemetry if pkg == "jax" else Telemetry)()
    store = PKGS[pkg].MemoryCheckpointStore()
    store.put(4, {"state": {"bogus": 1}, "global_step": 4})
    with store.installed():
        t2 = _local(pkg, str(tmp_path), ck, tel=tel, max_epochs=2)
        t2.fit(module(), ckpt_path="auto")
    assert _sites(tel) == [] and t2.global_step == 8


def test_memory_replication_through_fake_gang(tmp_path):
    """Worker commits ride the replication channel into the driver's
    store (host tensors only), and a later launch resumes from the
    shipped candidates alone, the disk deleted; the channels are torn
    down after."""
    fake = port_fake.ThreadedFakeRay()
    store = MemoryCheckpointStore(keep_last=2)
    ck = str(tmp_path / "ck")

    def make():
        t = _local("port", str(tmp_path), ck)
        t._launcher = RayLauncher(t.strategy, ray_module=fake,
                                  gang=GangConfig(heartbeat_timeout=30.0))
        return t

    with store.installed():
        trainer = make()
        trainer.fit(BoringModel())
        assert store.puts == 3 and store.latest_step() == 12
        for _s, ckpt in store.resume_candidates(copy_payloads=False):
            assert all(t.device.type == "cpu" for _n, t in _leaves(ckpt))
        final = trainer.train_state_dict["params"]
        shutil.rmtree(ck)
        trainer2 = make()
        trainer2.fit(BoringModel(), ckpt_path="auto")
    _identical(trainer2.train_state_dict["params"], final)
    assert trainer2.resumed_from == "<memory:step=12>"
    assert trainer2._launcher._memstore_channel is None
    assert trainer2._launcher._memstore_driver is None


def test_standby_promotion_event_order_matches_jax(tmp_path):
    """With a pool of two: attempt 1 promotes one standby, the restart
    the other -- ``standby.promoted``, ``worker.error``,
    ``gang.teardown``, ``gang.restart``, ``standby.promoted`` -- on both
    packages' threaded fakes."""
    seen = {}
    for side in ("jax", "port"):
        mod, fake = PKGS[side], FAKES[side].ThreadedFakeRay()
        tel = (JaxTelemetry if side == "jax" else Telemetry)()
        pool = mod.StandbyPool(fake, num_standby=2, warmup=None,
                               telemetry=tel)
        pool.fill(lambda: fake.remote(EXECUTORS[side]).options().remote())
        ck = str(tmp_path / side / "ck")

        def make():
            t = _local(side, str(tmp_path / side), ck, tel=tel)
            cls = JaxRayLauncher if side == "jax" else RayLauncher
            t._launcher = cls(t.strategy, ray_module=fake,
                              gang=mod.GangConfig(heartbeat_timeout=30.0),
                              standby=pool)
            return t
        sup = mod.GangSupervisor(make, mod.RetryPolicy(max_attempts=3,
                                                       base_delay=0.0),
                                 sleep=lambda s: None, telemetry=tel,
                                 standby=pool)
        with mod.FaultPlan.at("train.step", [9]).armed():
            trainer = sup.fit(JaxBoringModel if side == "jax"
                              else BoringModel)
        pool.shutdown()
        seen[side] = (trainer.state, sup.restarts, pool.promotions,
                      sup.failures[0].reason,
                      sup.failures[0].postmortems[0].last_step,
                      [(e.site, e.payload) for e in tel.events()
                       if e.site in ELASTIC_SITES],
                      tel.metrics.snapshot()["gang_standby_promotions_total"])
    assert seen["port"] == seen["jax"]
    assert [s for s, _ in seen["port"][5]] == [
        "standby.promoted", "worker.error", "gang.teardown", "gang.restart",
        "standby.promoted"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_elastic_disarmed_zero_surface(tmp_path, pkg):
    """No pool, no store: no channel, no elastic event or counter."""
    fake = FAKES[pkg].FakeRay()
    tel = (JaxTelemetry if pkg == "jax" else Telemetry)()
    t = _local(pkg, str(tmp_path), str(tmp_path / "ck"), tel=tel,
               max_epochs=1)
    cls = JaxRayLauncher if pkg == "jax" else RayLauncher
    launcher = t._launcher = cls(t.strategy, ray_module=fake)
    t.fit(JaxBoringModel() if pkg == "jax" else BoringModel())
    assert launcher._memstore_channel is None
    assert launcher._memstore_driver is None and launcher._standby is None
    assert _sites(tel) == []
    snap = tel.metrics.snapshot()
    for name in ("gang_standby_promotions_total",
                 "gang_elastic_resizes_total", "ckpt_reshards_total"):
        assert name not in snap


# --------------------------- a world change at restart, real workers
@pytest.fixture(scope="module")
def world():
    w = tw.World(size=4)
    yield w
    w.ray.shutdown()


STRATEGIES = {"zero": (RayShardedStrategy, JaxShardedStrategy),
              "fsdp": (FSDPStrategy, JaxFSDPStrategy)}


class _JaxAdamBoring(JaxBoringModel):
    def configure_optimizers(self):
        return jax_make_optimizer("adamw", 1e-2)


def _world_fit(world, name, n, ck, max_epochs, resume=None):
    """The port's directory-checkpointed AdamW fit on ``n`` of the
    world's workers, its worker's probe (events, metrics) carried
    back."""
    probe = tw.EventProbe()
    trainer = Trainer(strategy=STRATEGIES[name][0](num_workers=n,
                                                   device="cpu"),
                      max_epochs=max_epochs, seed=0, limit_train_batches=3,
                      limit_val_batches=0, telemetry=Telemetry(),
                      callbacks=[ModelCheckpoint(dirpath=ck,
                                                 save_format="orbax"),
                                 probe])
    world.run(trainer, "fit", tw.AdamBoring(), ckpt_path=resume)
    return trainer, probe


def _jax_accounting(name, tmp_path, frm, to):
    """The JAX trainer's (global_step, epoch) after the same world
    change: a restore with nothing left, then one more epoch."""
    ck = str(tmp_path / "jax_ck")
    out = []
    for n, epochs, resume in ((frm, 2, None), (to, 2, "auto"),
                              (to, 3, "auto")):
        t = JaxTrainer(strategy=STRATEGIES[name][1](num_workers=n,
                                                    use_tpu=False),
                       max_epochs=epochs, seed=0, limit_train_batches=3,
                       limit_val_batches=0,
                       callbacks=[JaxModelCheckpoint(dirpath=ck,
                                                     save_format="orbax")],
                       default_root_dir=str(tmp_path / "jax"))
        t.fit(_JaxAdamBoring(), ckpt_path=resume)
        out.append((t.global_step, t.current_epoch))
    return out


@pytest.mark.multiproc
@pytest.mark.parametrize("name", sorted(STRATEGIES))
@pytest.mark.parametrize("frm,to", [(4, 2), (2, 4)])
def test_world_change_restores_element_identical(world, tmp_path, name,
                                                 frm, to):
    """Saved ``frm``-way, resumed ``to``-way: params and optimizer state
    element-identical to the checkpoint, ``ckpt.reshard`` with the JAX
    payload, and the step and epoch accounting of the JAX trainer."""
    ck = str(tmp_path / "ck")
    saved, _ = _world_fit(world, name, frm, ck, 2)
    host = load_sharded_checkpoint(find_resume_candidates(ck)[0])
    assert host["world"]["world_size"] == frm and host["global_step"] == 6
    # nothing left to train: the final state is the restore itself
    restored, probe = _world_fit(world, name, to, ck, 2, resume="auto")
    _identical(restored.train_state_dict["params"],
               host["state"]["params"])
    _identical(restored.train_state_dict["opt_state"]["state"],
               host["state"]["opt_state"]["state"])
    assert [e for e in probe.events if e[0] == "ckpt.reshard"] == [
        ("ckpt.reshard", {"from_world": frm, "to_world": to,
                          "global_step": 6})]
    assert probe.metrics["ckpt_reshards_total"] == 1
    more, _ = _world_fit(world, name, to, ck, 3, resume="auto")
    port = [(t.global_step, t.current_epoch)
            for t in (saved, restored, more)]
    assert port == _jax_accounting(name, tmp_path, frm, to)
