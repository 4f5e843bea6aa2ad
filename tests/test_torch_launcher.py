"""The port's launchers and the rest of the multi-worker path.

In-process, on the ray-compatible fakes (``testing/fake_ray.py``), the
counterparts of the JAX package's ``tests/test_ray_launcher.py`` and of
the reference's rank tests (``ray_lightning/tests/test_ddp.py``):
``get_local_ranks``, the env broadcast (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, the seed), the per-node union of
``CUDA_VISIBLE_DEVICES`` and each rank's device index (cards Ray assigns,
or the host's cards handed out in rank order), the
``resources_per_worker`` rules (the JAX ``tests/test_ddp.py:140-158``
semantics), which launcher each argument picks, the rank-0 result, and
the helpers (``util``, ``accelerators``,
``launchers/utils``, ``Strategy.shard_batch``).

Across two spawned gloo workers (one module-scoped world): checkpoints
of a two-worker fit resume in one process and those of a one-process fit
in two, under DDP, ZeRO and FSDP, stream and directory, ending where the
writing run ended; ``async_save`` under a process group;
``resume="auto"`` after a fault, reading the same files on every rank;
``predict`` with two workers equals one, in order; a worker's exception
reaches the driver; too many card workers raise before any spawn.

The rendezvous port is probed on worker 0 and bound a moment later by
rank 0's store, and a world of another test file (``pytest -n``) may take
it in between. Rank 0 then fails at once with EADDRINUSE, the launch
fails and kills the pair rather than hanging, and ``torch_world.World.run``
runs the stage once more on a fresh pair and port (tested below by
holding the first port taken).
"""
import multiprocessing
import os
import socket
import threading

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (BoringModel, FSDPStrategy,
                                     HorovodRayStrategy, RayShardedStrategy,
                                     RayStrategy, Trainer)
from ray_lightning_tpu_torch import util
from ray_lightning_tpu_torch.accelerators import (ACCELERATOR_REGISTRY,
                                                  DelayedCUDAAccelerator,
                                                  resolve_accelerator)
from ray_lightning_tpu_torch.core import ModelCheckpoint
from ray_lightning_tpu_torch.core.seed import GLOBAL_SEED_ENV
from ray_lightning_tpu_torch.launchers import (ExecutorBase, LocalLauncher,
                                               ProcessRay, RayLauncher,
                                               WorkerOutput)
from ray_lightning_tpu_torch.launchers import ray_launcher as rl
from ray_lightning_tpu_torch.launchers.utils import (find_free_port,
                                                     get_node_ip,
                                                     set_executable_cls,
                                                     visible_gpu_ids)
from ray_lightning_tpu_torch.reliability import FaultPlan, InjectedFault
from ray_lightning_tpu_torch.testing import (FakeRay, RecordingExecutor,
                                             ThreadedFakeRay)

import torch_world as tw

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port


@pytest.fixture
def recording(monkeypatch):
    """RecordingExecutor (env writes to a dict) as the executor class."""
    RecordingExecutor.instances = []
    set_executable_cls(RecordingExecutor)
    yield
    set_executable_cls(None)


def _launcher(num_workers=2, ray=None, **kw):
    strategy = RayStrategy(num_workers=num_workers, device="cpu", **kw)
    return RayLauncher(strategy, ray_module=ray or FakeRay())


# ------------------------------------------------------------- rank maps
@pytest.mark.parametrize("ips,want", [
    (["a", "a", "a"], [(0, 0), (1, 0), (2, 0)]),
    (["a", "b", "a", "b"], [(0, 0), (0, 1), (1, 0), (1, 1)]),
    (["b", "a", "a"], [(0, 0), (0, 1), (1, 1)]),
])
def test_get_local_ranks(ips, want):
    assert RayLauncher.get_local_ranks(ips) == want


def test_setup_creates_one_actor_per_worker_and_broadcasts_env(
        recording, monkeypatch):
    """One actor per rank with the spec's resources; MASTER_ADDR/PORT,
    WORLD_SIZE and the driver's seed on every worker; the rank map on
    the strategy."""
    monkeypatch.setenv(GLOBAL_SEED_ENV, "123")
    ray = FakeRay()
    launcher = _launcher(3, ray=ray, num_cpus_per_worker=2)
    launcher.setup_workers()
    assert len(ray.created_actors) == 3
    opts = ray.created_actors[0]._options
    assert opts["num_cpus"] == 2 and opts["num_gpus"] == 0
    envs = [w.env for w in RecordingExecutor.instances]
    port = envs[0]["MASTER_PORT"]
    assert int(port) > 0
    for env in envs:
        assert env["MASTER_ADDR"] == "127.0.0.1"
        assert env["MASTER_PORT"] == port
        assert env["WORLD_SIZE"] == "3"
        assert env[GLOBAL_SEED_ENV] == "123"
        assert "CUDA_VISIBLE_DEVICES" not in env   # CPU workers
    assert launcher._strategy.global_to_local == [(0, 0), (1, 0), (2, 0)]
    launcher.teardown_workers()
    assert len(ray.killed_actors) == 3


class _Node1(RecordingExecutor):
    def node_ip(self):
        return "10.0.0.1"


class _Node2(RecordingExecutor):
    def node_ip(self):
        return "10.0.0.2"


def _card_launcher(ray, n):
    strategy = RayStrategy(num_workers=n, use_gpu=True)
    return RayLauncher(strategy, ray_module=ray)


def test_visible_device_union_with_assigned_cards():
    """Cards Ray assigns (one per actor): each node's workers see the
    node's union, and each rank's device index is its card's place in
    it (the reference's ``_share_cuda_visible_devices``)."""
    ray = FakeRay()
    cards = iter([3, 1, 0, 2])
    nodes = iter([_Node1, _Node2, _Node1, _Node2])
    launcher = _card_launcher(ray, 4)
    RecordingExecutor.instances = []

    def create(rank):
        cls = next(nodes)
        card = next(cards)
        ex = type(cls.__name__, (cls,), {"gpu_ids": lambda self: [card]})
        return ray.remote(ex).remote()

    launcher._create_worker = create
    launcher._check_enough_gpus = lambda: None
    launcher.setup_workers()
    envs = [w._instance.env["CUDA_VISIBLE_DEVICES"]
            for w in launcher._workers]
    assert envs == ["3,0", "1,2", "3,0", "1,2"]
    assert launcher._device_indices == [0, 0, 1, 1]
    assert launcher._strategy.global_to_local == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]


def test_visible_devices_handed_out_in_rank_order(recording, monkeypatch):
    """The subprocess backend assigns no card: each worker reports the
    host's visible set, and rank r takes its r-th card; a worker that
    sees none is left alone (its worker_setup raises)."""
    ray = FakeRay()
    ray.assigns_gpus = False
    launcher = _card_launcher(ray, 2)
    launcher._check_enough_gpus = lambda: None
    monkeypatch.setattr(RecordingExecutor, "gpu_ids",
                        lambda self: [4, 6, 7])
    launcher.setup_workers()
    assert [w.env["CUDA_VISIBLE_DEVICES"]
            for w in RecordingExecutor.instances] == ["4,6", "4,6"]
    assert launcher._device_indices == [0, 1]
    monkeypatch.setattr(RecordingExecutor, "gpu_ids", lambda self: [])
    RecordingExecutor.instances = []
    launcher.setup_workers()
    assert launcher._device_indices == [None, None]
    assert all("CUDA_VISIBLE_DEVICES" not in w.env
               for w in RecordingExecutor.instances)


def test_external_workers_are_reused_and_released(recording):
    ray = FakeRay()
    workers = [ray.remote(RecordingExecutor).remote() for _ in range(2)]
    strategy = RayStrategy(num_workers=2, device="cpu")
    launcher = RayLauncher(strategy, ray_module=ray, workers=workers)
    launcher.setup_workers()
    assert launcher._workers == workers
    launcher.teardown_workers()
    assert ray.killed_actors == []
    with pytest.raises(ValueError, match="same process count"):
        RayLauncher(RayStrategy(num_workers=3, device="cpu"),
                    ray_module=ray, workers=workers)


@pytest.mark.parametrize("what", ["gang", "standby"])
def test_gang_and_standby_wait_for_their_item(what):
    """Ported (T7): the launcher and the strategy take ``gang=`` and
    ``standby=``, the strategy hands them to the launcher it makes, and
    nothing is allocated before a launch (``tests/test_torch_gang.py``
    and ``tests/test_torch_elastic.py`` hold them)."""
    value = object()
    launcher = RayLauncher(RayStrategy(num_workers=2, device="cpu"),
                           ray_module=FakeRay(), **{what: value})
    assert getattr(launcher, f"_{what}") is value
    assert launcher._gang_channel is None \
        and launcher._memstore_channel is None
    strategy = RayStrategy(num_workers=2, device="cpu", **{what: value})
    assert getattr(strategy, what) is value
    assert getattr(strategy.configure_launcher(), f"_{what}") is value


# ------------------------------------------------------ resources, spec
@pytest.mark.parametrize("kw,want", [
    (dict(num_cpus_per_worker=1, resources_per_worker={"CPU": 3}),
     dict(num_cpus_per_worker=3, use_gpu=True, num_gpus_per_worker=1)),
    (dict(use_gpu=False, resources_per_worker={"GPU": 1}),
     dict(use_gpu=True, num_gpus_per_worker=1)),
    (dict(use_gpu=True), dict(use_gpu=True, num_gpus_per_worker=1)),
    (dict(device="cpu"), dict(use_gpu=False, num_gpus_per_worker=0)),
    (dict(device="cpu", resources_per_worker={"CPU": 2, "custom": 1}),
     dict(num_cpus_per_worker=2,
          additional_resources_per_worker={"custom": 1})),
    (dict(allow_colocated_workers=True), dict(allow_colocated_workers=True)),
])
def test_resources_per_worker_rules(kw, want):
    """Parity with ``ray_ddp.py:85-112``: a ``CPU`` entry beats
    ``num_cpus_per_worker``, a ``GPU`` entry beats ``use_gpu``;
    ``device=None`` means a card per worker."""
    s = RayStrategy(num_workers=2, **kw)
    for key, value in want.items():
        assert getattr(s, key) == value, key
    assert s.accelerator_name == ("_gpu" if s.use_gpu else "cpu")


@pytest.mark.parametrize("kw,exc", [
    (dict(resources_per_worker={"GPU": 2}), ValueError),
    (dict(resources_per_worker={"GPU": 0.5}), ValueError),
    (dict(resources_per_worker={"TPU": 1}), ValueError),
    (dict(use_tpu=True), ValueError),
    (dict(use_gpu=True, device="cpu"), ValueError),
    (dict(num_workers=0), ValueError),
    (dict(not_a_ddp_argument=1), TypeError),
])
def test_bad_specs_raise(kw, exc):
    kw = {"num_workers": 2, **kw}
    with pytest.raises(exc):
        RayStrategy(**kw)


def test_extra_keywords_per_strategy():
    s = RayStrategy(num_workers=2, device="cpu",
                    find_unused_parameters=True)
    assert s.extra_kwargs == {"find_unused_parameters": True}
    assert FSDPStrategy(num_workers=2, device="cpu",
                        reshard_after_forward=False).extra_kwargs
    with pytest.raises(TypeError):
        HorovodRayStrategy(num_workers=2, device="cpu", bucket_cap_mb=1)


def test_a_multi_worker_driver_resolves_no_device():
    s = RayStrategy(num_workers=2)   # card workers, no card needed here
    assert s.device is None and s.distributed_sampler_kwargs == dict(
        num_replicas=2, rank=0)
    with pytest.raises(RuntimeError, match="in each worker"):
        s.root_device


# ------------------------------------------------------- launcher choice
def _pick(monkeypatch, ray, **kw):
    monkeypatch.setattr(rl, "_import_ray", lambda: ray)
    return RayStrategy(device="cpu", **kw).configure_launcher()


def test_launcher_choice(monkeypatch):
    """Which launcher each argument picks (``strategies/base.py``)."""
    attached = FakeRay()
    attached.init()
    assert isinstance(_pick(monkeypatch, None), LocalLauncher)
    assert isinstance(_pick(monkeypatch, attached, use_ray=False),
                      LocalLauncher)
    two = _pick(monkeypatch, None, num_workers=2)
    assert isinstance(two, RayLauncher) and isinstance(two._ray, ProcessRay)
    assert two._ray.num_threads == 1 and two._ray.live_actor_count() == 0
    two = _pick(monkeypatch, attached, num_workers=2, use_ray=False)
    assert isinstance(two._ray, ProcessRay)
    ray = _pick(monkeypatch, attached)
    assert isinstance(ray, RayLauncher) and ray._ray is attached
    with pytest.raises(RuntimeError, match="use_ray=True"):
        _pick(monkeypatch, None, use_ray=True)
    with pytest.raises(RuntimeError, match="use_ray=True"):
        _pick(monkeypatch, FakeRay(), num_workers=2, use_ray=True)


def test_too_many_card_workers_raise_before_any_spawn(monkeypatch):
    """More card workers than visible cards: ``ValueError`` before a
    process is spawned (NCCL would fail mid-rendezvous)."""
    before = len(multiprocessing.active_children())
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    trainer = Trainer(strategy=RayStrategy(num_workers=2), max_steps=1)
    with pytest.raises(ValueError, match="visible GPU"):
        trainer.fit(BoringModel())
    assert len(multiprocessing.active_children()) == before


# ----------------------------------------------- a world of one, in-process
def test_fake_ray_world_of_one_is_bitwise_the_local_fit(recording):
    """A fit through the launcher on an in-process worker: a gloo process
    group of world size 1, DDP around the model, rank 0's results and
    its final state returned as a byte stream -- the params equal the
    local launcher's bitwise (an all-reduce of one rank is a copy)."""
    local = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=1,
                    limit_train_batches=3, limit_val_batches=1, seed=0)
    local.fit(tw.Nano())
    strategy = RayStrategy(num_workers=1, device="cpu")
    remote = Trainer(strategy=strategy, max_epochs=1,
                     limit_train_batches=3, limit_val_batches=1, seed=0)
    remote._launcher = RayLauncher(strategy, ray_module=FakeRay())
    remote.fit(tw.Nano())
    assert remote.train_state is None and remote.global_step == 3
    assert remote.callback_metrics == local.callback_metrics
    got = remote.train_state_dict["params"]
    for name, t in local.model.state_dict().items():
        assert torch.equal(got[name], t), name
    assert not torch.distributed.is_initialized()


def test_worker_setup_env_fallback_and_rank_check(monkeypatch):
    """Called with no arguments, ``worker_setup`` joins the world the env
    describes (gloo, world size 1 here) and checks its rank; teardown
    destroys the group."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(find_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    s = RayStrategy(num_workers=1, device="cpu")
    s.worker_setup(0)
    try:
        assert s.in_world and torch.distributed.get_world_size() == 1
        assert s.any_rank(True) and not s.any_rank(False)
        logs = s.reduce_logs({"a": torch.tensor(2.5), "n": 3})
        assert logs["a"].item() == 2.5 and logs["n"] == 3
        assert s.broadcast_object("x") == "x"
    finally:
        s.teardown()
    assert not torch.distributed.is_initialized() and not s.in_world


# ----------------------------------------------------------- the helpers
def test_state_stream_bytes_and_file_forms(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": 4,
             "nest": [torch.ones(2, dtype=torch.bfloat16)]}
    out = util.load_state_stream(util.to_state_stream(state))
    assert torch.equal(out["w"], state["w"]) and out["step"] == 4
    assert out["nest"][0].dtype == torch.bfloat16
    path = tmp_path / "s.pt"
    with open(path, "wb") as f:
        util.save_state_stream(state, f)
    with open(path, "rb") as f:
        assert torch.equal(util.load_state_stream(f)["w"], state["w"])


def test_metric_conversion_and_process_results():
    m = util.tensor_metrics_to_numpy(
        {"a": torch.tensor(1.5), "b": torch.ones(2), "c": 3,
         "d": np.float32(2.0)})
    assert m["a"] == 1.5 and isinstance(m["a"], float)
    assert isinstance(m["b"], np.ndarray) and m["c"] == 3
    assert util.numpy_metrics_to_device(m) == m
    ray = ThreadedFakeRay()
    late, soon = (ray.remote(ExecutorBase).remote() for _ in range(2))
    _GATES["a"], _GATES["b"] = threading.Event(), threading.Event()
    futures = [late.execute.remote(_wait_then, "a", "late"),
               soon.execute.remote(_wait_then, None, "soon")]
    threading.Timer(0.2, _GATES["a"].set).start()
    assert util.process_results(futures, ray) == ["late", "soon"]
    # a failed worker raises at once, while its peer is still blocked
    futures = [late.execute.remote(_wait_then, "b", "never"),
               soon.execute.remote(_raise, "rank 1 failed")]
    with pytest.raises(ValueError, match="rank 1 failed"):
        util.process_results(futures, ray)
    assert not futures[0].done()
    _GATES["b"].set()
    with pytest.raises(RuntimeError):
        util.Unavailable()


_GATES = {}


def _wait_then(gate, value):
    """``value``, once the event ``_GATES[gate]`` is set (at once for
    ``None``): task arguments cross a pickle, an event does not."""
    if gate is not None:
        assert _GATES[gate].wait(timeout=30)
    return value


def _raise(message):
    raise ValueError(message)


def test_accelerators():
    assert {"cpu", "gpu", "_gpu"} <= set(ACCELERATOR_REGISTRY)
    assert isinstance(resolve_accelerator("_gpu"), DelayedCUDAAccelerator)
    assert DelayedCUDAAccelerator.is_available()   # on any driver
    resolve_accelerator("cpu").setup_environment()
    with pytest.raises(KeyError):
        resolve_accelerator("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_accelerator("_gpu").on_train_start()


def test_rendezvous_helpers(monkeypatch):
    import socket
    port = find_free_port()
    with socket.socket() as s:
        s.bind(("", port))             # still bindable
    assert get_node_ip() == "127.0.0.1"
    assert ExecutorBase().get_node_ip() == "127.0.0.1"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,0,GPU-ab")
    assert visible_gpu_ids() == [2, 0, "GPU-ab"]
    assert ExecutorBase().get_node_and_gpu_ids() == (
        "127.0.0.1", [2, 0, "GPU-ab"])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert visible_gpu_ids() == []
    out = WorkerOutput(None, b"x", {}, {}, {})
    assert out.results is None and out.callback_states is None


def test_shard_batch_takes_this_ranks_rows():
    s = RayStrategy(num_workers=2, device="cpu")
    batch = (np.arange(8).reshape(4, 2), torch.arange(4), np.float32(1.0))
    assert s.shard_batch(batch) is batch            # no process group
    s._in_world = True
    s.set_world_ranks(1)
    x, y, z = s.shard_batch(batch)
    np.testing.assert_array_equal(x, [[4, 5], [6, 7]])
    assert y.tolist() == [2, 3] and z == 1.0
    with pytest.raises(ValueError, match="equal shards"):
        s.shard_batch((np.zeros((3, 2)),))
    with pytest.raises(ValueError, match="disagree"):
        s.shard_batch((np.zeros((4, 2)), np.zeros(2)))


# ------------------------------------------------ two spawned workers
@pytest.fixture(scope="module")
def world():
    w = tw.World()
    yield w
    w.ray.shutdown()
    assert w.ray.live_actor_count() == 0


STRATEGIES = {"ddp": RayStrategy, "zero": RayShardedStrategy,
              "fsdp": FSDPStrategy}
RUN = dict(max_epochs=1, limit_train_batches=4, limit_val_batches=0, seed=0)


def _fit(world, n, name, module, callbacks=(), ckpt_path=None, **kw):
    """A fit on ``n`` workers (1: in this process): (trainer, params)."""
    strategy = STRATEGIES[name](num_workers=n, device="cpu")
    trainer = Trainer(strategy=strategy, callbacks=list(callbacks),
                      **{**RUN, **kw})
    if n > 1:
        world.run(trainer, "fit", module, ckpt_path=ckpt_path)
    else:
        trainer.fit(module, ckpt_path=ckpt_path)
    state = trainer.train_state_dict["params"] if n > 1 \
        else trainer.model.state_dict()
    return trainer, tw.host(state)


def _assert_close(got, want, atol=1e-5):
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.multiproc
@pytest.mark.parametrize("fmt", ["stream", "orbax"])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
@pytest.mark.parametrize("saved_on,resumed_on", [(2, 1), (1, 2)])
def test_checkpoints_move_between_world_sizes(world, tmp_path, name, fmt,
                                              saved_on, resumed_on):
    """A run on ``saved_on`` workers saves after step 2 of 4 and ends;
    a run on ``resumed_on`` workers resumes from that checkpoint (mid
    epoch) and ends where the writing run ended. SGD with momentum keeps
    an optimizer state (consolidated on rank 0 under ZeRO, gathered
    under FSDP) whose updates stay linear in the gradients."""
    path = str(tmp_path / ("ck.ckpt" if fmt == "stream" else "ck.orbax"))
    _, want = _fit(world, saved_on, name, tw.Nano(opt="momentum"),
                   callbacks=[tw.SaveAt(2, path, fmt)])
    assert os.path.exists(path)
    trainer, got = _fit(world, resumed_on, name, tw.Nano(opt="momentum"),
                        ckpt_path=path)
    assert trainer.global_step == 4
    _assert_close(got, want)


@pytest.mark.multiproc
def test_async_save_under_a_process_group(world, tmp_path):
    """``async_save=True`` in a two-worker fit: each rank stages its
    tensors and writes in the background, rank 0 commits after every
    shard is in; the directory resumes in one process."""
    path = str(tmp_path / "ck.orbax")
    _, want = _fit(world, 2, "fsdp", tw.Nano(opt="momentum"),
                   callbacks=[tw.SaveAt(2, path, "orbax", async_save=True)])
    assert sorted(os.listdir(tmp_path)) == ["ck.orbax"]
    trainer, got = _fit(world, 1, "fsdp", tw.Nano(opt="momentum"),
                        ckpt_path=path)
    _assert_close(got, want)


@pytest.mark.multiproc
def test_resume_auto_reads_the_same_files_on_every_rank(world, tmp_path):
    """A two-worker fit with periodic directory checkpoints, killed at
    step 3 on every rank; ``resume="auto"`` on two workers finds the
    step-2 checkpoint on each rank and ends where an uninterrupted run
    ends."""
    ck = str(tmp_path / "ck")
    _, want = _fit(world, 2, "ddp", tw.Nano(opt="momentum"))

    def checkpointing():
        return [ModelCheckpoint(dirpath=ck, every_n_train_steps=2,
                                save_format="orbax", save_top_k=-1)]

    with pytest.raises(InjectedFault):
        with FaultPlan.at("train.step", [2]).armed():
            _fit(world, 2, "ddp", tw.Nano(opt="momentum"),
                 callbacks=checkpointing())
    assert os.listdir(ck) == ["epoch=0-step=2.orbax"]
    trainer, got = _fit(world, 2, "ddp", tw.Nano(opt="momentum"),
                        callbacks=checkpointing(), resume="auto")
    assert trainer.global_step == 4
    _assert_close(got, want)


@pytest.mark.multiproc
@pytest.mark.parametrize("name", ["ddp", "fsdp"])
def test_predict_with_two_workers_equals_one(world, name):
    """Each rank predicts its rows; the outputs are gathered in rank
    order, so rank 0 returns the global batch's, as one process does."""
    kw = dict(limit_predict_batches=2)
    one = Trainer(strategy=STRATEGIES[name](device="cpu"), seed=0, **kw)
    want = one.predict(tw.Nano())
    strategy = STRATEGIES[name](num_workers=2, device="cpu")
    two = Trainer(strategy=strategy, seed=0, **kw)
    got = world.run(two, "predict", tw.Nano())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (8, 32, 256)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)


@pytest.mark.multiproc
def test_a_worker_exception_reaches_the_driver():
    """Rank 1 raises in its first step while rank 0 waits in a
    collective: the driver re-raises rank 1's error at once and kills
    both workers; nothing hangs."""
    ray = ProcessRay(num_threads=1)
    strategy = RayStrategy(num_workers=2, device="cpu")
    trainer = Trainer(strategy=strategy, **RUN)
    trainer._launcher = RayLauncher(strategy, ray_module=ray)
    try:
        with pytest.raises(ValueError, match="rank 1 failed on purpose"):
            trainer.fit(tw.Failing(fail_rank=1))
        assert len(ray.created_actors) == 2
        assert ray.live_actor_count() == 0
    finally:
        ray.shutdown()



@pytest.mark.multiproc
def test_a_taken_rendezvous_port_is_retried_on_fresh_workers(world,
                                                              monkeypatch):
    """The first launch's rendezvous port is held by another socket:
    rank 0's store fails to bind it, the launch kills the pair, and
    ``World.run`` fits on a fresh pair and a fresh port."""
    taken = socket.socket()
    taken.bind(("", 0))
    taken.listen()
    port = taken.getsockname()[1]
    ports = [port]
    real = RayLauncher._setup_env_vars
    setups = []

    def first_port_taken(self):
        if ports:
            self._master_port = ports.pop()
        setups.append(self._master_port)
        real(self)

    monkeypatch.setattr(RayLauncher, "_setup_env_vars", first_port_taken)
    killed = len(world.ray.killed_actors)
    trainer = Trainer(strategy=RayStrategy(num_workers=2, device="cpu"),
                      **{**RUN, "limit_train_batches": 2})
    try:
        world.run(trainer, "fit", tw.Nano(opt="sgd"))
    finally:
        taken.close()
    assert trainer.global_step == 2
    assert setups[0] == port and len(setups) == 2 and setups[1] != port
    assert len(world.ray.killed_actors) == killed + 2
    assert not any(w._killed for w in world.workers)


@pytest.mark.multiproc
def test_a_reply_that_does_not_unpickle_still_resolves(world):
    """A worker's exception that pickles there but not on the driver
    fails its call with an error, instead of killing the reader thread
    and leaving the caller waiting forever (what the JAX package's
    ``ProcessRay`` does: ``ROADMAP.md`` C)."""
    world.launcher(RayStrategy(num_workers=2, device="cpu"))
    worker = world.workers[0]
    with pytest.raises(RuntimeError, match="could not be unpickled"):
        world.ray.get(worker.execute.remote(tw.raise_two_arg_error),
                      timeout=60)
    assert world.ray.get(worker.execute.remote(os.getpid)) > 0


@pytest.mark.multiproc
def test_large_payloads_cross_through_a_file(world):
    """A call or a result above ``INLINE_BYTES`` (a GPT-2-small state
    stream is 1.49 GB) goes through a temporary file, both ways, and the
    file is removed once read."""
    import tempfile

    from ray_lightning_tpu_torch.launchers.process_backend import \
        INLINE_BYTES
    world.launcher(RayStrategy(num_workers=2, device="cpu"))
    worker = world.workers[0]
    size = INLINE_BYTES + 4096
    assert world.ray.get(worker.execute.remote(len, bytes(size))) == size
    out = world.ray.get(worker.execute.remote(bytes, size))
    assert len(out) == size and not any(out)
    assert not [f for f in os.listdir(tempfile.gettempdir())
                if f.startswith("processray-")]
