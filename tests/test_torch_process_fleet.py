"""The port's process replica fleet (``ray_lightning_tpu_torch/serve/process_fleet.py``) against the JAX package.

``tests/test_fleet_process.py``'s fast cases, on the port: the backend
switch, the ``_dead``-latch-first death classification and the
unmodified router scoring status mirrors (both held against the JAX
functions on the same inputs), one real 2-process fleet serving a
staggered wall-clock trace, and the poison request contained by exact
implication. Workers run on the CPU (``device="cpu"`` in the engine
kwargs) with one torch thread. A fleet's greedy f32 tokens are held
against the JAX ``ServeClient`` on the same flax weights (carried into
the port by ``load_flax_params``); routes, verdict names, counters and
``live_actor_count() == 0`` are checked as the JAX test checks them. The
chaos cases (kill -9, hang, tenancy, autoscaling) are in
``tests/test_torch_process_chaos.py``.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_lightning_tpu.serve as jax_serve
import ray_lightning_tpu.serve.process_fleet as jax_pf
from ray_lightning_tpu.models import TransformerLM as JaxLM
from ray_lightning_tpu.models import gpt2_config as jax_gpt2_config
import ray_lightning_tpu_torch.serve.process_fleet as pf
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.obs import Telemetry
from ray_lightning_tpu_torch.reliability import FaultPlan
from ray_lightning_tpu_torch.serve import (FINISH_FAILED, FleetConfig,
                                           ProcessReplicaFleet, ReplicaFleet)

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port, pytest.mark.fleet_process]

MK = dict(vocab_size=128, max_seq_len=64)


@pytest.fixture(scope="module")
def nano():
    """The JAX test's nano pair (decode model, flax params) and the
    port's model and state dict on the same weights."""
    mk = dict(MK, dtype=jnp.float32, scan_layers=False)
    dec = JaxLM(jax_gpt2_config("nano", decode=True, **mk))
    params = JaxLM(jax_gpt2_config("nano", **mk)).init(
        jax.random.PRNGKey(0), np.zeros((2, 4), np.int32))["params"]
    model = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, **MK), device="cpu"), params)
    return dec, params, model, model.state_dict()


def jax_ref(nano, reqs, **kw):
    """The JAX test's reference: an uninterrupted single JAX engine,
    sized to admit everything."""
    dec, params = nano[:2]
    kw.setdefault("num_slots", 8)
    kw.setdefault("prefill_len", 16)
    client = jax_serve.ServeClient(dec, params, **kw)
    out = client.serve_trace([(0, kw_) for kw_ in reqs])
    client.shutdown()
    return out


def port_fleet(nano, **kw):
    return ReplicaFleet(nano[2], nano[3], backend="process", device="cpu",
                        **kw)


# --------------------------------------------------------------------- #
# no process spawn: switch, classification, router mirrors
# --------------------------------------------------------------------- #
def test_backend_switch_validates_and_dispatches(nano):
    with pytest.raises(ValueError, match="backend must be"):
        ReplicaFleet(None, None, backend="threads")
    # the process backend is wall-clock by construction: rejected before
    # anything spawns
    with pytest.raises(ValueError, match="wall-clock only"):
        ReplicaFleet(None, None, backend="process", clock=time.monotonic)
    fleet = ReplicaFleet(nano[2], nano[3], num_replicas=1, num_slots=2,
                         prefill_len=8, device="cpu")
    try:
        assert type(fleet) is ReplicaFleet
        assert fleet.backend == "inproc"
    finally:
        fleet.shutdown()


class _FakeProc:
    def __init__(self, alive):
        self._alive = alive

    def is_alive(self):
        return self._alive


class _FakeHandle:
    def __init__(self, dead, proc_alive, killed=False):
        self._dead = dead
        self._proc = _FakeProc(proc_alive)
        self._killed = killed


@pytest.mark.parametrize("dead,proc_alive,crashed,want", [
    (True, True, True, "dead"),     # the latch wins over the crash flag
    (True, True, False, "dead"),    # ... and over a live-reading probe
    (False, False, False, "dead"),
    (False, True, True, "error"),
    (False, True, False, "hung"),
])
def test_classify_failure_consults_dead_latch_first(dead, proc_alive,
                                                    crashed, want):
    handle = _FakeHandle(dead, proc_alive)
    assert jax_pf._classify_failure(handle, crashed=crashed) == want
    assert pf._classify_failure(handle, crashed=crashed) == want


def _router_orders(mod, serve_mod):
    """The JAX test's router scenario on one package's mirrors: the
    orders the router gives, the class loads and the busy probes."""
    def seat(rid, **stats):
        rep = mod._ProcessReplica(rid, object(), {"max_replay_len": 64,
                                                  "tenancy": False})
        rep.apply_stats(stats)
        return rep

    router = serve_mod.Router()
    r0 = seat(0, queue_depth=2, active=1)             # load 3
    r1 = seat(1, active=1)                            # load 1
    r2 = seat(2, active=1, class_depths={"fast": 2})  # load 1, class 2
    req = serve_mod.Request(id=0, prompt=[1, 2], max_new_tokens=2,
                            tenant="fast")
    r3 = seat(3, active=1, free_pages=1, num_pages=4)  # 0.75 occupied
    r4 = seat(4, active=1, free_pages=3, num_pages=4)  # 0.25 occupied
    untenanted = serve_mod.Request(id=1, prompt=[1], max_new_tokens=2)
    return dict(
        order=[r.id for r in router.order([r0, r1, r2], req)],
        class_load=(serve_mod.Router.class_load(r1, req),
                    serve_mod.Router.class_load(r2, req)),
        paged=[r.id for r in router.order([r3, r4], untenanted)],
        busy=(seat(5).busy, seat(6, chunk_pending=1).busy))


def test_router_scores_status_mirrors_like_live_objects():
    """The unmodified in-process Router ranks process-backend mirror
    seats as it would rank live clients: load (queue + active +
    chunking), then per-class depth, then paged occupancy, id tiebreak
    last -- the port's ranking equal to the JAX package's."""
    import ray_lightning_tpu_torch.serve as serve
    got = _router_orders(pf, serve)
    assert got == _router_orders(jax_pf, jax_serve)
    assert got == dict(order=[1, 2, 0], class_load=(0, 2), paged=[4, 3],
                       busy=(False, True))


def test_shippable_never_carries_device_state(nano):
    """What crosses the construct pickle: the model as a meta module of
    the same config, tensors as detached host copies, a device as its
    name, nested containers mapped through."""
    model, sd = nano[2], nano[3]
    shipped = pf._shippable({"m": model, "sd": sd,
                             "device": torch.device("cpu"),
                             "pair": (sd["wte.weight"], 3)})
    assert type(shipped["m"]) is TransformerLM
    assert shipped["m"].cfg == model.cfg
    assert all(p.is_meta for p in shipped["m"].parameters())
    assert shipped["device"] == "cpu"
    assert torch.equal(shipped["pair"][0], sd["wte.weight"])
    assert not shipped["pair"][0].requires_grad
    assert shipped["pair"][1] == 3
    assert all(torch.equal(shipped["sd"][k], v) for k, v in sd.items())


# --------------------------------------------------------------------- #
# one real 2-process fleet: token identity, clean teardown
# --------------------------------------------------------------------- #
TRACE = [
    (0.0, dict(prompt=[5, 17, 3, 9], max_new_tokens=6)),
    (0.0, dict(prompt=[9, 2, 44], max_new_tokens=6)),
    (0.2, dict(prompt=[42, 7], max_new_tokens=5)),
    (0.3, dict(prompt=[1], max_new_tokens=6)),
]


@pytest.mark.multiproc
def test_process_fleet_smoke_token_identity(nano):
    """N=2 real worker processes serve a staggered wall-clock trace and
    emit exactly the JAX single engine's tokens; shutdown leaves zero
    live actor processes and keeps each worker's final stats."""
    tel = Telemetry()
    fleet = port_fleet(nano, num_replicas=2, num_slots=4, prefill_len=16,
                       telemetry=tel)
    assert isinstance(fleet, ReplicaFleet)
    assert type(fleet) is ProcessReplicaFleet
    assert fleet.backend == "process"
    try:
        out = fleet.serve_trace(TRACE)
        steps = dict(fleet.replica_steps)
        # launch_counts() reads what stop() will report; an idle
        # replica takes no step in between
        counts = {rep.id: fleet._ray.get(rep.actor.launch_counts.remote(),
                                         timeout=30)
                  for rep in fleet._replicas}
        # hot adapter churn is refused on this backend, as in JAX
        with pytest.raises(NotImplementedError, match="process"):
            fleet.load_adapter("a", {})
        with pytest.raises(NotImplementedError, match="process"):
            fleet.unload_adapter("a")
    finally:
        backend = fleet.process_backend
        fleet.shutdown()
    ref = jax_ref(nano, [kw for _, kw in TRACE])
    assert sorted(out) == sorted(ref)
    for rid in ref:
        assert out[rid].tokens == ref[rid].tokens, rid
        assert out[rid].finish_reason == ref[rid].finish_reason, rid
        assert out[rid].time_to_first_token is not None, rid
    # the two t=0 arrivals spread across both replicas, id tiebreak
    routes = [e.payload["replica"] for e in tel.events("fleet.route")]
    assert routes[:2] == [0, 1]
    # worker-side serve events forwarded over the queue transport
    assert tel.events("serve.submit")
    assert tel.events("serve.retire")
    # every replica's beats rode the heartbeat channel (a replica's
    # step starts at -1; beats are throttled, so the last count may lag)
    assert set(steps) == {0, 1} and all(s >= 0 for s in steps.values())
    assert fleet.replicas_live == 0
    assert backend.live_actor_count() == 0
    # each worker's stop(): its stats, its CPU run's zero launches
    assert sorted(fleet.final_stats) == [0, 1]
    for rid, stats in fleet.final_stats.items():
        assert stats["decode_steps"] > 0
        assert counts[rid] == {k: stats[k] for k in ("kernel_launches",
                                                     "decode_steps")}
        launches = stats["kernel_launches"]
        assert sum(launches["paged_attention"].values()) == 0
        assert sum(launches["quantized_matmul"].values()) == 0


@pytest.mark.multiproc
def test_a_busy_worker_admits_between_its_dispatch_turns(nano):
    """The port's own case: a submit RPC takes the worker's lock between
    two dispatch turns, so a replica busy decoding still admits and a
    burst builds the queue the router and the autoscaler read (the JAX
    worker's loop re-takes its lock at once, and a submit waits for the
    replica to go idle). Tokens are the JAX engine's."""
    reqs = [dict(prompt=[i + 1, 7], max_new_tokens=40) for i in range(12)]
    fleet = port_fleet(nano, num_replicas=1, num_slots=1, prefill_len=16)
    try:
        rep = fleet._replicas[0]
        depths = []
        for kw in reqs:
            fleet.submit(**kw)
            depths.append(rep.client.scheduler.depth)
        out = fleet.run_until_idle()
    finally:
        backend = fleet.process_backend
        fleet.shutdown()
    assert max(depths) >= 6, depths
    ref = jax_ref(nano, reqs)
    assert [out[r].tokens for r in sorted(out)] == [
        ref[r].tokens for r in sorted(ref)]
    assert backend.live_actor_count() == 0


# --------------------------------------------------------------------- #
# poison containment across the process boundary
# --------------------------------------------------------------------- #
ENGINE = dict(num_slots=2, prefill_len=32, steps_per_dispatch=2)
POISON_REQS = [
    dict(prompt=[5, 17, 3, 9], max_new_tokens=18),
    dict(prompt=[9, 2, 44], max_new_tokens=12),    # the poison pill
    dict(prompt=[42, 7, 1], max_new_tokens=18),
]


@pytest.mark.multiproc
def test_process_poison_contained_exact_implication(nano):
    """A poisoned request (it raises inside the worker's prefill, every
    time, on every replica) burns through its failover budget and
    retires ``failed``; co-batched innocents are implicated but
    exonerated, finishing token-identical to the JAX engine's
    uninterrupted run. The raise keeps the worker alive to ship the
    4-tuple ``MSG_CRASH``: the driver sees an ``error`` verdict with an
    exact implicated-id list."""
    tel = Telemetry()
    poison_id = 1
    with FaultPlan(poison=(poison_id,)).armed():
        fleet = port_fleet(
            nano, num_replicas=2, num_standby=1, telemetry=tel,
            fleet_config=FleetConfig(max_request_failovers=3,
                                     probation_after=2),
            **ENGINE)
        try:
            for kw in POISON_REQS:
                fleet.submit(**kw)
            out = fleet.run_until_idle()
        finally:
            backend = fleet.process_backend
            fleet.shutdown()
    assert out[poison_id].finish_reason == FINISH_FAILED
    assert fleet.poison_failed == 1
    assert fleet.failovers <= 3  # bounded by the request's budget
    # the worker survived to ship MSG_CRASH: error verdict, never dead
    errors = tel.events("replica.error")
    assert errors and not tel.events("replica.dead")
    assert all("InjectedFault" in e.payload["detail"] for e in errors)
    assert tel.events("fleet.poison_failed")
    innocents = [i for i in range(len(POISON_REQS)) if i != poison_id]
    ref = jax_ref(nano, [POISON_REQS[i] for i in innocents],
                  **{**ENGINE, "num_slots": 8})
    for ref_rid, fleet_rid in enumerate(innocents):
        assert out[fleet_rid].finish_reason != "failed", fleet_rid
        assert out[fleet_rid].tokens == ref[ref_rid].tokens, fleet_rid
    assert backend.live_actor_count() == 0
