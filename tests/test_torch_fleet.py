"""The port's in-process replica fleet (``ray_lightning_tpu_torch/serve/fleet.py``) against the JAX package's.

Each scenario of ``tests/test_fleet.py`` (and the fleet cases of
``tests/test_journal.py``, ``tests/test_lora.py`` and
``tests/test_tenancy.py``) runs once on each package's fleet, on the
``serve_nano_family`` shapes (vocab 128, max_seq_len 32, f32, unrolled),
with the same trace and the same ``FaultPlan``. The two runs must agree
exactly: greedy tokens, every completion's finish reason and tick-clock
stamps (arrival, first token, finish), the order completions left
``tick()``, the fleet's counters (``failovers``, ``readmitted``,
``readmit_failed``, ``scale_outs``, ``scale_ins``, ``poison_failed``)
and, where the scenario arms telemetry, the tick-clock JSONL event log
line for line. There is no float tolerance: greedy tokens are compared
by identity, and every stamp is a tick count.

Sampled streams cannot match across frameworks (torch cannot reproduce
threefry keys), so a sampled request is held by its stamps, finish
reason and token count against JAX, and by its tokens against the
port's own fault-free single client. The JAX test's own assertions
(event order, promotions, drains, gauges) are then checked on the
port's run.
"""
import dataclasses
import gc
import logging
import weakref

import numpy as np
import pytest
import torch

import ray_lightning_tpu.obs as jax_obs
import ray_lightning_tpu.reliability as jax_rel
import ray_lightning_tpu.serve as jax_serve
from ray_lightning_tpu.models import lora as jax_lora
from ray_lightning_tpu.serve import engine as jax_engine_mod
import ray_lightning_tpu_torch.obs as obs
import ray_lightning_tpu_torch.reliability as rel
import ray_lightning_tpu_torch.serve as serve
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.serve import engine as engine_mod

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

MK = dict(vocab_size=128, max_seq_len=32)
TRACE = [
    (0, dict(prompt=[5, 17, 3, 9], max_new_tokens=6)),
    (0, dict(prompt=[9, 2, 44], max_new_tokens=6)),
    (3, dict(prompt=[42, 7], max_new_tokens=5)),
    (5, dict(prompt=[1], max_new_tokens=6)),
]
DENSE = dict(num_slots=2, prefill_len=16)
#: the paged, chunked replica shape of the chaos scenario
PAGED = dict(num_slots=2, prefill_len=16, page_size=4, num_pages=32,
             prefill_chunk=8)
RANK, CAP = 2, 2
ATRACE = [
    (0, dict(prompt=[1, 2, 3], max_new_tokens=6, adapter="a", seed=100)),
    (0, dict(prompt=[2, 2, 3], max_new_tokens=6, adapter="b", seed=101)),
    (1, dict(prompt=[3, 2, 3], max_new_tokens=6, seed=102)),
    (2, dict(prompt=[4, 2, 3], max_new_tokens=5, adapter="a",
             temperature=0.9, seed=103)),
]
MIXED_TRACE = [
    (0, dict(prompt=[11, 12], max_new_tokens=5, tenant="bulk")),
    (0, dict(prompt=[13, 14, 9], max_new_tokens=5, tenant="bulk")),
    (0, dict(prompt=[15], max_new_tokens=4, tenant="fast")),
    (1, dict(prompt=[16, 8], max_new_tokens=4, tenant="fast",
             temperature=0.8, top_k=12)),
    (2, dict(prompt=[4, 2, 6], max_new_tokens=4)),
    (4, dict(prompt=[7, 7], max_new_tokens=3, tenant="bulk")),
]
WORK = [
    dict(prompt=[1, 2], max_new_tokens=2, seed=103),
    dict(prompt=[5, 17, 3, 9], max_new_tokens=6, seed=100),
    dict(prompt=[9, 2, 44], max_new_tokens=6, seed=101),
    dict(prompt=[42, 7], max_new_tokens=6, seed=102),
]


def _chunk_trace():
    rng = np.random.default_rng(3)
    long1 = [int(t) for t in rng.integers(0, 128, size=20)]
    long2 = [int(t) for t in rng.integers(0, 128, size=24)]
    return [
        (0, dict(prompt=[5, 17, 3, 9], max_new_tokens=8)),
        (0, dict(prompt=long1, max_new_tokens=8)),
        (1, dict(prompt=[9, 2, 44], max_new_tokens=8)),
        (4, dict(prompt=long2, max_new_tokens=6)),
        (6, dict(prompt=[42, 7], max_new_tokens=6)),
    ]


def _rand_adapter(params, seed):
    rng = np.random.default_rng(seed)
    tree = jax_lora.extract_adapter(jax_lora.install_lora_bank(
        params, jax_lora.LoraConfig(rank=RANK, num_adapters=1)), 0)

    def fill(t):
        return {k: fill(v) if isinstance(v, dict) else
                (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in sorted(t.items())}
    return fill(tree)


def _sync_refill(fleet):
    """Refill the standby pool on the calling thread: a background
    refill races the next failover (warm or cold promotion), which would
    make two runs' event logs differ by timing alone."""
    if fleet.standby is not None:
        fleet.standby.refill_async = fleet.standby.fill
    return fleet


@dataclasses.dataclass
class Side:
    """One package's fleet surface and weights."""
    jax: bool
    serve: object
    rel: object
    obs: object
    engine_mod: object
    model: object
    params: object
    ads: dict

    def fleet(self, **kw):
        if not self.jax:
            kw["device"] = "cpu"
        return _sync_refill(self.serve.ReplicaFleet(self.model, self.params,
                                                    **kw))

    def client(self, **kw):
        if not self.jax:
            kw["device"] = "cpu"
        return self.serve.ServeClient(self.model, self.params, **kw)

    def restore(self, path, **kw):
        if not self.jax:
            kw["device"] = "cpu"
        return self.serve.ReplicaFleet.restore(path, self.model,
                                               self.params, **kw)

    def plan(self, site, ticks):
        return self.rel.FaultPlan.at(site, ticks)


@pytest.fixture(scope="module")
def sides(serve_nano_family):
    dec, params = serve_nano_family[:2]
    target = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, **MK), device="cpu"), params)
    ads = {"a": _rand_adapter(params, 1), "b": _rand_adapter(params, 2)}
    return (Side(True, jax_serve, jax_rel, jax_obs, jax_engine_mod, dec,
                 params, ads),
            Side(False, serve, rel, obs, engine_mod, target,
                 target.state_dict(), ads))


class Run:
    """One scenario's run on one side: the fleet, its completions, the
    ids in the order ``tick()`` returned them, and (armed) the event log
    and the telemetry handle."""

    def __init__(self, side, tmp_path, armed=True):
        self.side = side
        self.order = []
        self.tel = None
        self.path = None
        if armed:
            self.path = str(tmp_path / ("jax.jsonl" if side.jax
                                        else "port.jsonl"))
            self.tel = side.obs.Telemetry(jsonl_path=self.path)

    def fleet(self, **kw):
        if self.tel is not None:
            kw["telemetry"] = self.tel
        fleet = self.side.fleet(**kw)
        tick = fleet.tick

        def recording_tick():
            done = tick()
            self.order.extend(c.request_id for c in done)
            return done

        fleet.tick = recording_tick
        return fleet

    def armed(self, plan=None):
        """Telemetry activated (the global channels) and ``plan`` armed."""
        import contextlib
        stack = contextlib.ExitStack()
        if self.tel is not None:
            stack.enter_context(self.tel.activated())
        if plan is not None:
            stack.enter_context(plan.armed())
        return stack

    def lines(self):
        if self.tel is None:
            return []
        self.tel.flush()
        with open(self.path) as f:
            return f.read().splitlines()


def _stamps(out):
    return {rid: (c.finish_reason, c.arrival_time, c.first_token_time,
                  c.finish_time, c.tenant, c.adapter, len(c.tokens))
            for rid, c in out.items()}


def _counters(fleet):
    return (fleet.failovers, fleet.readmitted, fleet.readmit_failed,
            fleet.scale_outs, fleet.scale_ins, fleet.poison_failed)


def _record(run, fleet, out, greedy=None):
    """Everything two runs must agree on. ``greedy``: the request ids
    whose tokens are compared (all when None)."""
    tokens = {rid: c.tokens for rid, c in out.items()
              if greedy is None or rid in greedy}
    return dict(stamps=_stamps(out), tokens=tokens, order=list(run.order),
                counters=_counters(fleet), lines=run.lines())


def _both(sides, tmp_path, scenario, armed=True):
    """``scenario(run)`` on the JAX fleet, then on the port's; every entry
    of the two records must agree, except those whose key starts with
    ``_`` (what only the port's run is held to). Returns the port's."""
    records = [scenario(Run(side, tmp_path, armed=armed))
               for side in sides]
    want, got = records
    for key in want:
        if key.startswith("_"):
            continue
        if key == "lines":
            assert len(got[key]) == len(want[key])
            for i, (a, b) in enumerate(zip(want[key], got[key])):
                assert b == a, (i, a, b)
        else:
            assert got[key] == want[key], key
    return got


def _port_single(sides, trace, **kw):
    """The port's uninterrupted single client, sized to admit everything
    (the greedy reference every fleet scenario is also held to)."""
    kw.setdefault("num_slots", 8)
    kw.setdefault("prefill_len", 32)
    client = sides[1].client(**kw)
    out = client.serve_trace(list(trace))
    client.shutdown()
    return out


def _sites(lines, names):
    import json
    return [json.loads(line)["site"] for line in lines
            if json.loads(line)["site"] in names]


# ------------------------------------------------------------------ routing
def test_fleet_greedy_matches_jax_and_single_engine(sides, tmp_path):
    def scenario(run):
        fleet = run.fleet(num_replicas=3, **DENSE)
        with run.armed():
            out = fleet.serve_trace(TRACE)
        rec = _record(run, fleet, out)
        rec["decisions"] = fleet.router.decisions
        fleet.shutdown()
        rec["live_after"] = fleet.replicas_live
        return rec

    got = _both(sides, tmp_path, scenario)
    ref = _port_single(sides, TRACE, prefill_len=16)
    assert got["tokens"] == {rid: c.tokens for rid, c in ref.items()}
    assert got["decisions"] == len(TRACE) and got["live_after"] == 0


def test_router_prefers_affine_replica_for_shared_prefix(sides, tmp_path):
    shared = list(range(40, 56))  # 16 tokens = 2 chunks
    trace = [(0, dict(prompt=shared + [1, 2], max_new_tokens=4)),
             (16, dict(prompt=shared + [7, 8, 9], max_new_tokens=4))]

    def scenario(run):
        fleet = run.fleet(num_replicas=3, num_slots=2, prefill_len=16,
                          page_size=4, num_pages=48, prefill_chunk=8,
                          prefix_cache=True)
        with run.armed():
            out = fleet.serve_trace(trace)
        rec = _record(run, fleet, out)
        rec["hits"] = (fleet.router.affinity_hits,
                       [c.prefix_hit_tokens for c in out.values()])
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["hits"][0] == 1 and got["hits"][1][1] > 0
    ref = _port_single(sides, trace, page_size=4, num_pages=96,
                       prefill_chunk=8, prefix_cache=True)
    assert got["tokens"] == {rid: c.tokens for rid, c in ref.items()}


def test_all_replicas_full_raises_aggregated_queue_full(sides, tmp_path):
    def scenario(run):
        s = run.side
        fleet = run.fleet(num_replicas=2, num_slots=1, prefill_len=8,
                          scheduler_config=s.serve.SchedulerConfig(
                              max_queue_depth=1))
        with run.armed():
            fleet.submit([3, 1], max_new_tokens=12)
            fleet.submit([3, 2], max_new_tokens=12)
            fleet.tick()
            fleet.submit([3, 3], max_new_tokens=12)
            fleet.submit([3, 4], max_new_tokens=12)
            with pytest.raises(s.serve.QueueFull) as err:
                fleet.submit([3, 5], max_new_tokens=12)
            exc = err.value
            assert isinstance(exc, s.serve.FleetSaturated)
            out = fleet.run_until_idle()
        rec = _record(run, fleet, out)
        rec["exc"] = (exc.queue_depth, exc.replicas, exc.oldest_age,
                      str(exc))
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    depth, replicas, oldest, text = got["exc"]
    assert depth == 2 and replicas == 2 and oldest >= 0
    assert "queue_depth=2" in text
    assert all(s[0] != "failed" for s in got["stamps"].values())


# ----------------------------------------------------------------- failover
def test_fleet_chaos_failover_token_identity(sides, tmp_path):
    """A kill mid-chunked-prefill and one mid-decode on a 3-replica
    paged fleet with warm standbys: tokens equal the single engine's and
    JAX's, and failover -> replay -> promoted is the event order."""
    trace = _chunk_trace()

    def scenario(run):
        fleet = run.fleet(num_replicas=3, num_standby=2, **PAGED)
        plan = run.side.plan("serve.replica", [4, 12])
        with run.armed(plan):
            out = fleet.serve_trace(trace)
        rec = _record(run, fleet, out)
        rec["fired"] = plan.fired
        rec["live"] = fleet.replicas_live
        snap = run.tel.metrics.snapshot()
        rec["snap"] = {k: snap[k] for k in (
            "serve_fleet_failovers_total",
            "serve_fleet_readmitted_requests_total",
            "serve_fleet_replicas_live")}
        rec["router_load_count"] = snap["serve_fleet_router_load"]["count"]
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["fired"] == 2 and got["counters"][0] == 2
    ref = _port_single(sides, trace, page_size=4, num_pages=96,
                       prefill_chunk=8)
    assert got["tokens"] == {rid: c.tokens for rid, c in ref.items()}
    assert all(s[0] != "failed" for s in got["stamps"].values())
    import json
    fails = [json.loads(x)["payload"] for x in got["lines"]
             if json.loads(x)["site"] == "fleet.failover"]
    assert fails[0]["chunking"] == 1 and fails[0]["dead"]
    assert fails[1]["chunking"] == 0 and fails[1]["in_flight"] == 1
    assert _sites(got["lines"], ("fleet.failover", "recovery.replay",
                                 "fleet.replica_promoted")) == [
        "fleet.failover", "recovery.replay", "fleet.replica_promoted"] * 2
    assert got["live"] == 3
    assert got["snap"]["serve_fleet_failovers_total"] == 2
    assert got["snap"]["serve_fleet_readmitted_requests_total"] >= 2
    assert got["router_load_count"] >= len(trace)


def test_fleet_failover_sampled_replay_exact(sides, tmp_path):
    trace = [
        (0, dict(prompt=[5, 17, 3], max_new_tokens=8, temperature=0.9,
                 top_k=20, seed=11)),
        (1, dict(prompt=[9, 2], max_new_tokens=8, temperature=0.7,
                 seed=23, eos_id=100)),
        (2, dict(prompt=[42], max_new_tokens=8, eos_id=100)),
    ]

    def scenario(run):
        fleet = run.fleet(num_replicas=3, num_standby=1, **DENSE)
        plan = run.side.plan("serve.replica", [9])
        with run.armed(plan):
            out = fleet.serve_trace(trace)
        rec = _record(run, fleet, out, greedy={2})
        rec["fired"] = plan.fired
        rec["_tokens"] = {rid: c.tokens for rid, c in out.items()}
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["fired"] == 1 and got["counters"][0] == 1
    # the sampled streams continue across the kill: the port's own
    # uninterrupted single client's tokens, request by request
    ref = _port_single(sides, trace, prefill_len=16)
    assert got["_tokens"] == {rid: c.tokens for rid, c in ref.items()}


def test_failover_preserves_timing_fields_and_deadline(sides, tmp_path):
    """Across a mid-decode kill the re-admitted request keeps its arrival
    and first-token stamps, and its submit-time deadline still fires."""
    trace = [
        (0, dict(prompt=[5, 17, 3, 9], max_new_tokens=6)),
        (0, dict(prompt=[9, 2, 44], max_new_tokens=24, deadline=14.0)),
        (3, dict(prompt=[42, 7], max_new_tokens=6)),
        (5, dict(prompt=[1], max_new_tokens=6)),
    ]

    def scenario(run):
        recs = []
        for ticks in (None, [7]):
            fleet = run.fleet(num_replicas=3, num_standby=1, **DENSE)
            plan = None if ticks is None else run.side.plan(
                "serve.replica", ticks)
            with run.armed(plan):
                out = fleet.serve_trace(trace)
            recs.append((_stamps(out),
                         {r: c.tokens for r, c in out.items()},
                         _counters(fleet)))
            fleet.shutdown()
        return dict(runs=recs, lines=run.lines())

    got = _both(sides, tmp_path, scenario)
    (base, base_tok, _), (out, out_tok, counters) = got["runs"]
    assert counters[0] == 1
    victim, ref = out[1], base[1]
    assert victim[1] == ref[1] == 0.0                  # arrival
    assert victim[2] == ref[2] is not None             # no re-stamp
    assert victim[0] == ref[0] == "timeout" and victim[3] >= 14.0
    assert out_tok[1] and out_tok[1] == base_tok[1][:len(out_tok[1])]
    for rid in (0, 2, 3):
        assert out_tok[rid] == base_tok[rid] and out[rid][1] == base[rid][1]


def test_hang_detection_drains_stalled_replica(sides, tmp_path):
    def scenario(run):
        s = run.side
        fleet = run.fleet(num_replicas=3, num_standby=1,
                          fleet_config=s.serve.FleetConfig(
                              heartbeat_timeout=3.0), **DENSE)
        plan = s.rel.FaultPlan([s.rel.FaultSpec(
            "serve.replica", 4, mode="stall", stall_s=0.0)])
        with run.armed(plan):
            out = fleet.serve_trace(TRACE)
        rec = _record(run, fleet, out)
        rec["fired"] = plan.fired
        rec["failover"] = run.tel.events("fleet.failover")[0].payload
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["fired"] == 1 and got["counters"][0] == 1
    assert got["failover"]["dead"] is False
    assert 3.0 < got["failover"]["beat_age"] <= 5.0
    ref = _port_single(sides, TRACE, prefill_len=16)
    assert got["tokens"] == {rid: c.tokens for rid, c in ref.items()}


def test_hang_clock_survives_membership_churn(sides, tmp_path):
    def scenario(run):
        s = run.side
        fleet = run.fleet(num_replicas=3, num_standby=2,
                          fleet_config=s.serve.FleetConfig(
                              heartbeat_timeout=6.0), **DENSE)
        plan = s.rel.FaultPlan([
            s.rel.FaultSpec("serve.replica", 4, mode="stall", stall_s=0.0),
            s.rel.FaultSpec("serve.replica", 7)])
        with run.armed(plan):
            out = fleet.serve_trace(TRACE)
        rec = _record(run, fleet, out)
        rec["hang"] = [e.payload for e in run.tel.events("fleet.failover")
                       if e.payload["dead"] is False]
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["counters"][0] == 2 and len(got["hang"]) == 1
    assert got["hang"][0]["last_dispatch"] >= 1
    assert 6.0 < got["hang"][0]["beat_age"] <= 8.0
    assert all(s[0] != "failed" for s in got["stamps"].values())


@pytest.mark.parametrize("case", ["sole-replica", "crash-at-first-prefill",
                                  "pool-empty-at-kill"])
def test_failover_variants_match_jax(sides, tmp_path, case):
    """A sole replica killed mid-decode promotes before it replays; a
    ``serve.dispatch`` crash at a replica's first prefill loses none of
    the popped batch; a kill that finds the standby pool empty is caught
    up cold at the next tick."""
    replicas, site, ticks = {"sole-replica": (1, "serve.replica", [3]),
                             "crash-at-first-prefill":
                                 (2, "serve.dispatch", [0]),
                             "pool-empty-at-kill":
                                 (3, "serve.replica", [3])}[case]

    def scenario(run):
        fleet = run.fleet(num_replicas=replicas, num_standby=1, **DENSE)
        if case == "pool-empty-at-kill":
            fleet.standby.take().shutdown()
        plan = run.side.plan(site, ticks)
        with run.armed(plan):
            out = fleet.serve_trace(TRACE)
        rec = _record(run, fleet, out)
        rec["live"] = fleet.replicas_live
        rec["promoted"] = [e.payload for e in
                           run.tel.events("fleet.replica_promoted")]
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["counters"][0] == 1 and got["live"] == replicas
    ref = _port_single(sides, TRACE, prefill_len=16)
    assert got["tokens"] == {rid: c.tokens for rid, c in ref.items()}
    if case == "pool-empty-at-kill":
        assert got["promoted"][0]["source"] == "cold"
        assert got["promoted"][0]["replicas_live"] == 3


def test_post_admission_crash_does_not_duplicate_requests(sides, tmp_path,
                                                          monkeypatch):
    """A crash inside the prefill after admission seated the batch: the
    failover snapshot re-admits it once, the queue not at all."""
    def scenario(run):
        mod = run.side.engine_mod
        name = ("_prefill_inject_plain" if run.side.jax
                else "_prefill_inject_impl")
        real = getattr(mod, name)
        state = {"crashed": False}

        def crash_once(*args, **kwargs):
            if not state["crashed"]:
                state["crashed"] = True
                raise RuntimeError("device preempted mid-dispatch")
            return real(*args, **kwargs)

        monkeypatch.setattr(mod, name, crash_once)
        fleet = run.fleet(num_replicas=2, num_standby=1, **DENSE)
        with run.armed():
            out = fleet.serve_trace(TRACE)
        monkeypatch.setattr(mod, name, real)
        rec = _record(run, fleet, out)
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["counters"][:2] == (1, 1)
    ref = _port_single(sides, TRACE, prefill_len=16)
    assert got["tokens"] == {rid: c.tokens for rid, c in ref.items()}


def test_expiry_completion_on_crash_tick_is_not_lost(sides, tmp_path):
    def scenario(run):
        fleet = run.fleet(num_replicas=1, num_standby=1, num_slots=1,
                          prefill_len=8)
        fleet.submit([5, 17], max_new_tokens=3)
        fleet.submit([9, 2], max_new_tokens=4, deadline=3.0)
        fleet.submit([42, 7], max_new_tokens=3)
        plan = run.side.plan("serve.dispatch", [3])
        with run.armed(plan):
            out = fleet.run_until_idle()
        rec = _record(run, fleet, out)
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert sorted(got["stamps"]) == [0, 1, 2]
    assert got["stamps"][1][0] == "timeout"
    assert got["stamps"][1][3] is not None
    assert len(got["tokens"][2]) == 3 and got["counters"][0] == 1


def test_standby_promotion_and_background_refill(sides, tmp_path):
    def scenario(run):
        fleet = run.fleet(num_replicas=2, num_standby=1, **DENSE)
        before = fleet.standby.available()
        plan = run.side.plan("serve.replica", [2])
        with run.armed(plan):
            out = fleet.serve_trace(TRACE)
        thread = fleet.standby._refill_thread
        if thread is not None:
            thread.join(timeout=30)
        rec = _record(run, fleet, out)
        rec["pool"] = (before, fleet.standby.promotions,
                       fleet.replicas_live, fleet.standby.available())
        fleet.shutdown()
        rec["pool_after"] = fleet.standby.available()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["pool"] == (1, 1, 2, 1) and got["pool_after"] == 0


def test_unreplayable_request_fails_with_partial_tokens(sides, tmp_path):
    def scenario(run):
        fleet = run.fleet(num_replicas=1, num_slots=1, prefill_len=8)
        plan = run.side.plan("serve.replica", [5])
        logging.disable(logging.ERROR)
        try:
            with run.armed(plan):
                fleet.submit([5, 17, 3, 9], max_new_tokens=10)
                fleet.run_until_idle()
        finally:
            logging.disable(logging.NOTSET)
        rid = fleet.submit([1, 2], max_new_tokens=3)
        out = fleet.run_until_idle()
        rec = _record(run, fleet, out)
        rec["live"] = fleet.replicas_live
        rec["rid"] = rid
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["stamps"][0][0] == "failed" and len(got["tokens"][0]) == 5
    assert got["counters"][2] == 1 and got["live"] == 1
    assert got["stamps"][got["rid"]][0] != "failed"
    assert len(got["tokens"][got["rid"]]) == 3


# --------------------------------------------------------------- autoscaler
def test_autoscaler_scales_out_under_pressure_and_drains_back(sides,
                                                              tmp_path):
    trace = [(0, dict(prompt=[7, i + 1], max_new_tokens=6))
             for i in range(6)]

    def scenario(run):
        fleet = run.fleet(
            num_replicas=1, num_standby=1, num_slots=1, prefill_len=8,
            fleet_config=run.side.serve.FleetConfig(
                autoscale=True, min_replicas=1, max_replicas=2,
                scale_out_queue_depth=2.0, hysteresis=2))
        with run.armed():
            out = fleet.serve_trace(trace)
            for _ in range(12):
                fleet.tick()
        rec = _record(run, fleet, out)
        rec["scale_out"] = run.tel.events("fleet.scale_out")[0].payload
        rec["live"] = fleet.replicas_live
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["counters"][3] >= 1 and got["counters"][4] == 1
    assert got["scale_out"]["source"] == "standby"
    assert got["scale_out"]["replicas_live"] == 2 and got["live"] == 1
    assert _sites(got["lines"], ("fleet.replica_draining",
                                 "fleet.scale_in")) == [
        "fleet.replica_draining", "fleet.scale_in"]
    ref = _port_single(sides, trace, prefill_len=8)
    assert got["tokens"] == {rid: c.tokens for rid, c in ref.items()}


def test_draining_replica_finishes_in_flight_work(sides, tmp_path):
    def scenario(run):
        fleet = run.fleet(num_replicas=2, num_slots=1, prefill_len=8,
                          fleet_config=run.side.serve.FleetConfig(
                              autoscale=True, min_replicas=1,
                              max_replicas=2, hysteresis=1))
        with run.armed():
            fleet.submit([5, 1], max_new_tokens=10)
            fleet.submit([5, 2], max_new_tokens=10)
            fleet.tick()
            fleet.tick()
            drained = [r.id for r in fleet._replicas if r.draining]
            out = fleet.run_until_idle()
            for _ in range(3):
                fleet.tick()
        rec = _record(run, fleet, out)
        rec["drained"] = drained
        rec["live"] = fleet.replicas_live
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["drained"] == [1] and got["live"] == 1
    assert len(got["tokens"][0]) == 10 and len(got["tokens"][1]) == 10


# ---------------------------------------------- configs, determinism, gauges
def test_config_validation_matches_jax():
    for side in (jax_serve, serve):
        for kw in (dict(heartbeat_timeout=0.0), dict(min_replicas=0),
                   dict(min_replicas=3, max_replicas=2),
                   dict(hysteresis=0), dict(max_request_failovers=0),
                   dict(probation_after=0), dict(flap_window=0.0),
                   dict(flap_threshold=0)):
            with pytest.raises(ValueError):
                side.FleetConfig(**kw)
        for kw in (dict(affinity_tokens=-1), dict(ttft_alpha=0.0),
                   dict(affinity_capacity=0)):
            with pytest.raises(ValueError):
                side.RouterConfig(**kw)
    with pytest.raises(ValueError):
        serve.FleetConfig(quarantine_backoff=rel.RetryPolicy())


def test_fleet_rejects_bad_shapes_and_the_process_backend(sides):
    port = sides[1]
    with pytest.raises(ValueError):
        port.fleet(num_replicas=0)
    # backend="process" builds the process fleet (one worker process per
    # replica), a ReplicaFleet all the same, that leaves no live worker
    fleet = port.fleet(backend="process", num_replicas=1, **DENSE)
    try:
        assert isinstance(fleet, serve.ProcessReplicaFleet)
        assert isinstance(fleet, serve.ReplicaFleet)
        assert fleet.backend == "process" and fleet.replicas_live == 1
    finally:
        backend = fleet.process_backend
        fleet.shutdown()
    assert backend.live_actor_count() == 0
    with pytest.raises(ValueError, match="backend"):
        port.fleet(backend="threads", num_replicas=1, **DENSE)
    fleet = port.fleet(num_replicas=2, num_slots=1, prefill_len=8)
    with pytest.raises(ValueError):
        fleet.submit(list(range(20)), max_new_tokens=4)
    fleet.shutdown()


@pytest.mark.parametrize("site", ["serve.replica", "serve.dispatch"])
def test_fleet_trace_replays_identically_and_frees_dead_replicas(sides,
                                                                 site):
    """Two runs of one trace and fault plan: identical completions. The
    dead replica's engine is released during its failover, before the
    replacement is built, by reference count alone (no collector pass):
    a dispatch crash's traceback does not keep it."""
    port = sides[1]

    def run():
        fleet = port.fleet(num_replicas=3, num_standby=1, **DENSE)
        engines = {rep.id: weakref.ref(rep.client.engine)
                   for rep in fleet._replicas}
        freed_at_build = []
        build = fleet._build_client

        def building():
            freed_at_build.append(sum(r() is None for r in engines.values()))
            return build()

        fleet._build_client = building
        with port.plan(site, [7]).armed():
            out = fleet.serve_trace(TRACE)
        freed = {rid: ref() is None for rid, ref in engines.items()}
        fleet.shutdown()
        return {rid: (c.tokens, c.finish_reason, c.arrival_time,
                      c.first_token_time, c.finish_time)
                for rid, c in out.items()}, freed, freed_at_build

    gc.disable()
    try:
        a, freed, at_build = run()
        b, _, _ = run()
    finally:
        gc.enable()
    assert a == b
    assert sum(freed.values()) == 1
    assert at_build == [1]   # the standby's refill, after the release


def test_disarmed_fleet_has_zero_telemetry_surface(sides):
    port = sides[1]
    fleet = port.fleet(num_replicas=2, num_standby=1, **DENSE)
    assert fleet._tel is None and fleet.router._tel is None
    assert fleet._monitor._tel is None and fleet.standby._tel is None
    for rep in fleet._replicas:
        assert rep.client._tel is None and rep.client.engine._tel is None
    with port.plan("serve.replica", [3]).armed():
        out = fleet.serve_trace(TRACE)
    assert all(c.finish_reason != "failed" for c in out.values())
    for rep in fleet._replicas:
        assert rep.client._tel is None
    assert fleet.metrics_snapshot() == {} and fleet.request_traces() == {}
    with pytest.raises(RuntimeError, match="disarmed"):
        fleet.export_fleet_trace("unused.json")
    fleet.shutdown()


def test_standalone_router_and_shutdown_match_jax(sides):
    for side, req in ((jax_serve, jax_serve.Request),
                      (serve, serve.Request)):
        router = side.Router(side.RouterConfig(affinity_tokens=3))
        assert router.affinity_tokens == 3
        assert router._key(req(id=0, prompt=[1, 2, 3, 4],
                               max_new_tokens=1)) == (1, 2, 3)
        assert side.Router(side.RouterConfig()).affinity_tokens == 0
        assert side.Router(side.RouterConfig(affinity_tokens=5),
                           affinity_tokens=0).affinity_tokens == 0
        router.shutdown()
    fleet = sides[1].fleet(num_replicas=2, num_slots=2, prefill_len=8)
    fleet.submit([1, 2, 3], max_new_tokens=2)
    fleet.run_until_idle()
    assert fleet.router.decisions == 1
    fleet.shutdown()
    assert not fleet.router._affinity and not fleet.router._ttft


def test_replica_gauges_keyed_by_replica_id(sides, tmp_path):
    def scenario(run):
        fleet = run.fleet(num_replicas=2, num_slots=2, prefill_len=8)
        with run.armed():
            for i in range(4):
                fleet.submit([5, 17, 3], max_new_tokens=3, seed=i)
            out = fleet.run_until_idle()
        rec = _record(run, fleet, out)
        rec["snap"] = run.tel.metrics.snapshot()
        rec["merged"] = fleet.metrics_snapshot()
        rec["prefixes"] = [r.client.gauge_prefix for r in fleet._replicas]
        rec["stats"] = [r.client.load_stats() for r in fleet._replicas]
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    snap = got["snap"]
    assert got["prefixes"] == ["replica0_", "replica1_"]
    for rid in (0, 1):
        for base in ("serve_queue_depth", "serve_slot_occupancy"):
            assert f"replica{rid}_{base}" in snap
            assert f"{base}_r{rid}" in got["merged"]
    assert "serve_queue_depth" not in snap
    assert snap["serve_fleet_replicas_live"] == 2
    assert got["stats"][0]["dispatch_in_flight"] is False
    assert set(got["stats"][0]) >= {"queue_depth", "oldest_age", "ops",
                                    "active", "free_slots", "free_pages"}


def test_a_standalone_client_keeps_its_gauge_names_and_driver_site(sides):
    client = sides[1].client(num_slots=2, prefill_len=8,
                             telemetry=obs.Telemetry())
    assert client.gauge_prefix == "" and client._fire_driver_site is True
    client.submit([5, 17], max_new_tokens=2)
    client.run_until_idle()
    snap = client._tel.metrics.snapshot()
    assert "serve_queue_depth" in snap and "serve_slot_occupancy" in snap
    assert client.ops == client._ops > 0
    assert client.engine.occupancy()["free_slots"] == 2
    client.shutdown()


# ------------------------------------------ journal, adapters and tenancy
def test_fleet_restart_token_identity(sides, tmp_path):
    """``ReplicaFleet.restore`` re-admits a dead driver's unretired
    requests through the router's replay lane."""
    fkw = dict(num_replicas=2, **DENSE)

    def scenario(run):
        s = run.side
        ref = run.fleet(**fkw)
        for w in WORK:
            ref.submit(**w)
        base = ref.run_until_idle()
        ref.shutdown()
        path = tmp_path / ("jax.wal" if s.jax else "port.wal")
        dead = s.fleet(journal=s.serve.Journal(path, sync_every=1), **fkw)
        for w in WORK:
            dead.submit(**w)
        for _ in range(4):
            dead.tick()
        retired_early = sorted(dead.completions)
        del dead
        pend = sorted(r.id for r, _ in s.serve.read_journal(
            path).pending())
        fleet = s.restore(path, **fkw)
        out = fleet.run_until_idle()
        fleet.shutdown()
        return dict(base={r: c.tokens for r, c in base.items()},
                    early=retired_early, pend=pend, stamps=_stamps(out),
                    tokens={r: c.tokens for r, c in out.items()},
                    wal=open(path).read().splitlines())

    got = _both(sides, tmp_path, scenario, armed=False)
    assert got["early"] and got["pend"] == sorted(
        set(got["base"]) - set(got["early"]))
    assert sorted(got["tokens"]) == got["pend"]
    for rid in got["pend"]:
        assert got["tokens"][rid] == got["base"][rid]


def test_fleet_member_clients_never_fire_driver_site(sides):
    for side in sides:
        fleet = side.fleet(num_replicas=2, **DENSE)
        assert all(rep.client._fire_driver_site is False
                   for rep in fleet._replicas)
        plan = side.plan("serve.driver", [10 ** 9])
        with plan.armed():
            for _ in range(3):
                fleet.tick()
            assert plan._counts["serve.driver"] == 3
        fleet.shutdown()


def test_fleet_failover_preserves_adapters(sides, tmp_path):
    def scenario(run):
        fleet = run.fleet(num_replicas=3, num_slots=2, prefill_len=8,
                          adapters=run.side.ads, max_resident_adapters=CAP,
                          lora_rank=RANK)
        plan = run.side.plan("serve.replica", [3])
        with run.armed(plan):
            out = fleet.serve_trace(list(ATRACE))
        rec = _record(run, fleet, out, greedy={0, 1, 2})
        rec["fired"] = plan.fired
        rec["_tokens"] = {r: c.tokens for r, c in out.items()}
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["fired"] == 1 and got["counters"][0] == 1
    ref = _port_single(sides, ATRACE, num_slots=2, prefill_len=8,
                       adapters=sides[1].ads, max_resident_adapters=CAP,
                       lora_rank=RANK)
    assert got["_tokens"] == {r: c.tokens for r, c in ref.items()}
    assert {r: s[5] for r, s in got["stamps"].items()} == {
        r: c.adapter for r, c in ref.items()}


def test_fleet_hot_load_lockstep_and_eviction(sides, tmp_path):
    def scenario(run):
        s = run.side
        fleet = run.fleet(num_replicas=2, num_slots=2, prefill_len=8,
                          adapters={"a": s.ads["a"]},
                          max_resident_adapters=CAP, lora_rank=RANK)
        with run.armed():
            loads = [fleet.load_adapter("b", s.ads["b"]),
                     fleet.load_adapter("c", s.ads["a"])]
            resident = [r.client.engine.resident_adapters
                        for r in fleet._replicas]
            rid = fleet.submit(**dict(ATRACE[0][1], adapter="c"))
            out = fleet.run_until_idle()
            with pytest.raises(s.serve.UnknownAdapter):
                fleet.submit([1, 2, 3], max_new_tokens=4, adapter="a")
            fleet.unload_adapter("b")
        rec = _record(run, fleet, out)
        rec["loads"] = loads
        rec["resident"] = (resident, [r.client.engine.resident_adapters
                                      for r in fleet._replicas])
        rec["rid"] = rid
        fleet.shutdown()
        return rec

    got = _both(sides, tmp_path, scenario)
    assert got["loads"] == [None, "a"]
    assert got["resident"] == ([["b", "c"]] * 2, [["c"]] * 2)


def _classes(cls):
    return [cls("fast", weight=4.0, tier="interactive", ttft_slo=6.0),
            cls("bulk", weight=1.0, tier="batch"), cls("default")]


def test_fleet_failover_preserves_class_assignment_and_tokens(sides,
                                                              tmp_path):
    def scenario(run):
        recs = []
        for ticks in (None, [4]):
            fleet = run.fleet(num_replicas=3, num_standby=1, num_slots=2,
                              prefill_len=8,
                              tenant_classes=_classes(
                                  run.side.serve.TenantClass))
            plan = None if ticks is None else run.side.plan(
                "serve.replica", ticks)
            with run.armed(plan):
                out = fleet.serve_trace(list(MIXED_TRACE))
            recs.append((_stamps(out), {r: c.tokens for r, c in out.items()
                                        if r != 3}, fleet.failovers))
            fleet.shutdown()
        return dict(runs=recs, lines=run.lines())

    got = _both(sides, tmp_path, scenario)
    (ref, ref_tok, _), (chaos, chaos_tok, failovers) = got["runs"]
    assert failovers >= 1 and chaos_tok == ref_tok
    for rid, st in ref.items():
        assert chaos[rid][0] != "failed" and chaos[rid][4] == st[4]


def test_fleet_saturated_carries_aggregated_class_context(sides):
    got = []
    for side in sides:
        cls = side.serve.TenantClass
        fleet = side.fleet(num_replicas=2, num_slots=1, prefill_len=8,
                           tenant_classes=[
                               cls("fast", tier="interactive"),
                               cls("bulk", tier="batch",
                                   max_queue_depth=1)])
        fleet.submit([1, 2], max_new_tokens=2, tenant="bulk")
        fleet.submit([1, 3], max_new_tokens=2, tenant="bulk")
        with pytest.raises(side.serve.FleetSaturated) as err:
            fleet.submit([1, 4], max_new_tokens=2, tenant="bulk")
        got.append((err.value.class_depths, err.value.class_oldest,
                    err.value.queue_depth, str(err.value)))
        fleet.run_until_idle()
        fleet.shutdown()
    assert got[1] == got[0]
    assert got[1][0] == {"fast": 0, "bulk": 2, "default": 0}
