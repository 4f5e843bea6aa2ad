"""The port's failure containment (``ray_lightning_tpu_torch/serve/containment.py`` and the fleet's poison, probation, quarantine and parking paths) against the JAX package.

``SeatTable`` is a copy: the same calls on the two tables give the same
seats, the same quarantine times (``death + policy.delay(attempt,
salt=seat)``, exactly) and the same gates. The fleet scenarios of
``tests/test_containment.py`` run once on each package's fleet (the
``serve_nano_family`` shapes, the tick clock, the same ``FaultPlan``):
completions (greedy tokens by identity, finish reasons and tick stamps),
the fleet's counters and the tick-clock JSONL event log must be equal,
and the JAX test's own assertions are checked on the port's run.
"""
import json

import pytest
import torch

import ray_lightning_tpu.obs as jax_obs
import ray_lightning_tpu.reliability as jax_rel
import ray_lightning_tpu.serve as jax_serve
from ray_lightning_tpu.serve.containment import SeatTable as JaxSeatTable
import ray_lightning_tpu_torch.obs as obs
import ray_lightning_tpu_torch.reliability as rel
import ray_lightning_tpu_torch.serve as serve
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.serve.containment import SeatTable

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

MK = dict(vocab_size=128, max_seq_len=32)
TRACE = [
    (0, dict(prompt=[5, 17, 3, 9], max_new_tokens=6)),
    (0, dict(prompt=[9, 2, 44], max_new_tokens=6)),
    (1, dict(prompt=[42, 7], max_new_tokens=5)),
    (2, dict(prompt=[1, 33], max_new_tokens=6)),
]
ENGINE = dict(num_slots=2, prefill_len=16)


# ---------------------------------------------------------------- seat table
def _schedule(table_cls, policy_cls):
    """The JAX test's two schedules, every return value recorded."""
    out = []
    policy = policy_cls(max_attempts=8, base_delay=4.0, max_delay=64.0,
                        multiplier=2.0, jitter=0.25, seed=7)
    t = table_cls(flap_window=100.0, flap_threshold=2, policy=policy)
    out += [t.occupy(10, now=0.0, grow=True), t.occupy(11, now=0.0,
                                                       grow=True)]
    out += [t.record_death(10, now=5.0), t.allow_build(5.0),
            t.occupy(12, now=5.0)]
    nb = t.record_death(12, now=9.0)
    out += [nb, t.allow_build(nb - 1e-9), t.gated(nb - 1e-9),
            t.allow_build(nb)]
    out += [t.record_death(11, now=9.0), t.occupy(13, now=9.0),
            t.record_death(13, now=9.5)]
    out += [t.occupy(14, now=nb), t.record_death(14, now=nb + 1.0)]
    out.append([policy.delay(a, salt=s) for a in (1, 2) for s in (0, 1)])
    policy = policy_cls(max_attempts=4, base_delay=2.0, jitter=0.0)
    t = table_cls(flap_window=10.0, flap_threshold=2, policy=policy)
    out += [t.occupy(0, now=0.0, grow=True), t.record_death(0, now=1.0),
            t.occupy(1, now=1.0), t.record_death(1, now=50.0),
            t.allow_build(50.0), t.occupy(2, now=50.0)]
    t.vacate(2)
    out += [t.gated(50.0), t.occupy(3, now=60.0, grow=True),
            t.record_death(3, now=61.0), t.occupy(4, now=61.0),
            t.record_death(4, now=62.0), t.allow_build(62.0),
            t.occupy(5, now=62.0, grow=True), t.gated(62.0)]
    with pytest.raises(RuntimeError, match="no buildable seat"):
        t.occupy(6, now=62.0)
    return out


def test_seat_table_schedule_equals_jax():
    want = _schedule(JaxSeatTable, jax_rel.RetryPolicy)
    got = _schedule(SeatTable, rel.RetryPolicy)
    assert got == want
    policy = rel.RetryPolicy(max_attempts=8, base_delay=4.0,
                             max_delay=64.0, multiplier=2.0, jitter=0.25,
                             seed=7)
    nb = got[5]
    assert got[:2] == [0, 1] and got[2] is None and got[4] == 0
    assert nb == 9.0 + policy.delay(1, salt=0)
    assert got[6:9] == [False, 1, True]
    assert got[11] == 9.5 + policy.delay(1, salt=1)
    assert got[13] == nb + 1.0 + policy.delay(2, salt=0)
    assert got[-1] == 1 and got[-2] == 2  # a fresh seat; the old stays gated


# -------------------------------------------------------------------- fleet
@pytest.fixture(scope="module")
def env(serve_nano_family):
    dec, params = serve_nano_family[:2]
    target = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, **MK), device="cpu"), params)
    return dec, params, target


class Side:
    def __init__(self, env, jax_side, tmp_path):
        dec, params, target = env
        self.jax = jax_side
        self.serve = jax_serve if jax_side else serve
        self.rel = jax_rel if jax_side else rel
        self.path = str(tmp_path / ("jax.jsonl" if jax_side
                                    else "port.jsonl"))
        self.tel = (jax_obs if jax_side else obs).Telemetry(
            jsonl_path=self.path)
        self.model, self.params = ((dec, params) if jax_side
                                   else (target, target.state_dict()))

    def fleet(self, **kw):
        if not self.jax:
            kw["device"] = "cpu"
        fleet = self.serve.ReplicaFleet(self.model, self.params,
                                        telemetry=self.tel, **kw)
        if fleet.standby is not None:
            # refill on this thread: a background refill races the next
            # failover (warm or cold promotion), so two runs' event logs
            # would differ by timing alone
            fleet.standby.refill_async = fleet.standby.fill
        return fleet

    def lines(self):
        self.tel.flush()
        with open(self.path) as f:
            return f.read().splitlines()


def _record(side, fleet, out, **extra):
    rec = dict(
        stamps={r: (c.finish_reason, c.arrival_time, c.first_token_time,
                    c.finish_time, len(c.tokens)) for r, c in out.items()},
        tokens={r: c.tokens for r, c in out.items()},
        counters=(fleet.failovers, fleet.readmitted, fleet.readmit_failed,
                  fleet.poison_failed),
        lines=side.lines(), snap=side.tel.metrics.snapshot(), **extra)
    return rec


def _both(env, tmp_path, scenario):
    want, got = (scenario(Side(env, j, tmp_path)) for j in (True, False))
    assert len(got["lines"]) == len(want["lines"])
    for i, (a, b) in enumerate(zip(want["lines"], got["lines"])):
        assert b == a, (i, a, b)
    for key in want:
        assert got[key] == want[key], key
    return got


def _events(rec, site):
    return [json.loads(x)["payload"] for x in rec["lines"]
            if json.loads(x)["site"] == site]


def _port_single(env, trace):
    _, _, target = env
    client = serve.ServeClient(target, target.state_dict(), device="cpu",
                               num_slots=8, prefill_len=32)
    out = client.serve_trace(list(trace))
    client.shutdown()
    return out


def test_poison_request_contained_within_budget(env, tmp_path):
    poison_id = 1

    def scenario(s):
        fleet = s.fleet(num_replicas=3, num_standby=2,
                        fleet_config=s.serve.FleetConfig(
                            max_request_failovers=3), **ENGINE)
        plan = s.rel.FaultPlan(poison=(poison_id,))
        with s.tel.activated(), plan.armed():
            out = fleet.serve_trace(TRACE)
        rec = _record(s, fleet, out)
        fleet.shutdown()
        return rec

    got = _both(env, tmp_path, scenario)
    assert got["stamps"][poison_id][0] == "failed"
    assert got["counters"][3] == 1 and got["counters"][0] <= 3
    ref = _port_single(env, [x for i, x in enumerate(TRACE)
                             if i != poison_id])
    for ref_rid, rid in enumerate(i for i in range(len(TRACE))
                                  if i != poison_id):
        assert got["tokens"][rid] == ref[ref_rid].tokens, rid
        assert got["stamps"][rid][0] != "failed"
    phases = [p["phase"] for p in _events(got, "fleet.probation")
              if p["id"] == poison_id]
    assert phases[:2] == ["queued", "seated"]
    failed = _events(got, "fleet.poison_failed")
    assert failed[0]["id"] == poison_id and failed[0]["implications"] >= 3
    assert got["snap"]["serve_fleet_poison_failed_total"] == 1


def test_probation_exonerates_implicated_innocent(env, tmp_path):
    trace = [(0, dict(prompt=[5, 17, 3, 9], max_new_tokens=6)),
             (0, dict(prompt=[9, 2, 44], max_new_tokens=6))]

    def scenario(s):
        fleet = s.fleet(num_replicas=1, num_standby=1,
                        fleet_config=s.serve.FleetConfig(
                            max_request_failovers=4), **ENGINE)
        plan = s.rel.FaultPlan(poison=(0,))
        with s.tel.activated(), plan.armed():
            out = fleet.serve_trace(trace)
        rec = _record(s, fleet, out)
        fleet.shutdown()
        return rec

    got = _both(env, tmp_path, scenario)
    assert got["stamps"][0][0] == "failed"
    (ref,) = _port_single(env, [trace[1]]).values()
    assert got["tokens"][1] == ref.tokens and got["stamps"][1][0] != "failed"
    assert any(p["id"] == 1 for p in _events(got,
                                              "fleet.probation_cleared"))


def test_quarantine_schedule_and_degraded_mode(env, tmp_path):
    def scenario(s):
        policy = s.rel.RetryPolicy(max_attempts=8, base_delay=4.0,
                                   max_delay=64.0, multiplier=2.0,
                                   jitter=0.25, seed=3)
        fleet = s.fleet(num_replicas=1, num_standby=0,
                        fleet_config=s.serve.FleetConfig(
                            flap_window=200.0, flap_threshold=2,
                            quarantine_backoff=policy), **ENGINE)
        steps = []
        fleet.tick()
        fleet._fail_replica(fleet._replicas[0], dead=True)
        steps.append(fleet.replicas_live)
        fleet.tick()
        t2 = fleet.now()
        fleet._fail_replica(fleet._replicas[0], dead=True)
        steps.append(fleet.replicas_live)
        fleet.tick()
        with pytest.raises(s.serve.FleetDegraded) as err:
            fleet.submit([5, 3], max_new_tokens=4)
        steps.append((err.value.quarantined, err.value.live,
                      s.tel.metrics.snapshot()["serve_fleet_quarantined"]))
        while fleet.replicas_live == 0:
            fleet.tick()
        steps.append(fleet.now())
        fleet.submit([5, 3], max_new_tokens=4)
        out = fleet.run_until_idle()
        rec = _record(s, fleet, out, steps=steps, t2=t2,
                      expected=t2 + policy.delay(1, salt=0))
        fleet.shutdown()
        return rec

    import math
    got = _both(env, tmp_path, scenario)
    live1, live2, degraded, rebuilt = got["steps"]
    assert (live1, live2) == (1, 0) and degraded == (1, 0, 1)
    assert rebuilt == math.ceil(got["expected"])
    q = _events(got, "fleet.quarantine")
    assert len(q) == 1 and q[0]["next_build"] == round(got["expected"], 6)
    assert _events(got, "fleet.degraded") and _events(got, "fleet.restored")
    assert got["snap"]["serve_fleet_quarantined"] == 0
    assert all(st[0] != "failed" for st in got["stamps"].values())


def test_readmit_queuefull_parks_then_readmits(env, tmp_path):
    def scenario(s):
        fleet = s.fleet(num_replicas=2, num_standby=1, num_slots=1,
                        prefill_len=16,
                        scheduler_config=s.serve.SchedulerConfig(
                            max_queue_depth=1))
        with s.tel.activated():
            fleet.submit([3, 1], max_new_tokens=6)
            fleet.submit([3, 2], max_new_tokens=6)
            fleet.tick()
            fleet.submit([3, 3], max_new_tokens=6)
            fleet.submit([3, 4], max_new_tokens=6)
            fleet._fail_replica(fleet._replicas[1], dead=True)
            out = fleet.run_until_idle()
        rec = _record(s, fleet, out)
        fleet.shutdown()
        return rec

    got = _both(env, tmp_path, scenario)
    assert _events(got, "fleet.readmit_parked")
    assert len(got["stamps"]) == 4 and got["counters"][2] == 0
    assert all(st[0] != "failed" for st in got["stamps"].values())


def test_parked_request_deadline_enforced(env, tmp_path):
    def scenario(s):
        fleet = s.fleet(num_replicas=1, num_standby=0, **ENGINE)
        req = s.serve.Request(id=777, prompt=[5, 3], max_new_tokens=8,
                              deadline=2.0)
        req.arrival_time = 0.0
        req.replay_tokens = [9, 11]
        for _ in range(3):
            fleet.tick()
        fleet._park(req)
        done = fleet.tick()
        rec = _record(s, fleet, {c.request_id: c for c in done})
        fleet.shutdown()
        return rec

    got = _both(env, tmp_path, scenario)
    assert list(got["stamps"]) == [777]
    assert got["stamps"][777][0] == "timeout"
    assert got["tokens"][777] == [9, 11]


def test_default_config_containment_is_inert(env, tmp_path):
    def scenario(s):
        fleet = s.fleet(num_replicas=2, num_standby=1, **ENGINE)
        seats = fleet._seats
        plan = s.rel.FaultPlan.at("serve.replica", [3])
        with s.tel.activated(), plan.armed():
            out = fleet.serve_trace(TRACE)
        rec = _record(s, fleet, out, seats=seats, fired=plan.fired)
        fleet.shutdown()
        return rec

    got = _both(env, tmp_path, scenario)
    assert got["seats"] is None and got["fired"] == 1
    assert got["counters"][0] == 1 and got["counters"][3] == 0
    ref = _port_single(env, TRACE)
    assert got["tokens"] == {r: c.tokens for r, c in ref.items()}
    for site in ("fleet.quarantine", "fleet.probation",
                 "fleet.probation_cleared", "fleet.degraded",
                 "fleet.restored", "fleet.poison_failed"):
        assert not _events(got, site), site
    assert "serve_fleet_poison_failed_total" not in got["snap"]
    assert "serve_fleet_quarantined" not in got["snap"]
