"""The port's process replica fleet under chaos (``tests/test_fleet_process.py``'s heavy cases) against the JAX package.

Each case runs on the port's ``ReplicaFleet(backend="process")`` with
its workers on the CPU (``device="cpu"``, one torch thread) and holds
the fleet's greedy f32 tokens against the JAX ``ServeClient`` on the
same flax weights: a replica SIGKILLed mid-decode (its requests re-admit
from the driver's progress ledger; ``replica.dead``, never
``replica.error``; the warm standby promoted), a wedged dispatch loop
failed over by its heartbeat silence (``dead=False``), tenancy classes
kept across the failover, a poison request whose ``os._exit`` kills
every worker that seats it (conservative implication, probation), and
a queue burst that scales the fleet out from its standby and back in.
Marked ``slow`` exactly as their JAX twins are.
"""
import os
import signal
import time

import pytest
import torch

from ray_lightning_tpu.serve import TenantClass as JaxTenantClass
from ray_lightning_tpu_torch.obs import Telemetry
from ray_lightning_tpu_torch.reliability import MODE_EXIT, FaultPlan
from ray_lightning_tpu_torch.serve import (FINISH_FAILED, FleetConfig,
                                           TenantClass)
from test_torch_process_fleet import jax_ref, nano, port_fleet  # noqa: F401

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port, pytest.mark.fleet_process,
              pytest.mark.multiproc]

LONG_REQS = [
    dict(prompt=[5, 17, 3, 9], max_new_tokens=20),
    dict(prompt=[9, 2, 44], max_new_tokens=20),
    dict(prompt=[42, 7], max_new_tokens=18),
    dict(prompt=[1, 33, 2], max_new_tokens=20),
]

# prefill_len sizes the unchunked replay window (prompt + emitted must
# re-feed through ONE prefill on the survivor): worst case here is a
# 4-token prompt with 19 flushed tokens at kill time
ENGINE = dict(num_slots=2, prefill_len=32, steps_per_dispatch=2)


def _pump_until(fleet, cond, timeout_s=90.0, msg=""):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        fleet.tick()
        if cond():
            return
        time.sleep(0.01)  # tl-lint: allow-sleep — wall-clock poll against real worker processes
    raise AssertionError(f"condition not reached in {timeout_s}s: {msg}")


def _flushed(fleet, victim):
    return lambda: any(t.replica == victim.id and t.tokens
                       for t in fleet._inflight.values())


@pytest.mark.slow
def test_process_fleet_kill9_failover_token_identity(nano):
    """kill -9 a replica mid-decode: its requests re-admit to the
    survivor from the driver-side progress ledger and finish with the
    JAX engine's tokens; the death classifies ``replica.dead``
    (latch-first) and the warm standby restores capacity."""
    tel = Telemetry()
    fleet = port_fleet(nano, num_replicas=2, num_standby=1, telemetry=tel,
                       **ENGINE)
    try:
        for kw in LONG_REQS:
            fleet.submit(**kw)
        victim = fleet._replicas[0]
        _pump_until(fleet, _flushed(fleet, victim),
                    msg="victim never flushed decode progress")
        os.kill(victim.actor._proc.pid, signal.SIGKILL)
        out = fleet.run_until_idle()
        _pump_until(fleet, lambda: fleet.replicas_live == 2,
                    msg="capacity never restored after failover")
    finally:
        backend = fleet.process_backend
        fleet.shutdown()
    ref = jax_ref(nano, LONG_REQS, **{**ENGINE, "num_slots": 8})
    for rid in ref:
        assert out[rid].finish_reason != "failed", rid
        assert out[rid].tokens == ref[rid].tokens, rid
    assert fleet.failovers == 1
    assert fleet.readmitted >= 1
    # latch-first classification: dead, never a dispatch error
    assert tel.events("replica.dead")
    assert not tel.events("replica.error")
    fo = tel.events("fleet.failover")
    assert len(fo) == 1 and fo[0].payload["dead"] is True
    assert tel.events("recovery.replay")
    promoted = tel.events("fleet.replica_promoted")
    assert promoted and promoted[0].payload["source"] == "standby"
    assert backend.live_actor_count() == 0


#: the tier-1 case's work: 8 rows, 4 on each replica, 2 decoding at a
#: time, so the victim still holds rows when it is frozen
MANY_REQS = [dict(prompt=[3 + i, 17, 5 * i % 64], max_new_tokens=24)
             for i in range(8)]


def test_process_fleet_kill9_then_hang_token_identity(nano):
    """The tier-1 chaos case (the port's own; its JAX twins above are
    ``slow``): a replica frozen mid-decode, its progress flushed, is
    SIGKILLed (``replica.dead``; the warm standby promoted), then the
    other first replica is wedged and failed over by its heartbeat
    silence (``dead=False``), whatever it held re-admitted. Every
    request finishes with the JAX engine's greedy tokens and no worker
    outlives the fleet."""
    tel = Telemetry()
    fleet = port_fleet(nano, num_replicas=2, num_standby=1, telemetry=tel,
                       fleet_config=FleetConfig(heartbeat_timeout=1.5,
                                                startup_grace=3.0),
                       **ENGINE)
    try:
        for kw in MANY_REQS:
            fleet.submit(**kw)
        victim, other = fleet._replicas
        deadline = time.time() + 90.0
        while not _flushed(fleet, victim)():
            assert time.time() < deadline, "victim never flushed progress"
            fleet.tick()
        # frozen first (no dispatch after this RPC returns), so the kill
        # lands with the victim's rows in flight whatever the host's pace
        fleet._ray.get(victim.actor.inject.remote("stall"), timeout=30)
        held = [t.req.id for t in fleet._inflight.values()
                if t.replica == victim.id]
        os.kill(victim.actor._proc.pid, signal.SIGKILL)
        _pump_until(fleet, lambda: fleet.failovers == 1,
                    msg="the kill was never noticed")
        # wedge the other first replica: its silence verdict
        fleet._ray.get(other.actor.inject.remote("stall"), timeout=30)
        for kw in MANY_REQS[:2]:
            fleet.submit(**kw)
        out = fleet.run_until_idle()
    finally:
        backend = fleet.process_backend
        fleet.shutdown()
    assert held, "the victim held no rows at the kill"
    reqs = MANY_REQS + MANY_REQS[:2]
    ref = jax_ref(nano, reqs, **{**ENGINE, "num_slots": 8})
    assert sorted(out) == sorted(ref)
    for rid in ref:
        assert out[rid].finish_reason == "length", rid
        assert out[rid].tokens == ref[rid].tokens, rid
    assert fleet.failovers >= 2
    assert [e.payload["replica"] for e in tel.events("replica.dead")] \
        == [victim.id]
    assert not tel.events("replica.error")
    fo = [(e.payload["replica"], e.payload["dead"])
          for e in tel.events("fleet.failover")]
    assert fo[:2] == [(victim.id, True), (other.id, False)]
    assert tel.events("recovery.replay")
    assert backend.live_actor_count() == 0


def test_blocking_failover_does_not_fail_a_beating_survivor(nano):
    """The port's own case: with ``min_replicas=2`` a death makes the
    failover cold-build the replacement on the driver's thread, here
    3 s (a spawn on a loaded host; on the card a worker takes ~5 s)
    past the 1.5 s timeout, while the survivor keeps beating. Its
    silence is judged on the beats drained after that failover, so it
    is not failed over as hung (the JAX fleet checks the rebuilt
    monitor's carried beats first). Every token is the JAX engine's.

    The two starting conditions are met one after the other: the victim
    is wedged as soon as its flushed progress shows, which keeps its
    rows in flight, and the kill waits for the survivor's first beat
    with a dispatch step. Beats are throttled to one per
    ``heartbeat_timeout / 8`` (0.1875 s here), longer than a replica's
    whole share of ``MANY_REQS`` takes on a CPU (~0.15 s), so the
    survivor's progress beat can arrive after the victim has retired
    every request, and a wait for both at once then never ends."""
    tel = Telemetry()
    fleet = port_fleet(nano, num_replicas=2, telemetry=tel,
                       fleet_config=FleetConfig(min_replicas=2,
                                                heartbeat_timeout=1.5,
                                                startup_grace=3.0),
                       **ENGINE)
    spawn = fleet._spawn_actor

    def slow_spawn():
        time.sleep(3.0)  # tl-lint: allow-sleep — the cold build's wall time is the point
        return spawn()

    fleet._spawn_actor = slow_spawn
    try:
        for kw in MANY_REQS:
            fleet.submit(**kw)
        victim, survivor = fleet._replicas
        deadline = time.time() + 90.0
        while not _flushed(fleet, victim)():
            assert time.time() < deadline, "the victim flushed no progress"
            fleet.tick()
        fleet._ray.get(victim.actor.inject.remote("stall"), timeout=30)
        while survivor.last_step < 1:
            assert time.time() < deadline, "the survivor beat no step"
            fleet.tick()
        os.kill(victim.actor._proc.pid, signal.SIGKILL)
        out = fleet.run_until_idle()
        alive = survivor in fleet._replicas
    finally:
        backend = fleet.process_backend
        fleet.shutdown()
    assert alive, "the survivor was failed over"
    assert fleet.failovers == 1
    fo = [(e.payload["replica"], e.payload["dead"])
          for e in tel.events("fleet.failover")]
    assert fo == [(victim.id, True)]
    assert [e.payload["source"] for e in
            tel.events("fleet.replica_promoted")] == ["cold"]
    ref = jax_ref(nano, MANY_REQS, **{**ENGINE, "num_slots": 8})
    for rid in ref:
        assert out[rid].tokens == ref[rid].tokens, rid
    assert backend.live_actor_count() == 0


@pytest.mark.slow
def test_process_fleet_hang_verdict_via_heartbeat_channel(nano):
    """A live but wedged replica stops beating on the heartbeat channel
    and is failed over as hung (``fleet.failover`` with ``dead=False``)
    within the configured timeout; its work still finishes elsewhere
    with the JAX engine's tokens."""
    tel = Telemetry()
    fleet = port_fleet(nano, num_replicas=2, telemetry=tel,
                       fleet_config=FleetConfig(heartbeat_timeout=1.5,
                                                startup_grace=60.0),
                       **ENGINE)
    try:
        for kw in LONG_REQS[:2]:
            fleet.submit(**kw)
        victim = fleet._replicas[0]
        # let the victim dispatch at least once (its step beats end the
        # startup grace; the timeout clock applies after)
        _pump_until(fleet, lambda: victim.last_step >= 1,
                    msg="victim never completed a dispatch turn")
        fleet._ray.get(victim.actor.inject.remote("stall"), timeout=30)
        _pump_until(fleet, lambda: fleet.failovers == 1,
                    msg="hang verdict never fired")
        out = fleet.run_until_idle()
    finally:
        fleet.shutdown()
    ref = jax_ref(nano, LONG_REQS[:2], **{**ENGINE, "num_slots": 8})
    for rid in ref:
        assert out[rid].finish_reason != "failed", rid
        assert out[rid].tokens == ref[rid].tokens, rid
    fo = tel.events("fleet.failover")
    assert len(fo) == 1 and fo[0].payload["dead"] is False
    assert not tel.events("replica.dead")


def _classes(mod):
    return [mod("fast", weight=4.0, tier="interactive", ttft_slo=6.0),
            mod("bulk", weight=1.0, tier="batch")]


TENANT_REQS = [
    dict(prompt=[11, 12], max_new_tokens=16, tenant="bulk"),
    dict(prompt=[15, 3], max_new_tokens=16, tenant="fast"),
    dict(prompt=[13, 14, 9], max_new_tokens=14, tenant="bulk"),
    dict(prompt=[16, 8], max_new_tokens=14, tenant="fast"),
]


@pytest.mark.slow
@pytest.mark.tenancy
def test_process_fleet_failover_preserves_tenant_class(nano):
    """Tenancy armed across the process boundary: the kill -9 victim's
    requests re-admit with their tenant class intact (completions carry
    it, and the forwarded per-class admission events name it)."""
    tel = Telemetry()
    fleet = port_fleet(nano, num_replicas=2, telemetry=tel,
                       tenant_classes=_classes(TenantClass), **ENGINE)
    try:
        rids = {fleet.submit(**kw): kw["tenant"] for kw in TENANT_REQS}
        victim = fleet._replicas[0]
        assert victim.info["tenancy"] is True
        _pump_until(fleet, _flushed(fleet, victim),
                    msg="victim never flushed decode progress")
        os.kill(victim.actor._proc.pid, signal.SIGKILL)
        out = fleet.run_until_idle()
    finally:
        fleet.shutdown()
    ref = jax_ref(nano, TENANT_REQS,
                  **{**ENGINE, "num_slots": 8,
                     "tenant_classes": _classes(JaxTenantClass)})
    for rid, tenant in rids.items():
        assert out[rid].finish_reason != "failed", rid
        assert out[rid].tenant == tenant, rid
        assert out[rid].tokens == ref[rid].tokens, rid
    admitted = tel.events("engine.tenant_admitted")
    assert {e.payload["tenant"] for e in admitted} >= {"fast", "bulk"}
    assert tel.events("replica.dead")


POISON_REQS = [
    dict(prompt=[5, 17, 3, 9], max_new_tokens=18),
    dict(prompt=[9, 2, 44], max_new_tokens=12),    # the poison pill
    dict(prompt=[42, 7, 1], max_new_tokens=18),
]


@pytest.mark.slow
def test_process_poison_kill9_conservative_implication(nano):
    """``MODE_EXIT`` poison: the worker ``os._exit``s before it can ship
    MSG_CRASH, so every death classifies ``replica.dead`` and the driver
    falls back to conservative implication (all displaced). Innocents
    swept up by the fallback escape through probation; the poison
    exhausts its budget there and retires ``failed``."""
    tel = Telemetry()
    poison_id = 1
    with FaultPlan(poison=(poison_id,), poison_mode=MODE_EXIT).armed():
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
    assert fleet.failovers <= 3
    # hard exits: latch-first classification, no MSG_CRASH ever arrives
    assert tel.events("replica.dead")
    assert not tel.events("replica.error")
    innocents = [i for i in range(len(POISON_REQS)) if i != poison_id]
    ref = jax_ref(nano, [POISON_REQS[i] for i in innocents],
                  **{**ENGINE, "num_slots": 8})
    for ref_rid, fleet_rid in enumerate(innocents):
        assert out[fleet_rid].finish_reason != "failed", fleet_rid
        assert out[fleet_rid].tokens == ref[ref_rid].tokens, fleet_rid
    assert backend.live_actor_count() == 0


@pytest.mark.slow
def test_process_fleet_sustained_autoscale_churn(nano):
    """Sustained churn: a queue burst scales the fleet out (warm standby
    first), the trailing lull scales it back in, across real worker
    processes, with zero stranded completions and the JAX engine's
    tokens throughout; each drained worker reports its final stats."""
    tel = Telemetry()
    burst = [(0.0 + 0.02 * i,
              dict(prompt=[i + 1, 7], max_new_tokens=6 + (i % 3)))
             for i in range(8)]
    tail = [(0.8, dict(prompt=[3, 9, 27], max_new_tokens=32)),
            (1.0, dict(prompt=[11, 4], max_new_tokens=32))]
    trace = burst + tail
    fleet = port_fleet(
        nano, num_replicas=1, num_standby=1, telemetry=tel,
        scale_eval_interval=0.05,
        fleet_config=FleetConfig(autoscale=True, min_replicas=1,
                                 max_replicas=3,
                                 scale_out_queue_depth=1.0,
                                 hysteresis=2),
        num_slots=1, prefill_len=16)
    try:
        out = fleet.serve_trace(trace)
        # the post-trace lull drains the fleet back toward min_replicas
        _pump_until(fleet, lambda: fleet.scale_ins >= 1,
                    msg="fleet never scaled back in after the burst")
        drained = dict(fleet.final_stats)
    finally:
        backend = fleet.process_backend
        fleet.shutdown()
    assert fleet.scale_outs >= 1
    assert fleet.scale_ins >= 1
    assert drained and all("kernel_launches" in s for s in drained.values())
    # warm standby is preferred over a cold build for the first scale-out
    so = tel.events("fleet.scale_out")
    assert so and so[0].payload["source"] == "standby"
    # no stranded completions: every submission retired, none failed/shed
    ref = jax_ref(nano, [kw for _, kw in trace], num_slots=8,
                  prefill_len=16)
    assert sorted(out) == sorted(ref)
    for rid in ref:
        assert out[rid].finish_reason == ref[rid].finish_reason, rid
        assert out[rid].tokens == ref[rid].tokens, rid
    assert backend.live_actor_count() == 0
