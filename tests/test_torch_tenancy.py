"""The port's tenancy (``serve/tenancy.py``, the client's ``tenant_classes=``, the engine's per-class slot quota) against the JAX package.

The JAX tenancy suite's scheduler scenarios (weighted fair share,
tiers, the starvation bound, deterministic tie-breaks, the default-only
class against FIFO, per-class queue quotas and their shed context, the
global bound's class breakdown, ``max_active_slots``, per-class
deadlines) run on the JAX ``TenantScheduler`` and on the port's against
the same fake engine, and every decision and shed must be the same.
A mixed-class trace served by the port's client gives the JAX client's
tokens, tick stamps and admission counts, and a class's
``max_active_slots`` holds for a direct ``engine.prefill`` caller.
"""
import types

import numpy as np
import pytest
import torch

import ray_lightning_tpu.serve as jax_serve
import ray_lightning_tpu.serve.scheduler as jax_scheduler
import ray_lightning_tpu_torch.serve as port_serve
import ray_lightning_tpu_torch.serve.scheduler as port_scheduler
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port


def _api(serve, scheduler):
    return types.SimpleNamespace(
        TenantClass=serve.TenantClass, TenantScheduler=serve.TenantScheduler,
        Request=serve.Request, SchedulerConfig=serve.SchedulerConfig,
        FifoScheduler=scheduler.FifoScheduler, QueueFull=serve.QueueFull,
        ClassQueueFull=serve.ClassQueueFull,
        ACTION_PREFILL=scheduler.ACTION_PREFILL,
        DEFAULT=serve.DEFAULT_TENANT)


JAX = _api(jax_serve, jax_scheduler)
PORT = _api(port_serve, port_scheduler)


class FakeEngine:
    """Free slots, the batched prefill's width and the active-request map
    the per-class slot quota reads."""

    def __init__(self, free_slots=4, prefill_batch=4, active=()):
        self.free_slots = free_slots
        self.prefill_batch = prefill_batch
        self.active_requests = {i: r for i, r in enumerate(active)}
        self.active_count = len(self.active_requests)
        self.chunk_pending = 0


def _req(api, rid, tenant=None, **kw):
    kw.setdefault("prompt", [1, 2])
    kw.setdefault("max_new_tokens", 4)
    return api.Request(id=rid, tenant=tenant or api.DEFAULT, **kw)


def _drain(api, sched, n_pops, refill=None):
    order = []
    eng = FakeEngine(free_slots=1, prefill_batch=1)
    for i in range(n_pops):
        if refill is not None:
            refill(sched, i)
        action, reqs = sched.next_action(eng)
        if action != api.ACTION_PREFILL:
            break
        order.extend(r.tenant for r in reqs)
    return order


def _saturate(api, depths):
    rid = [0]

    def refill(s, _i):
        for name, depth in depths.items():
            while s.class_depths()[name] < depth:
                s.submit(_req(api, rid[0], name))
                rid[0] += 1
    return refill


def fair_share(api):
    sched = api.TenantScheduler([
        api.TenantClass("heavy", weight=3.0, tier="batch"),
        api.TenantClass("light", weight=1.0, tier="batch")])
    order = _drain(api, sched, 80, _saturate(api, {"heavy": 4, "light": 4}))
    return order, sched.admitted_counts()


def tiers(api):
    sched = api.TenantScheduler([
        api.TenantClass("fast", weight=4.0, tier="interactive",
                        ttft_slo=6.0),
        api.TenantClass("bulk", weight=1.0, tier="batch")])
    for i in range(3):
        sched.submit(_req(api, i, "bulk"))
    for i in range(3, 6):
        sched.submit(_req(api, i, "fast"))
    return _drain(api, sched, 6)


def starvation(api):
    sched = api.TenantScheduler([
        api.TenantClass("fast", weight=4.0, tier="interactive"),
        api.TenantClass("bulk", weight=1.0, tier="batch")],
        starvation_threshold=8.0)
    return _drain(api, sched, 60, _saturate(api, {"fast": 4, "bulk": 2}))


def tie_breaks(api):
    sched = api.TenantScheduler([
        api.TenantClass("a", weight=1.0, tier="batch"),
        api.TenantClass("b", weight=1.0, tier="batch")])
    for i in range(12):
        sched.submit(_req(api, i, "a" if i % 2 else "b"))
    return _drain(api, sched, 12)


def default_only_is_fifo(api):
    cfg = api.SchedulerConfig(max_queue_depth=4, default_deadline=7.0)
    out = []
    for s in (api.FifoScheduler(cfg),
              api.TenantScheduler([api.TenantClass(api.DEFAULT)], cfg)):
        for i in range(4):
            s.submit(_req(api, i), now=float(i))
        with pytest.raises(api.QueueFull):
            s.submit(_req(api, 9), now=4.0)
        action, reqs = s.next_action(FakeEngine(free_slots=3,
                                                prefill_batch=2))
        out.append(([(r.id, r.deadline) for r in s.waiting], action,
                    [r.id for r in reqs], [r.id for r in s.expire(20.0)],
                    len(s)))
    assert out[0] == out[1]
    return out


def class_quota(api):
    sched = api.TenantScheduler([
        api.TenantClass("fast", tier="interactive"),
        api.TenantClass("bulk", tier="batch", max_queue_depth=2)])
    sched.submit(_req(api, 0, "bulk"), now=0.0)
    sched.submit(_req(api, 1, "bulk"), now=0.0)
    with pytest.raises(api.ClassQueueFull) as ei:
        sched.submit(_req(api, 2, "bulk"), now=3.0)
    exc = ei.value
    assert isinstance(exc, api.QueueFull)
    sched.submit(_req(api, 3, "fast"))
    return (str(exc), exc.tenant, exc.class_queue_depth,
            exc.class_oldest_age, exc.queue_depth, sched.class_depths(),
            sched.shed_counts())


def global_bound(api):
    sched = api.TenantScheduler([
        api.TenantClass("fast", weight=4.0, tier="interactive"),
        api.TenantClass("bulk", weight=1.0, tier="batch")],
        api.SchedulerConfig(max_queue_depth=3))
    sched.submit(_req(api, 0, "fast"), now=0.0)
    sched.submit(_req(api, 1, "bulk"), now=1.0)
    sched.submit(_req(api, 2, "bulk"), now=2.0)
    with pytest.raises(api.QueueFull) as ei:
        sched.submit(_req(api, 3, "fast"), now=5.0)
    return str(ei.value), ei.value.class_depths, ei.value.class_oldest


def slot_quota(api):
    sched = api.TenantScheduler([
        api.TenantClass("fast", tier="interactive"),
        api.TenantClass("bulk", tier="batch", max_active_slots=2)])
    for i in range(2):
        sched.submit(_req(api, i, "bulk"))
    sched.submit(_req(api, 2, "fast"))
    eng = FakeEngine(free_slots=2, prefill_batch=2,
                     active=[_req(api, 10, "bulk"), _req(api, 11, "bulk")])
    first = sched.next_action(eng)
    second = sched.next_action(FakeEngine(free_slots=2, prefill_batch=2))
    return [(a, [(r.id, r.tenant) for r in reqs])
            for a, reqs in (first, second)]


def class_deadlines(api):
    sched = api.TenantScheduler(
        [api.TenantClass("fast", tier="interactive", default_deadline=2.0),
         api.TenantClass("bulk", tier="batch")],
        api.SchedulerConfig(default_deadline=50.0))
    sched.submit(_req(api, 0, "fast"), now=10.0)
    sched.submit(_req(api, 1, "bulk"), now=10.0)
    sched.submit(_req(api, 2, "fast", deadline=99.0), now=10.0)
    return ({r.id: r.deadline for r in sched.waiting},
            [r.id for r in sched.expire(13.0)])


def bad_configs(api):
    seen = []
    with pytest.raises(ValueError, match="unknown tenant") as ei:
        api.TenantScheduler([api.TenantClass("a")]).submit(
            _req(api, 0, "ghost"))
    seen.append(str(ei.value))
    for kw in (dict(weight=0.0), dict(tier="bogus"), dict(ttft_slo=0.0),
               dict(max_queue_depth=0), dict(max_active_slots=0),
               dict(adapter="")):
        with pytest.raises(ValueError) as ei:
            api.TenantClass("fast", **kw)
        seen.append(str(ei.value))
    with pytest.raises(ValueError, match="duplicate") as ei:
        api.TenantScheduler([api.TenantClass("a"), api.TenantClass("a")])
    seen.append(str(ei.value))
    return seen


SCENARIOS = [fair_share, tiers, starvation, tie_breaks,
             default_only_is_fifo, class_quota, global_bound, slot_quota,
             class_deadlines, bad_configs]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scheduler_decides_as_the_jax_scheduler(scenario):
    want = scenario(JAX)
    assert scenario(PORT) == want


def test_scheduler_policy_invariants():
    """The JAX suite's bounds, on the port's scheduler: 3:1 weights
    converge to 2.5..3.5, interactive drains first, a batch class waits
    at most 9 picks under saturation, ties go to the first-declared."""
    order, counts = fair_share(PORT)
    assert len(order) == 80
    assert 2.5 <= counts["heavy"] / counts["light"] <= 3.5
    assert tiers(PORT) == ["fast"] * 3 + ["bulk"] * 3
    order = starvation(PORT)
    bulk_at = [i for i, t in enumerate(order) if t == "bulk"]
    assert bulk_at and np.diff([-1] + bulk_at).max() <= 9
    assert order.count("fast") > order.count("bulk") * 4
    assert tie_breaks(PORT)[0] == "a"


# ------------------------------------------------------------ serving
CLASSES = ("fast", "bulk")
TTRACE = [
    (0, dict(prompt=[5, 17, 3, 9], max_new_tokens=5, tenant="bulk")),
    (0, dict(prompt=[9, 2, 44], max_new_tokens=4, tenant="bulk")),
    (0, dict(prompt=[42, 7], max_new_tokens=5, tenant="fast")),
    (1, dict(prompt=[1], max_new_tokens=4, tenant="bulk")),
    (2, dict(prompt=[8, 8, 8], max_new_tokens=3, tenant="fast")),
    (2, dict(prompt=[3, 1, 4, 1], max_new_tokens=4)),
    (3, dict(prompt=[2, 7], max_new_tokens=6, tenant="ghost")),
]


def _classes(api):
    return [api.TenantClass("fast", weight=3.0, tier="interactive"),
            api.TenantClass("bulk", weight=1.0, tier="batch",
                            max_active_slots=1, max_queue_depth=2)]


@pytest.fixture(scope="module")
def port(serve_nano_family):
    _, params = serve_nano_family[:2]
    return load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, vocab_size=128, max_seq_len=32),
        device="cpu"), params)


@pytest.mark.parametrize("async_dispatch", [False, True],
                         ids=["sync", "async"])
def test_mixed_class_trace_matches_jax(serve_nano_family, port,
                                       async_dispatch):
    """Two classes (weights 3:1, the batch class held to one slot and a
    queue of two) and the default class on one engine: tokens, finish
    reasons, tenant stamps, tick stamps and admission counts equal the
    JAX client's; an unknown tenant is shed as rejected."""
    dec, params = serve_nano_family[:2]
    kw = dict(num_slots=3, prefill_len=8, async_dispatch=async_dispatch)
    jclient = jax_serve.ServeClient(dec, params,
                                    tenant_classes=_classes(JAX), **kw)
    ref = jclient.serve_trace(list(TTRACE))
    jcounts = jclient.scheduler.admitted_counts()
    jclient.shutdown()
    client = port_serve.ServeClient(port, port.state_dict(), device="cpu",
                                    tenant_classes=_classes(PORT), **kw)
    out = client.serve_trace(list(TTRACE))
    assert client.scheduler.admitted_counts() == jcounts
    client.shutdown()
    assert sorted(out) == sorted(ref)
    for rid in ref:
        a, b = ref[rid], out[rid]
        assert (b.tokens, b.finish_reason, b.tenant) == (
            a.tokens, a.finish_reason, a.tenant), rid
        assert (b.arrival_time, b.first_token_time, b.finish_time) == (
            a.arrival_time, a.first_token_time, a.finish_time), rid
    assert out[6].finish_reason == "rejected" and out[6].tenant == "ghost"


def test_tokens_equal_the_solo_runs(port):
    """Scheduling orders admissions, never tokens: each request's tokens
    under tenancy are its solo run's."""
    kw = dict(num_slots=3, prefill_len=8, device="cpu")
    client = port_serve.ServeClient(port, port.state_dict(),
                                    tenant_classes=_classes(PORT), **kw)
    out = client.serve_trace([e for e in TTRACE
                              if e[1].get("tenant") != "ghost"])
    client.shutdown()
    for rid, (_, entry) in enumerate(TTRACE[:6]):
        solo = port_serve.ServeClient(port, port.state_dict(), **kw)
        sid = solo.submit(**{k: v for k, v in entry.items()
                             if k != "tenant"})
        assert solo.run_until_idle()[sid].tokens == out[rid].tokens, rid
        solo.shutdown()


def test_engine_enforces_max_active_slots_for_direct_callers(port):
    """A direct ``engine.prefill`` past a class's ``max_active_slots``
    raises ``SlotPoolFull`` with the tenant in its context, and the
    batch rolls back; an undeclared tenant is refused at validation, and
    a tenant on an engine without classes too."""
    eng = port_serve.ServeEngine(port, port.state_dict(), num_slots=3,
                                 prefill_len=8, device="cpu",
                                 tenant_classes=_classes(PORT))
    Request = port_serve.Request
    eng.prefill([Request(id=0, prompt=[1, 2], max_new_tokens=4,
                         tenant="bulk")])
    with pytest.raises(port_serve.SlotPoolFull, match="max_active_slots") \
            as ei:
        eng.prefill([Request(id=1, prompt=[3], max_new_tokens=4,
                             tenant="fast"),
                     Request(id=2, prompt=[4], max_new_tokens=4,
                             tenant="bulk")])
    assert ei.value.tenant == "bulk"
    assert eng.free_slots == 2 and sorted(eng.active_requests) == [0]
    with pytest.raises(ValueError, match="unknown tenant"):
        eng.validate(Request(id=3, prompt=[1], max_new_tokens=2,
                             tenant="ghost"))
    eng.shutdown()
    plain = port_serve.ServeEngine(port, port.state_dict(), num_slots=2,
                                   prefill_len=8, device="cpu")
    with pytest.raises(ValueError, match="no tenant classes"):
        plain.validate(Request(id=0, prompt=[1], max_new_tokens=2,
                               tenant="fast"))
    plain.shutdown()
