"""The port's crash supervision (``ServeClient(retry_policy=)``, ``ServeSupervisor``, crash replay) against the JAX package.

Both packages' supervised clients replay the same nano traces (the
``serve_nano_family`` shapes: vocab 128, max_seq_len 32, f32, unrolled,
prefill_len 8, so the JAX legs compile nothing new) under the same
``FaultPlan``: dispatch crashes at a prefill, mid-decode, mid-chunk and
during a replay's own chunk re-feed, ``serve.verify`` crashes in spec
rounds, crashes at an async enqueue with a dispatch in flight, and plans
that exhaust the retry policy. Greedy tokens, tick stamps, completion
order, finish reasons (``"failed"`` for an overlong replay and after
exhaustion) and the supervisor's counters (``rebuilds``,
``recoveries``, ``failed_requests``) must be identical, on the three
layouts, int8 KV, chunked with and without the prefix cache, spec, async
dispatch, int8 and int4 weights (the JAX Pallas kernels in interpret
mode where the JAX scenario names them) and multi-LoRA with tenancy.

Sampled streams cannot match across frameworks, so a trace's sampled
rows are held only by their stamps and finish reasons there, and inside
the port a sampled stream under faults must equal the same stream
without faults (the seeds are ``row_seed(engine seed, request seed,
step)``). The rest mirrors the JAX scenarios that need no second
framework: the sync driver's retry seat after a failed host copy, the
async client's kept and parked handles, foreign handles after a rebuild,
a cancel during a replay's chunk re-feed, and a rebuild that leaves no
second engine alive.
"""
import weakref

import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import lora as jax_lora
from ray_lightning_tpu.reliability import FaultPlan as JaxFaultPlan
from ray_lightning_tpu.reliability import RetryPolicy as JaxRetryPolicy
from ray_lightning_tpu.reliability import ServeSupervisor as JaxSupervisor
from ray_lightning_tpu.reliability.retry import \
    call_with_retry as jax_call_with_retry
from ray_lightning_tpu.serve import Request as JaxRequest
from ray_lightning_tpu.serve import ServeClient as JaxServeClient
from ray_lightning_tpu.serve import TenantClass as JaxTenantClass
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.reliability import (FaultPlan, RetriesExhausted,
                                                 RetryPolicy,
                                                 ServeSupervisor,
                                                 call_with_retry)
from ray_lightning_tpu_torch.serve import (FINISH_FAILED, Request,
                                           ServeClient, ServeEngine,
                                           TenantClass)

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

MK = dict(vocab_size=128, max_seq_len=32)
PROMPTS = [[5, 17, 3, 9], [9, 2, 44], [42, 7], [1]]
LONG = [7, 1, 9, 3, 5, 2, 8, 4, 6, 1, 2, 3]       # 12 > prefill_len 8
SYSTEM = [11, 12, 13, 14, 15, 16, 17, 18]         # 2 pages at page_size 4
TRACE = [
    (0, dict(prompt=PROMPTS[0], max_new_tokens=6)),
    (0, dict(prompt=PROMPTS[1], max_new_tokens=6)),
    (3, dict(prompt=PROMPTS[2], max_new_tokens=5)),
    (5, dict(prompt=PROMPTS[3], max_new_tokens=6)),
]
SAMPLED = [
    (0, dict(prompt=PROMPTS[0], max_new_tokens=8, temperature=0.9,
             top_k=20, seed=11)),
    (1, dict(prompt=PROMPTS[1], max_new_tokens=8, temperature=0.7,
             seed=23, eos_id=100)),
    (2, dict(prompt=PROMPTS[2], max_new_tokens=8, eos_id=100)),
]
CHUNKED_TRACE = [
    (0, dict(prompt=PROMPTS[0], max_new_tokens=6)),
    (1, dict(prompt=LONG, max_new_tokens=8)),
    (3, dict(prompt=PROMPTS[2], max_new_tokens=5, temperature=0.8,
             top_k=16, seed=91)),
]
PREFIX_TRACE = [
    (0, dict(prompt=SYSTEM + [5, 17, 3], max_new_tokens=5)),
    (0, dict(prompt=LONG, max_new_tokens=6)),
    (4, dict(prompt=SYSTEM + [9, 2], max_new_tokens=5)),
    (6, dict(prompt=[42, 7], max_new_tokens=4)),
]
LORA_TRACE = [
    (0, dict(prompt=[1, 2, 3], max_new_tokens=6, adapter="a", seed=100)),
    (0, dict(prompt=[2, 2, 3], max_new_tokens=6, adapter="b", seed=101,
             tenant="bulk")),
    (1, dict(prompt=[3, 2, 3], max_new_tokens=6, seed=102, tenant="fast")),
    (2, dict(prompt=[4, 2, 3], max_new_tokens=5, adapter="a",
             temperature=0.9, seed=103, tenant="fast")),
]
MIXED_TRACE = [       # tests/test_tenancy.py's
    (0, dict(prompt=[11, 12], max_new_tokens=5, tenant="bulk")),
    (0, dict(prompt=[13, 14, 9], max_new_tokens=5, tenant="bulk")),
    (0, dict(prompt=[15], max_new_tokens=4, tenant="fast")),
    (1, dict(prompt=[16, 8], max_new_tokens=4, tenant="fast",
             temperature=0.8, top_k=12)),
    (2, dict(prompt=[4, 2, 6], max_new_tokens=4)),
    (4, dict(prompt=[7, 7], max_new_tokens=3, tenant="bulk")),
]
# prompt 4 + 6 emitted > prefill_len 8 at tick 6: not replayable without
# chunks, so it retires "failed"; the short one replays
OVERFLOW_TRACE = [(0, dict(prompt=PROMPTS[0], max_new_tokens=8)),
                  (0, dict(prompt=PROMPTS[3], max_new_tokens=8))]
CHUNKED = dict(page_size=4, prefill_chunk=8)
PREFIX = dict(page_size=4, prefill_chunk=8, prefix_cache=True)
PN = dict(page_size=4, page_native=True)
GS = 8
RANK, CAP = 2, 2


def _classes(cls, slo=6.0):
    return [cls("fast", weight=4.0, tier="interactive", ttft_slo=slo),
            cls("bulk", weight=1.0, tier="batch"), cls("default")]


#: id -> (trace, kwargs for both, JAX-only, port-only, site, ticks,
#: max_attempts, extras): "spec" adds the draft, "lora" the adapters and
#: tenant classes, "tenancy" the tenant classes (2 slots)
SCENARIOS = {
    "dense": (TRACE, {}, {}, {}, "serve.dispatch", [0, 3, 7], 3, ()),
    "dense-steps3": (TRACE, dict(steps_per_dispatch=3), {}, {},
                     "serve.dispatch", [0, 3, 7], 3, ()),
    "view-int8kv": (TRACE, dict(page_size=4, kv_dtype="int8"), {}, {},
                    "serve.dispatch", [4], 3, ()),
    "page-native": (TRACE, PN, {}, {}, "serve.dispatch", [4], 3, ()),
    "page-native-kernel": (TRACE, PN, dict(attention_kernel="pallas"),
                           dict(attention_kernel="cuda"),
                           "serve.dispatch", [0, 4], 3, ()),
    "chunked-mid-chunk": (CHUNKED_TRACE, CHUNKED, {}, {}, "serve.dispatch",
                          [1], 3, ()),
    "chunked-chunk-and-decode": (CHUNKED_TRACE, CHUNKED, {}, {},
                                 "serve.dispatch", [2, 7], 3, ()),
    "prefix": (PREFIX_TRACE, dict(PREFIX, page_native=True), {}, {},
               "serve.dispatch", [1, 6, 11], 3, ()),
    "spec-dense": (TRACE, {}, {}, {}, "serve.verify", [2], 3, ("spec",)),
    "spec-view": (TRACE, dict(page_size=4), {}, {}, "serve.verify", [2],
                  3, ("spec",)),
    "spec-page-native": (TRACE, PN, {}, {}, "serve.verify", [1, 3], 3,
                         ("spec",)),
    "async": (TRACE, dict(async_dispatch=True), {}, {}, "serve.dispatch",
              [4], 3, ()),
    "async-page-native-spec": (TRACE, dict(PN, async_dispatch=True), {},
                               {}, "serve.verify", [2], 3, ("spec",)),
    "int8-weights": (TRACE, dict(weight_dtype="int8"), {}, {},
                     "serve.dispatch", [4], 3, ()),
    "int4-weights-view": (TRACE, dict(page_size=4, weight_dtype="int4",
                                      weight_group_size=GS), {}, {},
                          "serve.dispatch", [4], 3, ()),
    "int4-weights-kernel": (TRACE, dict(weight_dtype="int4",
                                        weight_group_size=GS),
                            dict(matmul_kernel="pallas"),
                            dict(matmul_kernel="cuda"), "serve.dispatch",
                            [4], 3, ()),
    "lora-tenancy": (LORA_TRACE, dict(page_size=8, num_pages=16,
                                      page_native=True), {}, {},
                     "serve.dispatch", [1, 4], 3, ("lora",)),
    "tenancy": (MIXED_TRACE, {}, {}, {}, "serve.dispatch", [5], 3,
                ("tenancy",)),
    "overflow-failed": (OVERFLOW_TRACE, {}, {}, {}, "serve.dispatch", [6],
                        3, ()),
    "exhausted": (TRACE, {}, {}, {}, "serve.dispatch", range(64), 2, ()),
}


def _rand_adapter(params, seed):
    rng = np.random.default_rng(seed)
    tree = jax_lora.extract_adapter(jax_lora.install_lora_bank(
        params, jax_lora.LoraConfig(rank=RANK, num_adapters=1)), 0)

    def fill(t):
        return {k: fill(v) if isinstance(v, dict) else
                (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in sorted(t.items())}
    return fill(tree)


@pytest.fixture(scope="module")
def env(serve_nano_family):
    dec, params, jdraft, jdparams = serve_nano_family
    target = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, **MK), device="cpu"), params)
    draft = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, n_layers=1, **MK), device="cpu"),
        jdparams)
    ads = {"a": _rand_adapter(params, 1), "b": _rand_adapter(params, 2)}
    return dict(dec=dec, params=params, jdraft=jdraft, jdparams=jdparams,
                target=target, draft=draft, ads=ads)


def _kwargs(env, jax_side, common, extras):
    kw = dict(num_slots=3, prefill_len=8, **common)
    if "spec" in extras:
        kw.update(draft_model=env["jdraft"] if jax_side else env["draft"],
                  draft_params=(env["jdparams"] if jax_side
                                else env["draft"].state_dict()), spec_k=2)
    cls = JaxTenantClass if jax_side else TenantClass
    if "lora" in extras:
        kw.update(adapters=env["ads"], max_resident_adapters=CAP,
                  lora_rank=RANK, tenant_classes=_classes(cls, slo=2.0))
    if "tenancy" in extras:
        kw.update(num_slots=2, tenant_classes=_classes(cls))
    return kw


def _drive(client, trace, plan=None):
    """Replay ``trace`` (under ``plan``); returns the completions and the
    request ids in the order they completed, tick by tick."""
    order = []
    tick = client.tick

    def recording_tick():
        done = tick()
        order.extend(c.request_id for c in done)
        return done

    client.tick = recording_tick
    if plan is None:
        out = client.serve_trace(list(trace))
    else:
        with plan.armed():
            out = client.serve_trace(list(trace))
    return out, order


def _run(env, jax_side, name, faults=True):
    trace, common, jax_kw, port_kw, site, ticks, attempts, extras = \
        SCENARIOS[name]
    kw = _kwargs(env, jax_side, common, extras)
    if jax_side:
        kw.update(jax_kw)
        mk, plan_cls, policy_cls = JaxServeClient, JaxFaultPlan, \
            JaxRetryPolicy
        model, params = env["dec"], env["params"]
    else:
        kw.update(port_kw, device="cpu")
        mk, plan_cls, policy_cls = ServeClient, FaultPlan, RetryPolicy
        model, params = env["target"], env["target"].state_dict()
    plan = plan_cls.at(site, ticks) if faults else None
    client = mk(model, params, retry_policy=policy_cls(
        max_attempts=attempts, base_delay=0.0), **kw)
    out, order = _drive(client, trace, plan)
    eng = client.engine
    counters = (eng.rebuilds, eng.recoveries, eng.failed_requests,
                plan.fired if plan is not None else 0)
    client.shutdown()
    return out, order, counters


def _greedy(trace, rid):
    return not trace[rid][1].get("temperature")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervised_client_matches_jax_under_faults(env, name):
    """Under the same plan: greedy tokens, every request's finish reason
    and tick stamps, the completion order and the supervisor counters
    equal the JAX supervised client's; the port's replayable greedy
    streams equal its own fault-free run."""
    trace = SCENARIOS[name][0]
    ref, ref_order, ref_counters = _run(env, True, name)
    out, order, counters = _run(env, False, name)
    assert counters == ref_counters and counters[3] > 0
    assert order == ref_order
    assert sorted(out) == sorted(ref)
    for rid, a in ref.items():
        b = out[rid]
        assert b.finish_reason == a.finish_reason, rid
        assert (b.arrival_time, b.first_token_time, b.finish_time,
                b.tenant, b.adapter) == (
            a.arrival_time, a.first_token_time, a.finish_time, a.tenant,
            a.adapter), rid
        if _greedy(trace, rid):
            assert b.tokens == a.tokens, rid
        else:
            assert len(b.tokens) == len(a.tokens), rid
    base, _, _ = _run(env, False, name, faults=False)
    for rid, c in out.items():
        if c.finish_reason != FINISH_FAILED:
            assert c.tokens == base[rid].tokens, rid
        else:
            # partial tokens kept: a prefix of the fault-free stream
            assert c.tokens == base[rid].tokens[:len(c.tokens)], rid
    if name == "overflow-failed":
        assert [c.finish_reason for c in out.values()] == [
            FINISH_FAILED, "length"]
        assert len(out[0].tokens) == 6 and counters[2] == 1
    if name == "exhausted":
        assert all(c.finish_reason == FINISH_FAILED for c in out.values())


@pytest.mark.parametrize("name", ["dense", "chunked-chunk-and-decode",
                                  "spec-page-native", "async",
                                  "lora-tenancy"])
def test_sampled_streams_are_replay_exact_inside_the_port(env, name):
    """A sampled trace under the scenario's faults gives the port's
    fault-free tokens, request by request (spec: through the accept
    rule; chunked: through the chunk re-feed)."""
    _, common, _, port_kw, site, ticks, _, extras = SCENARIOS[name]
    trace = LORA_TRACE if "lora" in extras else SAMPLED
    kw = dict(_kwargs(env, False, common, extras), device="cpu", **port_kw)
    sd = env["target"].state_dict()
    base = ServeClient(env["target"], sd, **kw).serve_trace(list(trace))
    plan = FaultPlan.at(site, ticks)
    client = ServeClient(env["target"], sd, retry_policy=RetryPolicy(
        max_attempts=3, base_delay=0.0), **kw)
    out, _ = _drive(client, trace, plan)
    assert plan.fired > 0 and client.engine.rebuilds > 0
    for rid in base:
        assert out[rid].tokens == base[rid].tokens, rid
        assert out[rid].finish_reason == base[rid].finish_reason


def test_double_crash_during_a_replays_chunk_refeed(env):
    """A second crash while the first crash's replay still streams its
    chunk re-feed (replay-of-a-replay) keeps the sampled stream: the
    mid-chunk snapshot falls back to the request's replay tokens."""
    trace = [(0, dict(prompt=LONG, max_new_tokens=8, temperature=0.8,
                      top_k=32, seed=13))]
    kw = dict(num_slots=2, prefill_len=8, device="cpu", **CHUNKED)
    sd = env["target"].state_dict()
    base = ServeClient(env["target"], sd, **kw).serve_trace(trace)
    for second in (5, 6, 7):
        plan = FaultPlan.at("serve.dispatch", [4, second])
        client = ServeClient(env["target"], sd, retry_policy=RetryPolicy(
            max_attempts=3, base_delay=0.0), **kw)
        with plan.armed():
            out = client.serve_trace(trace)
        assert plan.fired == 2, second
        assert out[0].tokens == base[0].tokens, second


def _cancel_mid_replay(sup, plan_cls):
    sup.prefill([sup_request(sup, id=0, prompt=LONG, max_new_tokens=8)])
    while sup.chunk_pending:
        sup.prefill_chunk_step()
    for _ in range(3):
        sup.step()
    slot = sup.engine.pool.slot_of(0)
    pre = list(sup.engine._tokens[slot])
    plan = plan_cls.at("serve.dispatch", [0])
    with plan.armed():
        sup.step()            # crash -> rebuild; the replay routes chunked
    snap = [toks for _r, toks in sup.engine.snapshot_in_flight()]
    return pre, sup.chunk_pending, snap, sup.cancel(0).tokens


def sup_request(sup, **kw):
    return (JaxRequest if isinstance(sup, JaxSupervisor) else Request)(**kw)


def test_cancel_during_a_replays_chunk_refeed_keeps_its_tokens(env):
    """A cancel (deadline) while a crashed request's replay streams its
    chunk re-feed retires it with its pre-crash tokens, and a snapshot
    taken then carries them, as in JAX."""
    kw = dict(num_slots=2, prefill_len=8, **CHUNKED)
    pol = dict(max_attempts=3, base_delay=0.0)
    want = _cancel_mid_replay(JaxSupervisor(
        env["dec"], env["params"], policy=JaxRetryPolicy(**pol), **kw),
        JaxFaultPlan)
    got = _cancel_mid_replay(ServeSupervisor(
        env["target"], env["target"].state_dict(),
        policy=RetryPolicy(**pol), device="cpu", **kw), FaultPlan)
    assert got == want
    pre, pending, snap, cancelled = got
    assert len(pre) == 4 and pending and snap == [pre] == [cancelled]


def _undercommitted(sup, plan=None):
    """Two requests on an arena they fit only by sharing prefix pages."""
    def drive():
        done = []
        done += sup.prefill([sup_request(
            sup, id=0, prompt=SYSTEM + [5, 17, 3], max_new_tokens=5)])
        while sup.chunk_pending:
            done += sup.prefill_chunk_step()
        done += sup.prefill([sup_request(
            sup, id=1, prompt=SYSTEM + [9, 2], max_new_tokens=5, seed=5)])
        while sup.chunk_pending:
            done += sup.prefill_chunk_step()
        while sup.active_count:
            done += sup.step()
        return {c.request_id: (c.tokens, c.finish_reason) for c in done}
    if plan is None:
        return drive(), sup.rebuilds
    with plan.armed():
        return drive(), sup.rebuilds


def test_replay_rebuilds_prefix_sharing_on_an_undercommitted_arena(env):
    """Recovery on an arena the tenants fit only through shared prefix
    pages replays one request a wave (each republishes its pages before
    the next adopts them): tokens equal the fault-free run and JAX's."""
    kw = dict(num_slots=3, prefill_len=8, num_pages=6, **PREFIX)
    pol = dict(max_attempts=3, base_delay=0.0)
    base = _undercommitted(ServeSupervisor(
        env["target"], env["target"].state_dict(), device="cpu", **kw))
    want = _undercommitted(JaxSupervisor(
        env["dec"], env["params"], policy=JaxRetryPolicy(**pol), **kw),
        JaxFaultPlan.at("serve.dispatch", [6]))
    got = _undercommitted(ServeSupervisor(
        env["target"], env["target"].state_dict(),
        policy=RetryPolicy(**pol), device="cpu", **kw),
        FaultPlan.at("serve.dispatch", [6]))
    assert got == want and got[1] == 1
    assert got[0] == base[0]


def test_supervised_hot_load_survives_a_crash(env):
    """A hot load through the supervisor enters its rebuild arguments:
    a crash after the load rebuilds the same resident set, and requests
    bound to the loaded adapter re-bind (tokens equal JAX's)."""
    outs = []
    for jax_side in (True, False):
        kw = dict(num_slots=2, prefill_len=8, adapters={"a": env["ads"]["a"]},
                  max_resident_adapters=CAP, lora_rank=RANK)
        if jax_side:
            client = JaxServeClient(env["dec"], env["params"],
                                    retry_policy=JaxRetryPolicy(
                                        max_attempts=3, base_delay=0.0),
                                    **kw)
            plan = JaxFaultPlan.at("serve.dispatch", [1])
        else:
            client = ServeClient(env["target"], env["target"].state_dict(),
                                 retry_policy=RetryPolicy(
                                     max_attempts=3, base_delay=0.0),
                                 device="cpu", **kw)
            plan = FaultPlan.at("serve.dispatch", [1])
        assert client.load_adapter("b", env["ads"]["b"]) is None
        out, _ = _drive(client, [t for t in LORA_TRACE
                                 if "tenant" not in t[1]], plan)
        assert plan.fired == 1 and client.engine.rebuilds == 1
        assert sorted(client.engine.resident_adapters) == ["a", "b"]
        client.shutdown()
        outs.append({r: (c.tokens, c.adapter) for r, c in out.items()})
    assert outs[0] == outs[1]


# ------------------------------------------------- the port's own seats
def _port_run(env, trace, **kw):
    client = ServeClient(env["target"], env["target"].state_dict(),
                         num_slots=3, prefill_len=8, device="cpu", **kw)
    out = client.serve_trace(list(trace))
    client.shutdown()
    return {r: (c.tokens, c.finish_reason) for r, c in out.items()}


def _failing_sync(monkeypatch, when):
    """Make ``ServeEngine.step_sync`` raise once, when ``when()`` says."""
    real = ServeEngine.step_sync

    def maybe_boom(self, pending):
        if when():
            raise RuntimeError("synthetic device error at host copy")
        return real(self, pending)

    monkeypatch.setattr(ServeEngine, "step_sync", maybe_boom)


def test_sync_step_retries_a_failed_host_copy(env, monkeypatch):
    """A failed host copy in ``step()`` parks the handle in the retry
    seat; the next ``step()`` syncs the SAME dispatch, and the sync
    client drains the seat at its tick's start even when the next
    action is an admission barrier."""
    trace = [(0, dict(prompt=PROMPTS[0], max_new_tokens=8)),
             (0, dict(prompt=PROMPTS[1], max_new_tokens=6))]
    ref = _port_run(env, trace)
    count = {"n": 0}

    def second_sync():
        count["n"] += 1
        return count["n"] == 2

    _failing_sync(monkeypatch, second_sync)
    client = ServeClient(env["target"], env["target"].state_dict(),
                         num_slots=3, prefill_len=8, device="cpu")
    client.submit(**trace[0][1])
    client.tick()                      # prefill
    client.tick()                      # step 1
    with pytest.raises(RuntimeError, match="synthetic"):
        client.tick()                  # step 2's host copy fails
    assert client.engine.retry_pending and client.engine.carry_deferred
    client.submit(**trace[1][1])       # the next tick wants a prefill
    out = client.run_until_idle()
    client.shutdown()
    assert {r: (c.tokens, c.finish_reason) for r, c in out.items()} == ref


def test_async_client_keeps_a_handle_whose_sync_failed(env, monkeypatch):
    """Unsupervised: a failed sync at an admission barrier keeps the
    handle (the engine is untouched), and the resumed loop retries the
    same sync; a failed sync with TWO live handles parks the older one
    in the front seat and resumes in dispatch order."""
    trace = [(0, dict(prompt=p, max_new_tokens=8)) for p in PROMPTS[:3]]
    ref = _port_run(env, trace)
    client = ServeClient(env["target"], env["target"].state_dict(),
                         num_slots=3, prefill_len=8, device="cpu",
                         async_dispatch=True)
    state = {"armed": True}

    def two_handle_sync():
        # _pending already holds dispatch N+1: syncing N is the unique
        # two-live-handles site
        if state["armed"] and client._pending is not None:
            state["armed"] = False
            return True
        return False

    _failing_sync(monkeypatch, two_handle_sync)
    for _t, kw in trace:
        client.submit(**kw)
    with pytest.raises(RuntimeError, match="synthetic"):
        client.run_until_idle()
    assert client._pending_front is not None and client.dispatch_in_flight
    out = client.run_until_idle()
    client.shutdown()
    assert {r: (c.tokens, c.finish_reason) for r, c in out.items()} == ref


def test_async_unsupervised_enqueue_crash_keeps_the_pending_handle(env):
    """Unsupervised: an enqueue crash (fault sites fire before launch)
    puts the outstanding handle back, and the resumed loop drains it."""
    trace = [(0, dict(prompt=p, max_new_tokens=6)) for p in PROMPTS[:3]]
    ref = _port_run(env, trace)
    client = ServeClient(env["target"], env["target"].state_dict(),
                         num_slots=3, prefill_len=8, device="cpu",
                         async_dispatch=True)
    for _t, kw in trace:
        client.submit(**kw)
    plan = FaultPlan.at("serve.dispatch", [4])
    with plan.armed():
        with pytest.raises(Exception, match="injected"):
            client.run_until_idle()
    assert plan.fired == 1 and client.dispatch_in_flight
    out = client.run_until_idle()
    client.shutdown()
    assert {r: (c.tokens, c.finish_reason) for r, c in out.items()} == ref


def test_armed_async_client_survives_a_steady_state_enqueue_crash(env):
    """The armed async client through a crash inside ``step_enqueue``
    with a dispatch in flight (the case where the port departs from the
    reference: the JAX client raises ``AttributeError`` here, so it
    cannot be the oracle). Telemetry armed on the tick clock, a
    ``serve.dispatch`` crash at the first enqueue made while an earlier
    handle is still out, under a retry policy: the greedy tokens (f32)
    equal the disarmed fault-free run's, the recovery's sentinel carries
    its ``enqueued_tick``, and the log holds exactly one
    ``fault.injected`` followed by the recovery's ``engine.rebuild`` and
    ``recovery.replay`` events."""
    from ray_lightning_tpu_torch.obs import Telemetry
    from ray_lightning_tpu_torch.reliability.supervisor import \
        _RecoveredDispatch
    trace = [(0, dict(prompt=p, max_new_tokens=6)) for p in PROMPTS[:3]]
    ref = _port_run(env, trace, async_dispatch=True)

    def armed_client(plan):
        tel = Telemetry()
        client = ServeClient(env["target"], env["target"].state_dict(),
                             num_slots=3, prefill_len=8, device="cpu",
                             async_dispatch=True, telemetry=tel,
                             retry_policy=RetryPolicy(max_attempts=3,
                                                      base_delay=0.0))
        sup = client.engine
        real_enqueue, real_sync = sup.step_enqueue, sup.step_sync
        enqueues, handles, synced = [], [], []

        def recording_enqueue():
            # the serve.dispatch tick this enqueue fires, and whether an
            # earlier dispatch is still out (enqueued, not yet synced)
            enqueues.append((plan.counts().get("serve.dispatch", 0),
                             len(handles) > len(synced)))
            handles.append(real_enqueue())
            return handles[-1]

        def recording_sync(handle):
            synced.append(handle)
            return real_sync(handle)

        sup.step_enqueue, sup.step_sync = recording_enqueue, recording_sync
        with tel.activated(), plan.armed():
            out = client.serve_trace(list(trace))
        client.shutdown()
        return out, tel, sup, enqueues, handles

    # a fault-free armed run finds the first steady-state enqueue's tick
    _out, _tel, _sup, enqueues, _h = armed_client(FaultPlan([]))
    tick = next(t for t, in_flight in enqueues if in_flight)
    plan = FaultPlan.at("serve.dispatch", [tick])
    out, tel, sup, _enq, handles = armed_client(plan)
    assert plan.fired == 1 and sup.rebuilds == 1
    assert {r: (c.tokens, c.finish_reason) for r, c in out.items()} == ref
    sentinels = [h for h in handles if isinstance(h, _RecoveredDispatch)]
    assert len(sentinels) == 1 and sentinels[0].enqueued_tick is not None
    sites = [e.site for e in tel.events()]
    assert sites.count("fault.injected") == 1
    after = sites[sites.index("fault.injected"):]
    assert after.index("engine.rebuild") < after.index("recovery.replay")


def test_supervised_sync_crash_discards_the_newer_handle(env, monkeypatch):
    """A recovery inside ``step_sync`` (a host-copy failure) rebuilds the
    engine while a newer handle is out: the client discards it, never
    syncs it, and the tokens equal the fault-free run's."""
    trace = [(0, dict(prompt=p, max_new_tokens=8)) for p in PROMPTS[:3]]
    ref = _port_run(env, trace)
    count = {"n": 0}

    def second_sync():
        count["n"] += 1
        return count["n"] == 2

    _failing_sync(monkeypatch, second_sync)
    client = ServeClient(env["target"], env["target"].state_dict(),
                         num_slots=3, prefill_len=8, device="cpu",
                         async_dispatch=True, retry_policy=RetryPolicy(
                             max_attempts=3, base_delay=0.0))
    out = client.serve_trace(trace)
    assert client.engine.rebuilds == 1 and not client.dispatch_in_flight
    client.shutdown()
    assert {r: (c.tokens, c.finish_reason) for r, c in out.items()} == ref


def test_recovery_completions_surface_in_the_crashing_tick(env):
    """A recovery inside the enqueue that finishes a request on its
    replay surfaces the completion in that same tick."""
    ref = _port_run(env, [(0, dict(prompt=PROMPTS[0], max_new_tokens=2))])
    client = ServeClient(env["target"], env["target"].state_dict(),
                         num_slots=2, prefill_len=8, device="cpu",
                         async_dispatch=True, retry_policy=RetryPolicy(
                             max_attempts=3, base_delay=0.0))
    client.submit(PROMPTS[0], max_new_tokens=2)
    client.tick()                       # prefill: token 1
    client.tick()                       # enqueue D1 (the final token)
    plan = FaultPlan.at("serve.dispatch", [0])
    with plan.armed():
        done = client.tick()            # enqueue crashes; replay finishes
    assert plan.fired == 1 and client.engine.rebuilds == 1
    assert [c.request_id for c in done] == [0]
    client.shutdown()
    assert (client.completions[0].tokens,
            client.completions[0].finish_reason) == ref[0]


def test_a_rebuilt_away_engines_handle_is_refused(env):
    """The identity token refuses a dead engine's handle even when its
    dispatch index matches the fresh engine's next one."""
    sd = env["target"].state_dict()
    a = ServeEngine(env["target"], sd, num_slots=2, prefill_len=8,
                    device="cpu")
    a.prefill([Request(id=0, prompt=PROMPTS[0], max_new_tokens=4)])
    h = a.step_enqueue()
    b = ServeEngine(env["target"], sd, num_slots=2, prefill_len=8,
                    device="cpu")
    with pytest.raises(RuntimeError, match="foreign handle"):
        b.step_sync(h)
    a.step_sync(h)
    a.shutdown()
    b.shutdown()


def test_a_rebuild_leaves_no_second_engine_alive(env):
    """The dead engine is shut down and unreferenced before its
    replacement is built (the recovery runs outside the except block, so
    no traceback holds it): the card never holds two engines."""
    sup = ServeSupervisor(env["target"], env["target"].state_dict(),
                          policy=RetryPolicy(max_attempts=3, base_delay=0.0),
                          num_slots=3, prefill_len=8, device="cpu", **PN)
    sup.prefill([Request(id=0, prompt=PROMPTS[0], max_new_tokens=6)])
    ref = weakref.ref(sup.engine)
    built = []
    real = sup._engine_cls

    def record(*a, **k):
        # nothing holds the dead engine when the new one allocates
        built.append((sup.engine, ref()))
        return real(*a, **k)

    sup._engine_cls = record
    with FaultPlan.at("serve.dispatch", [0]).armed():
        sup.step()
    assert built == [(None, None)] and sup.rebuilds == 1
    sup.shutdown()


def test_replay_fields_and_failed_completions(env):
    """``Request`` carries the JAX package's replay fields; a supervisor
    that gives up retires every entry ``"failed"`` with its tokens."""
    req = Request(id=3, prompt=[1, 2], max_new_tokens=4)
    assert req.replay_tokens is None and req.crash_implications == 0
    sup = ServeSupervisor(env["target"], env["target"].state_dict(),
                          policy=RetryPolicy(max_attempts=1, base_delay=0.0),
                          num_slots=2, prefill_len=8, device="cpu")
    sup.prefill([Request(id=0, prompt=PROMPTS[0], max_new_tokens=6)])
    sup.step()
    with FaultPlan.at("serve.dispatch", range(8)).armed():
        done = sup.step()
    assert [(c.request_id, c.finish_reason, len(c.tokens)) for c in done] \
        == [(0, FINISH_FAILED, 2)]
    assert (sup.rebuilds, sup.recoveries, sup.failed_requests) == (2, 1, 1)
    assert sup.active_count == 0 and sup.recovery_s_total > 0


@pytest.mark.parametrize("seed,salt", [(0, 0), (7, 0), (7, 3)])
def test_retry_policy_delays_and_schedule_equal_jax(seed, salt):
    """The deterministic jitter is the JAX policy's, delay for delay, and
    ``call_with_retry`` sleeps the same schedule and exhausts the same
    way."""
    kw = dict(max_attempts=5, base_delay=0.05, max_delay=0.3,
              multiplier=2.0, jitter=0.25, seed=seed)
    mine, theirs = RetryPolicy(**kw), JaxRetryPolicy(**kw)
    assert [mine.delay(a, salt) for a in range(1, 8)] == [
        theirs.delay(a, salt) for a in range(1, 8)]
    slept = ([], [])

    def fail(attempt):
        raise OSError(f"attempt {attempt}")

    for fn, policy, out in ((call_with_retry, mine, slept[0]),
                            (jax_call_with_retry, theirs, slept[1])):
        with pytest.raises(Exception, match="exhausted 5 attempt"):
            fn(fail, policy, sleep=out.append)
    assert slept[0] == slept[1] and len(slept[0]) == 4
    assert call_with_retry(lambda a: a, mine) == 1
    with pytest.raises(RetriesExhausted):
        call_with_retry(fail, RetryPolicy(max_attempts=3, deadline=1.0,
                                          base_delay=0.0),
                        clock=iter([0.0, 2.0]).__next__,
                        sleep=lambda s: None)
