"""The port's telemetry (``ray_lightning_tpu_torch/obs``, the engine's and client's ``telemetry=``) against the JAX package.

Two halves:

- The copied primitives give the JAX package's results on the same
  calls: the event ring, its drop counter and one-shot warning, the
  site filter, JSONL bytes and rotation, metric snapshots and Prometheus
  text, histogram quantiles (exact and past the reservoir), the Chrome
  trace, and the scoping of the process-global handle with its channels
  (``fault.injected``, ``log.suppressed``, ``retry.attempt``).
- On the suite's nano traces (the ``serve_nano_family`` shapes, f32),
  the tick-clock JSONL event log of the port's client equals the JAX
  client's line for line, and so do the metric snapshots and the Chrome
  traces of the engine spans, for the page-native, chunked-with-prefix,
  spec, async, int8/int4-weights and LoRA-with-tenancy clients, under a
  fault plan with a retry policy and the global channels activated. One
  metric is dropped, on the async client only:
  ``serve_dispatch_overlap_ms`` is wall time between an enqueue's
  return and its sync (not a tick quantity, so no two runs agree on it
  even within one framework). The async runs crash only at a prefill:
  the JAX async client with telemetry armed raises ``AttributeError``
  when a recovery happens inside an enqueue (its recovery sentinel has
  no ``enqueued_tick`` slot; ``ROADMAP.md`` C), so that case is held
  inside the port by
  ``tests/test_torch_reliability.py::test_armed_async_client_survives_a_steady_state_enqueue_crash``.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

import ray_lightning_tpu.obs as jax_obs
from ray_lightning_tpu.models import lora as jax_lora
from ray_lightning_tpu.reliability import FaultPlan as JaxFaultPlan
from ray_lightning_tpu.reliability import RetryPolicy as JaxRetryPolicy
from ray_lightning_tpu.reliability import call_with_retry as jax_retry
from ray_lightning_tpu.reliability import log_suppressed as jax_suppressed
from ray_lightning_tpu.serve import ServeClient as JaxServeClient
from ray_lightning_tpu.serve import ServeEngine as JaxServeEngine
from ray_lightning_tpu.serve import TenantClass as JaxTenantClass
import ray_lightning_tpu_torch.obs as obs
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.reliability import (FaultPlan, RetryPolicy,
                                                 call_with_retry,
                                                 log_suppressed)
from ray_lightning_tpu_torch.serve import (ServeClient, ServeEngine,
                                           TenantClass)

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

MK = dict(vocab_size=128, max_seq_len=32)
PROMPTS = [[5, 17, 3, 9], [9, 2, 44], [42, 7], [1]]
LONG = [7, 1, 9, 3, 5, 2, 8, 4, 6, 1, 2, 3]
SYSTEM = [11, 12, 13, 14, 15, 16, 17, 18]
TRACE = [
    (0, dict(prompt=PROMPTS[0], max_new_tokens=6)),
    (0, dict(prompt=PROMPTS[1], max_new_tokens=6)),
    (3, dict(prompt=PROMPTS[2], max_new_tokens=5)),
    (5, dict(prompt=PROMPTS[3], max_new_tokens=6, deadline=8.0)),
    (6, dict(prompt=[3] * 30, max_new_tokens=6)),     # rejected
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
    (2, dict(prompt=[4, 2, 3], max_new_tokens=5, adapter="a", seed=103,
             tenant="fast")),
    (2, dict(prompt=[4, 4, 3], max_new_tokens=5, seed=104, tenant="bulk")),
]
PN = dict(page_size=4, page_native=True)
#: id -> (trace, kwargs, fault site, ticks, extras)
CLIENTS = {
    "page-native": (TRACE, PN, "serve.dispatch", [0, 3, 7], ()),
    "chunked-prefix": (PREFIX_TRACE, dict(PN, prefill_chunk=8,
                                          prefix_cache=True),
                       "serve.dispatch", [1, 6, 11], ()),
    "spec": (TRACE, dict(PN), "serve.verify", [2], ("spec",)),
    "async": (TRACE, dict(PN, async_dispatch=True), "serve.dispatch", [0],
              ()),
    "async-spec": (TRACE, dict(PN, async_dispatch=True), "serve.dispatch",
                   [0], ("spec",)),
    "int8-weights-spec": (TRACE, dict(weight_dtype="int8",
                                      draft_weight_dtype="int8",
                                      prefill_batch=5),
                          "serve.dispatch", [4], ("spec",)),
    "int4-weights": (TRACE, dict(page_size=4, weight_dtype="int4",
                                 weight_group_size=8), "serve.dispatch",
                     [4], ()),
    "lora-tenancy": (LORA_TRACE, dict(page_size=8, num_pages=16,
                                      page_native=True),
                     "serve.dispatch", [1, 4], ("lora",)),
}
#: metrics that are wall time by definition (module docstring)
WALL_METRICS = ("serve_dispatch_overlap_ms",)


# ------------------------------------------------------------ primitives
def _both(fn):
    """``fn(module)`` on the JAX package's obs module and the port's."""
    return fn(jax_obs), fn(obs)


def test_event_ring_drop_counter_and_filter_equal_jax():
    def run(m):
        tel = m.Telemetry(capacity=3)
        for i in range(6):
            tel.event("a.site", i=i)
        tel.event("serve.submit", id=0, site="payload-site")
        return ([e.to_json() for e in tel.events()],
                [e.tick for e in tel.events("a.")], tel.bus.dropped,
                tel.bus.tick, tel.metrics.snapshot())
    want, got = _both(run)
    assert got == want
    assert got[2] > 0 and got[4]["obs_events_dropped_total"] == got[2]


def test_wall_clock_events_equal_jax():
    def run(m):
        t = [0.0]
        bus = m.EventBus(clock=lambda: t[0])
        bus.emit("x")
        t[0] = 0.25
        return [bus.emit("y", n=1).to_json(), bus.emit("z").wall_ms]
    want, got = _both(run)
    assert got == want and json.loads(got[0])["wall_ms"] == 250.0


def test_jsonl_bytes_and_rotation_equal_jax(tmp_path):
    def run(m):
        root = tmp_path / m.__name__
        root.mkdir()
        path = str(root / "ev.jsonl")
        bus = m.EventBus(jsonl_path=path, flush_every=3, rotate_bytes=200)
        for i in range(11):
            bus.emit("s", i=i, pad="x" * (i % 4))
        bus.flush()
        sink = m.JsonlSink(str(root / "sink.jsonl"), rotate_bytes=64)
        for i in range(4):
            sink.write(json.dumps({"i": i, "pad": "x" * 30}))
            sink.flush()
        return {f: (root / f).read_bytes() for f in sorted(os.listdir(root))}
    want, got = _both(run)
    assert got == want
    assert "ev.jsonl.1" in got and "sink.jsonl.1" in got


def test_a_pickled_copy_never_writes_the_drivers_jsonl(tmp_path):
    path = str(tmp_path / "driver.jsonl")
    tel = obs.Telemetry(jsonl_path=path)
    tel.event("driver.event")
    tel.flush()
    before = open(path, "rb").read()
    copy = pickle.loads(pickle.dumps(tel))
    copy.event("worker.event")
    copy.flush()
    assert open(path, "rb").read() == before
    assert [e.site for e in copy.events()] == ["driver.event",
                                               "worker.event"]


def test_metrics_snapshot_prometheus_and_quantiles_equal_jax():
    rng = np.random.default_rng(3)
    samples = rng.lognormal(2.0, 1.5, size=300).tolist()

    def run(m):
        reg = m.MetricsRegistry()
        reg.counter("serve_requests_total", help="requests").inc(3)
        reg.counter("c.with.dots").inc(0.5)
        g = reg.gauge("serve_queue_depth", help="depth")
        g.set(4)
        g.dec(1.5)
        exact = reg.histogram("serve_ttft", help="ttft")
        capped = reg.histogram("capped", max_samples=50,
                               buckets=m.log_buckets(0.5, 500.0, 12))
        for v in samples:
            exact.observe(v)
            capped.observe(v)
        qs = [0.0, 0.1, 0.5, 0.9, 0.99, 1.0]
        with pytest.raises(TypeError):
            reg.gauge("serve_requests_total")
        return (reg.snapshot(), reg.prometheus_text(),
                [exact.quantile(q) for q in qs],
                [capped.quantile(q) for q in qs], m.DEFAULT_LATENCY_BUCKETS)
    want, got = _both(run)
    assert got == want
    assert got[2][2] == float(np.percentile(samples, 50))


def test_spans_and_chrome_trace_equal_jax(tmp_path):
    def run(m):
        rec = m.SpanRecorder(capacity=4)
        with rec.span("fit", epochs=1):
            with rec.span("epoch", epoch=0):
                for i in range(3):
                    with rec.span("train_batch", idx=i):
                        pass
        rec.begin("outer")
        rec.end()
        path = rec.export_chrome_trace(str(tmp_path / f"{m.__name__}.json"))
        return (rec.chrome_trace(), rec.dropped, open(path, "rb").read(),
                [(s.name, s.depth) for s in rec.spans()])
    want, got = _both(run)
    assert got == want and got[1] == 2


def test_global_channels_and_their_scoping_equal_jax(caplog):
    """Activation nests stack-wise; faults, suppressed exceptions and
    retry attempts land on the activated handle only."""
    def run(m, plan_cls, suppressed, retry, policy_cls):
        assert m.get_global() is None
        m.emit_global("x")
        a, b = m.Telemetry(), m.Telemetry()
        plan = plan_cls.at("serve.dispatch", [1])
        with a.activated(), plan.armed():
            m.emit_global("hit", n=1)
            plan.fire("serve.dispatch")
            with pytest.raises(Exception, match="injected"):
                plan.fire("serve.dispatch")
            with b.activated():
                m.emit_global("inner")
                suppressed("site.x", ValueError("boom"), "detail")
            assert m.get_global() is a
            calls = iter([OSError("first"), None])

            def flaky(attempt):
                err = next(calls)
                if err is not None:
                    raise err
                return attempt
            assert retry(flaky, policy_cls(base_delay=0.0),
                         site="s", sleep=lambda s: None) == 2
        assert m.get_global() is None
        return ([e.to_json() for e in a.events()],
                [e.to_json() for e in b.events()],
                a.metrics.snapshot(), b.metrics.snapshot())
    want = run(jax_obs, JaxFaultPlan, jax_suppressed, jax_retry,
               JaxRetryPolicy)
    got = run(obs, FaultPlan, log_suppressed, call_with_retry, RetryPolicy)
    assert got == want
    assert '"site":"fault.injected"' in got[0][1]


# ------------------------------------------------------------- serving
def _rand_adapter(params, seed):
    rng = np.random.default_rng(seed)
    tree = jax_lora.extract_adapter(jax_lora.install_lora_bank(
        params, jax_lora.LoraConfig(rank=2, num_adapters=1)), 0)

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


def _kwargs(env, jax_side, name):
    _, kw, _, _, extras = CLIENTS[name]
    kw = dict(num_slots=3, prefill_len=8, **kw)
    if "spec" in extras:
        kw.update(draft_model=env["jdraft"] if jax_side else env["draft"],
                  draft_params=(env["jdparams"] if jax_side
                                else env["draft"].state_dict()), spec_k=2)
    if "lora" in extras:
        cls = JaxTenantClass if jax_side else TenantClass
        kw.update(adapters=env["ads"], max_resident_adapters=2, lora_rank=2,
                  tenant_classes=[
                      cls("fast", weight=4.0, tier="interactive",
                          ttft_slo=2.0),
                      cls("bulk", weight=1.0, tier="batch",
                          max_queue_depth=1),
                      cls("default")])
    if not jax_side:
        kw["device"] = "cpu"
    return kw


def _logged_run(env, jax_side, name, path):
    """Serve the client's trace under its fault plan with a tick-clock
    telemetry (JSONL at ``path``) armed and activated. Returns the
    JSONL lines, the metric snapshot, the Chrome trace and the tokens."""
    trace, _, site, ticks, _ = CLIENTS[name]
    if jax_side:
        m, mk, plan_cls, pol = jax_obs, JaxServeClient, JaxFaultPlan, \
            JaxRetryPolicy
        model, params = env["dec"], env["params"]
    else:
        m, mk, plan_cls, pol = obs, ServeClient, FaultPlan, RetryPolicy
        model, params = env["target"], env["target"].state_dict()
    tel = m.Telemetry(jsonl_path=path)
    plan = plan_cls.at(site, ticks)
    with tel.activated():
        client = mk(model, params, telemetry=tel,
                    retry_policy=pol(max_attempts=3, base_delay=0.0),
                    **_kwargs(env, jax_side, name))
        with plan.armed():
            out = client.serve_trace(list(trace))
        if "lora" in CLIENTS[name][4]:
            client.load_adapter("c", env["ads"]["a"])   # evicts an LRU
            client.unload_adapter("c")
        client.shutdown()
    tel.flush()
    assert plan.fired > 0
    snap = {k: v for k, v in tel.metrics.snapshot().items()
            if k not in WALL_METRICS}
    return (open(path).read().splitlines(), snap, tel.spans.chrome_trace(),
            {r: (c.tokens, c.finish_reason) for r, c in out.items()})


def _scalars(value):
    """Every leaf of a payload is a Python int, float, str, bool or None
    (no numpy or torch scalar: the JSONL must be byte-stable)."""
    if isinstance(value, dict):
        return all(_scalars(v) for v in value.values())
    if isinstance(value, list):
        return all(_scalars(v) for v in value)
    return value is None or type(value) in (int, float, str, bool)


@pytest.mark.parametrize("name", sorted(CLIENTS))
def test_client_event_log_equals_jax_line_for_line(env, name, tmp_path):
    want = _logged_run(env, True, name, str(tmp_path / "jax.jsonl"))
    got = _logged_run(env, False, name, str(tmp_path / "port.jsonl"))
    lines, snap, trace, tokens = got
    assert len(lines) == len(want[0]) and lines
    for i, (a, b) in enumerate(zip(want[0], lines)):
        assert b == a, (i, a, b)
    assert snap == want[1]
    assert trace == want[2]
    assert tokens == want[3]
    docs = [json.loads(line) for line in lines]
    assert all(_scalars(d["payload"]) for d in docs)
    sites = {d["site"] for d in docs}
    assert {"serve.submit", "serve.retire", "fault.injected",
            "engine.rebuild", "recovery.replay", "retry.attempt",
            "log.suppressed"} <= sites
    spans = {e["name"] for e in trace["traceEvents"]}
    assert spans <= {"engine.prefill", "engine.chunk", "engine.step",
                     "engine.spec_round"} and spans


def test_engine_events_for_direct_calls_equal_jax(env, tmp_path):
    """Events the client never drives: the prefill-batch clamp and the
    adapter loads, evictions and unloads on a bare engine."""
    def run(jax_side):
        m = jax_obs if jax_side else obs
        tel = m.Telemetry()
        kw = dict(num_slots=2, prefill_len=8, prefill_batch=5,
                  max_resident_adapters=2, lora_rank=2,
                  adapters={"a": env["ads"]["a"]}, telemetry=tel)
        with pytest.warns(UserWarning, match="clamped"):
            if jax_side:
                eng = JaxServeEngine(env["dec"], env["params"], **kw)
            else:
                eng = ServeEngine(env["target"], env["target"].state_dict(),
                                  device="cpu", **kw)
        eng.load_adapter("b", env["ads"]["b"])
        eng.load_adapter("c", env["ads"]["a"])
        eng.unload_adapter("b")
        eng.shutdown()
        return [e.to_json() for e in tel.events()], tel.metrics.snapshot()
    want, got = run(True), run(False)
    assert got == want
    assert [json.loads(e)["site"] for e in got[0]][:2] == [
        "engine.config_clamped", "engine.adapter_loaded"]


def test_a_disarmed_client_builds_no_telemetry(env):
    """``telemetry=None`` is the default: nothing is created behind the
    caller's back, and the disarmed path runs."""
    client = ServeClient(env["target"], env["target"].state_dict(),
                         num_slots=1, prefill_len=4, device="cpu",
                         retry_policy=RetryPolicy(base_delay=0.0))
    assert client._tel is None and client.engine._tel is None
    assert client.engine.engine._span_extra == {}
    client.submit([5], max_new_tokens=2)
    assert client.run_until_idle()[0].finish_reason == "length"
    client.shutdown()
