"""The port's request tracing (``ray_lightning_tpu_torch/obs/tracing.py``, ``Telemetry.request_traces``, the fleet's Chrome export) against the JAX package.

The assembler is a copy, so on the same events it must build the same
traces: the synthetic event lists of ``tests/test_tracing.py`` go
through both modules and the traces, reports and Chrome documents must
be equal. On live runs (the ``serve_nano_family`` shapes, the tick
clock): an async client's traces and a 3-replica fleet's traces under a
mid-decode replica kill equal the JAX client's and fleet's, segment for
segment (every stamp a tick count: no tolerance), and the fleet's
exported Chrome trace is byte-identical to the JAX fleet's. The port's
report tools (``tools/trace_report_torch.py``,
``tools/journal_report_torch.py``) print what the JAX tools print over
the same files. The process fleet's cases (``tests/test_tracing.py``'s
``fleet_process`` ones, wall clock, workers on the CPU): worker spans
forwarded seat-tagged, and traces stitched across a replica's kill -9.
"""
import dataclasses
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

import ray_lightning_tpu.obs as jax_obs
import ray_lightning_tpu.obs.tracing as jax_tracing
import ray_lightning_tpu.reliability as jax_rel
import ray_lightning_tpu.serve as jax_serve
import ray_lightning_tpu_torch.obs as obs
import ray_lightning_tpu_torch.obs.tracing as tracing
import ray_lightning_tpu_torch.reliability as rel
import ray_lightning_tpu_torch.serve as serve
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MK = dict(vocab_size=128, max_seq_len=32)
TRACE = [
    (0, dict(prompt=[5, 17, 3, 9], max_new_tokens=6)),
    (0, dict(prompt=[9, 2, 44], max_new_tokens=6)),
    (3, dict(prompt=[42, 7], max_new_tokens=5)),
    (5, dict(prompt=[1], max_new_tokens=6)),
]


def _ev(site, **payload):
    return {"site": site, "t": payload.get("t", 0), "payload": payload}


SYNTHETIC = {
    "sync-split": [
        _ev("fleet.route", id=1, replica=2, load=0),
        _ev("serve.submit", id=1, prompt_len=4, max_new_tokens=8, t=0.0),
        _ev("engine.tenant_admitted", id=1, tenant="interactive"),
        _ev("serve.admit", id=1, queue_wait=2.0, t=2.0),
        _ev("engine.prefill", n=1, ids=[1], slots=[3]),
        _ev("serve.first_token", id=1, ttft=5.0, t=5.0),
        _ev("serve.retire", id=1, finish_reason="length", tokens=8,
            tenant="interactive", t=10.0, sync=1.0),
    ],
    "failover-edge": [
        _ev("serve.submit", id=7, prompt_len=2, t=0.0),
        _ev("serve.admit", id=7, queue_wait=1.0, t=1.0),
        _ev("serve.first_token", id=7, ttft=3.0, t=3.0),
        _ev("fleet.route", id=7, replica=1, load=0),
        _ev("serve.submit", id=7, prompt_len=2, t=5.0),
        _ev("recovery.replay", id=7, replayed_tokens=4),
        _ev("serve.admit", id=7, queue_wait=0.5, t=6.0),
        _ev("serve.retire", id=7, finish_reason="length", tokens=8,
            t=9.0),
    ],
    "lost-first-admit": [
        _ev("serve.submit", id=5, prompt_len=2, t=1.0),
        _ev("serve.submit", id=5, prompt_len=2, t=6.0),
        _ev("serve.admit", id=5, queue_wait=5.5, t=6.5),
        _ev("serve.first_token", id=5, ttft=6.0, t=7.0),
        _ev("serve.retire", id=5, finish_reason="length", tokens=4,
            t=9.0),
    ],
    "truncated-ring": [
        _ev("serve.admit", id=3, queue_wait=1.0, t=4.0),
        _ev("serve.retire", id=3, finish_reason="length", tokens=2,
            t=8.0),
        _ev("serve.submit", id=4, prompt_len=1, t=5.0),
        _ev("serve.admit", id=4, queue_wait=0.0, t=5.0),
        _ev("serve.retire", id=4, finish_reason="length", tokens=1,
            t=7.0),
    ],
    "slo": [
        _ev("serve.submit", id=1, t=0.0),
        _ev("serve.admit", id=1, queue_wait=2.0, t=2.0),
        _ev("serve.first_token", id=1, ttft=5.0, t=5.0),
        _ev("serve.retire", id=1, finish_reason="length", tokens=4,
            tenant="interactive", t=8.0),
        _ev("serve.submit", id=2, t=1.0),
        _ev("serve.admit", id=2, queue_wait=0.5, t=1.5),
        _ev("serve.first_token", id=2, ttft=2.0, t=3.0),
        _ev("serve.retire", id=2, finish_reason="length", tokens=4,
            tenant="interactive", t=6.0),
    ],
}


def _plain(traces):
    """Traces as plain data (the two packages' dataclasses differ only
    in their module)."""
    return {rid: dataclasses.asdict(tr) for rid, tr in traces.items()}


def _assert_telescoping(tr, exact=True):
    assert tr.segments[0].start == tr.arrival
    assert tr.segments[-1].end == tr.retired
    for a, b in zip(tr.segments, tr.segments[1:]):
        assert a.end == b.start
    total = sum(s.dur for s in tr.segments)
    if exact:
        assert total == tr.total
    else:  # wall clock: float summation, contiguity is still exact
        assert math.isclose(total, tr.total, rel_tol=1e-9)


def _offline_chrome(module, traces):
    class _NoSpans:
        @staticmethod
        def spans():
            return []

    class _Offline:
        clock = None
        spans = _NoSpans()

    return module.fleet_chrome_trace(_Offline(), traces)


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_assembler_and_reports_equal_jax(name):
    events = SYNTHETIC[name]
    want = jax_tracing.assemble_request_traces(events)
    got = tracing.assemble_request_traces(events)
    assert _plain(got) == _plain(want) and got
    slo = {"interactive": 4.0}
    for fn in ("decomposition_rows", "tenant_rollup", "format_decomposition"):
        assert getattr(tracing, fn)(got) == getattr(jax_tracing, fn)(want)
    assert tracing.slo_miss_attribution(got, slo) == \
        jax_tracing.slo_miss_attribution(want, slo)
    assert tracing.format_slo_report(got, slo) == \
        jax_tracing.format_slo_report(want, slo)
    assert _offline_chrome(tracing, got) == _offline_chrome(jax_tracing,
                                                            want)
    for tr in got.values():
        _assert_telescoping(tr)
    if name == "slo":
        ia = tracing.slo_miss_attribution(got, slo)["interactive"]
        assert (ia["count"], ia["misses"]) == (2, 1)
        assert ia["attribution"] == {"queue": 0.4, "prefill": 0.6}
        assert math.isclose(sum(ia["attribution"].values()), 1.0)
    if name == "failover-edge":
        tr = got[7]
        assert tr.resubmits == 1
        assert [s.label for s in tr.segments] == [
            "queue", "prefill", "failover", "decode"]


@pytest.fixture(scope="module")
def env(serve_nano_family):
    dec, params = serve_nano_family[:2]
    target = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, **MK), device="cpu"), params)
    return dec, params, target


def test_async_client_traces_equal_jax_and_load_back(env, tmp_path):
    """An armed async client's traces (the sync split off the decode
    tail) equal JAX's, and the flushed log assembles to the same."""
    dec, params, target = env
    got = {}
    for jax_side in (True, False):
        log = str(tmp_path / f"{jax_side}.jsonl")
        m = jax_obs if jax_side else obs
        tel = m.Telemetry(jsonl_path=log)
        kw = dict(num_slots=2, prefill_len=16, async_dispatch=True,
                  telemetry=tel)
        if jax_side:
            client = jax_serve.ServeClient(dec, params, **kw)
        else:
            client = serve.ServeClient(target, target.state_dict(),
                                       device="cpu", **kw)
        out = client.serve_trace(TRACE)
        client.shutdown()
        tel.flush()
        traces = tel.request_traces()
        mod = jax_tracing if jax_side else tracing
        offline = mod.assemble_request_traces(mod.load_jsonl_events(log))
        assert _plain(offline) == _plain(traces)
        got[jax_side] = (_plain(traces), client._sync_durs, out)
    assert got[False][0] == got[True][0]
    traces = tracing.assemble_request_traces(
        tracing.load_jsonl_events(str(tmp_path / "False.jsonl")))
    assert any(s.label == "sync" for tr in traces.values()
               for s in tr.segments)
    out = got[False][2]
    for rid, tr in traces.items():
        _assert_telescoping(tr)
        assert tr.tokens == len(out[rid].tokens)
        assert tr.total == out[rid].latency
    assert got[False][1] == {}


def _fleet_run(side_jax, env, export):
    dec, params, target = env
    if side_jax:
        tel = jax_obs.Telemetry()
        fleet = jax_serve.ReplicaFleet(dec, params, num_replicas=3,
                                       num_standby=1, num_slots=2,
                                       prefill_len=16, telemetry=tel)
        plan = jax_rel.FaultPlan.at("serve.replica", [7])
    else:
        tel = obs.Telemetry()
        fleet = serve.ReplicaFleet(target, target.state_dict(),
                                   device="cpu", num_replicas=3,
                                   num_standby=1, num_slots=2,
                                   prefill_len=16, telemetry=tel)
        plan = rel.FaultPlan.at("serve.replica", [7])
    # refill on this thread: a background refill lands its gauge whenever
    # its thread gets there
    fleet.standby.refill_async = fleet.standby.fill
    with plan.armed():
        out = fleet.serve_trace(TRACE)
    traces = fleet.request_traces()
    snap = fleet.metrics_snapshot()
    fleet.export_fleet_trace(export)
    fleet.shutdown()
    return out, traces, snap, tel


def test_fleet_failover_traces_and_chrome_export_equal_jax(env, tmp_path):
    """A mid-decode kill under the tick clock: one trace per request,
    the displaced requests carry a failover segment on the same trace,
    every decomposition sums to whole ticks, all equal to the JAX
    fleet's; the exported Chrome trace is byte-identical to JAX's (and
    across two port runs)."""
    paths = [str(tmp_path / f"{n}.json") for n in ("jax", "port", "again")]
    _, want, want_snap, _ = _fleet_run(True, env, paths[0])
    out, got, snap, tel = _fleet_run(False, env, paths[1])
    _fleet_run(False, env, paths[2])
    assert _plain(got) == _plain(want)
    assert snap == want_snap
    b_jax, b_port, b_again = (open(p, "rb").read() for p in paths)
    assert b_port == b_jax and b_again == b_port
    assert sorted(got) == sorted(out)
    for rid, tr in got.items():
        _assert_telescoping(tr)
        assert float(tr.total).is_integer()
        assert tr.finish_reason == out[rid].finish_reason
    displaced = [tr for tr in got.values() if tr.resubmits]
    assert displaced
    for tr in displaced:
        assert "failover" in [s.label for s in tr.segments]
    assert sorted(tel.request_traces()) == sorted(got)
    evs = json.loads(b_port)["traceEvents"]
    assert {e["pid"] for e in evs} >= {0, 1}
    assert any(e["name"].startswith("engine.") for e in evs)
    assert "serve_queue_depth_r0" in snap
    assert not any(k.startswith("replica") for k in snap)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_output(name, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = _load_tool(name).main(argv)
    return rc, buf.getvalue()


def test_report_tools_print_what_the_jax_tools_print(env, tmp_path):
    """``tools/trace_report_torch.py`` over a port log and
    ``tools/journal_report_torch.py`` over a port journal print what the
    JAX tools print over the same files; the trace tool also runs as a
    script in a process that never imports jax."""
    _, _, target = env
    log, wal = str(tmp_path / "serve.jsonl"), str(tmp_path / "serve.wal")
    tel = obs.Telemetry(jsonl_path=log)
    client = serve.ServeClient(target, target.state_dict(), device="cpu",
                               num_slots=2, prefill_len=16, telemetry=tel,
                               journal=serve.Journal(wal, sync_every=1))
    for _, kw in TRACE[:3]:
        client.submit(**kw)
    for _ in range(4):
        client.tick()
    del client  # a dead driver: unretired requests stay in the journal
    tel.flush()
    for args in ([log], [log, "--slo", "default=2.0", "--json"]):
        assert _tool_output("trace_report_torch", args) == \
            _tool_output("trace_report", args)
    for args in ([wal], [wal, "--json"]):
        assert _tool_output("journal_report_torch", args) == \
            _tool_output("journal_report", args)
    chrome = str(tmp_path / "trace.json")
    code = ("import runpy, sys\n"
            "sys.argv = ['trace_report_torch.py'] + sys.argv[1:]\n"
            "runpy.run_path(%r, run_name='__main__')\n" % os.path.join(
                ROOT, "tools", "trace_report_torch.py"))
    guard = ("import builtins\n_real = builtins.__import__\n"
             "def _imp(name, *a, **k):\n"
             "    assert name.split('.')[0] != 'jax', name\n"
             "    return _real(name, *a, **k)\n"
             "builtins.__import__ = _imp\n")
    proc = subprocess.run(
        [sys.executable, "-c", guard + code, log, "--json",
         "--trace-out", chrome], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert len(doc["requests"]) == 3
    assert {e["args"]["label"] for e in json.load(open(chrome))[
        "traceEvents"]} <= set(tracing.SEGMENT_LABELS)


# --------------------------------------------------------------------- #
# the process backend: MSG_SPAN forwarding, kill -9 stitching
# --------------------------------------------------------------------- #
WALL_TRACE = [
    (0.0, dict(prompt=[5, 17, 3, 9], max_new_tokens=6)),
    (0.0, dict(prompt=[9, 2, 44], max_new_tokens=6)),
    (0.2, dict(prompt=[42, 7], max_new_tokens=5)),
]


def _process_fleet(env, tel, **kw):
    return serve.ReplicaFleet(env[2], env[2].state_dict(),
                              backend="process", telemetry=tel,
                              device="cpu", **kw)


@pytest.mark.fleet_process
@pytest.mark.multiproc
def test_process_fleet_spans_forwarded_with_seat_tags(env):
    """An armed process fleet: the workers' engine spans ship over
    MSG_SPAN onto the driver's recorder tagged with their replica seat,
    with the span names of the JAX package's, and the assembled traces
    telescope on the shared fleet timeline."""
    tel = obs.Telemetry()
    fleet = _process_fleet(env, tel, num_replicas=2, num_slots=4,
                           prefill_len=16)
    try:
        out = fleet.serve_trace(WALL_TRACE)
        traces = fleet.request_traces()
    finally:
        fleet.shutdown()
    spans = tel.spans.spans()
    assert spans, "no worker spans arrived over MSG_SPAN"
    assert {s.args.get("seat") for s in spans} >= {0, 1}
    assert any(s.name == "engine.prefill" for s in spans)
    assert all(s.dur >= 0 for s in spans)
    assert sorted(traces) == sorted(out)
    for tr in traces.values():
        _assert_telescoping(tr, exact=False)


@pytest.mark.fleet_process
@pytest.mark.multiproc
@pytest.mark.slow
def test_process_fleet_kill9_traces_stitch_across_death(env):
    """kill -9 a replica mid-decode: every request still assembles ONE
    trace; the victim's requests carry the failover edge on the shared
    fleet timeline, and the victim's last flushed spans survive (they
    rode the death-surviving queue)."""
    import signal
    import time
    tel = obs.Telemetry()
    reqs = [dict(prompt=[5, 17, 3, 9], max_new_tokens=20),
            dict(prompt=[9, 2, 44], max_new_tokens=20),
            dict(prompt=[42, 7], max_new_tokens=18),
            dict(prompt=[1, 33, 2], max_new_tokens=20)]
    fleet = _process_fleet(env, tel, num_replicas=2, num_standby=1,
                           num_slots=2, prefill_len=32,
                           steps_per_dispatch=2)
    try:
        for kw in reqs:
            fleet.submit(**kw)
        victim = fleet._replicas[0]
        deadline = time.time() + 90.0
        while time.time() < deadline:
            fleet.tick()
            if any(t.replica == victim.id and t.tokens
                   for t in fleet._inflight.values()):
                break
            time.sleep(0.01)  # tl-lint: allow-sleep — wall-clock poll against real worker processes
        else:
            raise AssertionError("victim never flushed decode progress")
        os.kill(victim.actor._proc.pid, signal.SIGKILL)
        out = fleet.run_until_idle()
        traces = fleet.request_traces()
    finally:
        fleet.shutdown()
    assert fleet.failovers == 1
    assert sorted(traces) == sorted(out)          # one trace per request
    for rid, tr in traces.items():
        _assert_telescoping(tr, exact=False)
        assert tr.finish_reason == out[rid].finish_reason
        assert tr.tokens == len(out[rid].tokens)
    displaced = [tr for tr in traces.values() if tr.resubmits]
    assert displaced, "kill displaced nobody"
    for tr in displaced:
        assert "failover" in {s.label for s in tr.segments}
        assert {a["edge"] for a in tr.annotations} >= {"resubmit"}
    # replayed re-admissions annotate the trace they re-joined
    assert any(a["edge"] == "replay" for tr in displaced
               for a in tr.annotations)
    # the corpse's spans are on the driver recorder, seat-tagged
    assert {s.args.get("seat") for s in tel.spans.spans()} >= {victim.id}
