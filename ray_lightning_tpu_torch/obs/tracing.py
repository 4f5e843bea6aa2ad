"""Per-request trace assembly + fleet-stitched Chrome export (copied from ``ray_lightning_tpu/obs/tracing.py``).

The port's own copy, unchanged but for this paragraph and the module
paths: it reads events and span documents only, so the same event log
assembles to the same traces in either package. The process backend's
worker spans (``MSG_SPAN``, ``launchers/serve_worker.py``) reach the
recorder seat-tagged, as in the JAX package.

The obs primitives are three parallel streams — events (order), metrics
(aggregates), spans (durations) — with no per-request spine. This module
builds that spine: :func:`assemble_request_traces` folds the event
stream into one :class:`RequestTrace` per request id (the trace id),
with the request's lifetime cut into contiguous, non-overlapping
**segments**::

    queue    submit/arrival -> first admission (class-queue wait)
    prefill  admission -> first token (batched or chunked prefill)
    decode   first token -> retirement (minus the sync split below)
    sync     the enqueue->sync reconciliation window of the async
             dispatch that retired the request (serve.retire `sync`)
    failover any re-admission gap: previous stamp -> the re-admit on a
             surviving replica (replay + re-queue time after a death)

Segments telescope: every segment starts where the previous one ended,
so their durations **sum exactly** to end-to-end latency (``retired -
arrival``) — under the tick clock these are exact integers, which the
tests pin. Failover re-admissions and probation re-seats attach to the
EXISTING trace as annotated edges (``RequestTrace.annotations``,
``resubmits``); they never open a new trace — the fleet keeps request
ids stable across deaths, so the id IS the trace id.

:func:`fleet_chrome_trace` stitches the assembled traces together with
the span recorder (including worker-side spans the process backend
ships over ``MSG_SPAN``) into one multi-track Chrome trace-event
document: ``pid`` = replica seat, ``tid`` = KV slot. Deterministic under
the tick clock — byte-identical across identical runs, same contract as
the JSONL event log.

Everything here is offline/read-only: assembly walks a list of
:class:`~ray_lightning_tpu_torch.obs.events.Event` objects *or* plain dicts
from a flushed JSONL log (``tools/trace_report_torch.py`` runs the same code
over a file on disk).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: canonical decomposition columns, in report order
SEGMENT_LABELS = ("queue", "prefill", "decode", "sync", "failover")


@dataclasses.dataclass(frozen=True)
class TraceSegment:
    """One contiguous slice of a request's lifetime (client clock
    units). ``replica``/``slot`` locate it on the fleet (the Chrome
    track), when the event stream identified them."""
    label: str
    start: float
    end: float
    replica: Optional[int] = None
    slot: Optional[int] = None

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class RequestTrace:
    """One request's assembled span tree: identity, outcome, and the
    telescoping latency segments. ``resubmits`` counts failover
    re-admissions (annotated edges on THIS trace, never new traces)."""
    id: int
    tenant: Optional[str] = None
    arrival: Optional[float] = None
    retired: Optional[float] = None
    ttft: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_reason: Optional[str] = None
    tokens: int = 0
    prompt_len: Optional[int] = None
    segments: List[TraceSegment] = dataclasses.field(default_factory=list)
    replicas: List[int] = dataclasses.field(default_factory=list)
    slots: List[int] = dataclasses.field(default_factory=list)
    resubmits: int = 0
    rejected: bool = False
    annotations: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    # assembly state (public but rarely interesting): admissions seen,
    # first token seen
    admits: int = 0
    seen_first_token: bool = False

    @property
    def total(self) -> Optional[float]:
        """End-to-end latency (arrival -> retirement), the exact sum of
        all segment durations."""
        if self.arrival is None or self.retired is None:
            return None
        return self.retired - self.arrival

    def breakdown(self) -> Dict[str, float]:
        """Per-label duration sums over :data:`SEGMENT_LABELS`."""
        out: Dict[str, float] = {k: 0.0 for k in SEGMENT_LABELS}
        for seg in self.segments:
            out[seg.label] = out.get(seg.label, 0.0) + seg.dur
        return out


def _site_payload(e: Any) -> Tuple[Optional[str], Dict[str, Any]]:
    # accept Event objects (the in-memory ring) and plain dicts (a
    # flushed JSONL log read back by tools/trace_report_torch.py)
    if isinstance(e, dict):
        return e.get("site"), e.get("payload") or {}
    return e.site, e.payload


def assemble_request_traces(events: Iterable[Any]) \
        -> Dict[int, "RequestTrace"]:
    """Fold an ordered event stream (ring contents or JSONL dicts) into
    one :class:`RequestTrace` per request id. Tolerant of ring
    truncation: a request whose ``serve.submit`` was evicted is skipped
    rather than half-assembled (``obs.events_dropped`` marks the log)."""
    traces: Dict[int, RequestTrace] = {}
    last: Dict[int, float] = {}             # last stamp per request
    pending_routes: Dict[int, List[int]] = {}  # route before submit

    def push(tr: RequestTrace, label: str, start: float,
             end: float) -> None:
        if end <= start:
            return  # zero-width: adds nothing, keeps telescoping exact
        tr.segments.append(TraceSegment(
            label=label, start=start, end=end,
            replica=tr.replicas[-1] if tr.replicas else None,
            slot=tr.slots[-1] if tr.slots else None))

    for e in events:
        site, p = _site_payload(e)
        if site == "fleet.route":
            rid = p.get("id")
            tr = traces.get(rid)
            if tr is None:
                pending_routes.setdefault(rid, []).append(p.get("replica"))
            else:
                tr.replicas.append(p.get("replica"))
            continue
        if site == "engine.prefill":
            # batch event: ids/slots lists — records each request's KV
            # slot for this admission life (the Chrome tid track)
            for rid, slot in zip(p.get("ids") or [], p.get("slots") or []):
                tr = traces.get(rid)
                if tr is not None:
                    tr.slots.append(slot)
            continue
        rid = p.get("id")
        if rid is None:
            continue
        if site == "serve.submit":
            tr = traces.get(rid)
            if tr is None:
                tr = RequestTrace(id=rid, arrival=p.get("t"),
                                  prompt_len=p.get("prompt_len"))
                tr.replicas.extend(
                    r for r in pending_routes.pop(rid, [])
                    if r is not None)
                traces[rid] = tr
                if tr.arrival is not None:
                    last[rid] = tr.arrival
            else:
                # failover re-admission re-runs submit_request on the
                # survivor: an annotated edge on the SAME trace
                tr.resubmits += 1
                tr.annotations.append({"edge": "resubmit",
                                       "t": p.get("t")})
            continue
        tr = traces.get(rid)
        if tr is None:
            continue  # submit evicted from the ring: skip, don't guess
        if site == "engine.tenant_admitted":
            if tr.tenant is None:
                tr.tenant = p.get("tenant")
        elif site == "serve.admit":
            t = p.get("t")
            if t is None:
                tr.admits += 1
                continue
            if tr.admits == 0 and tr.resubmits == 0:
                qw = p.get("queue_wait")
                if qw is not None:
                    # exact arrival: the client measured queue_wait from
                    # its own arrival stamp — the submit event's t can
                    # lag it by RPC transit under the process backend
                    tr.arrival = t - qw
                push(tr, "queue",
                     tr.arrival if tr.arrival is not None else t, t)
            elif tr.admits == 0:
                # the original admission died unflushed with its
                # replica (kill -9 between dispatch turns): the whole
                # lost window is the failover edge, arrival stays the
                # original submit stamp
                push(tr, "failover", last.get(rid, t), t)
            else:
                push(tr, "failover", last.get(rid, t), t)
            tr.admits += 1
            last[rid] = t
        elif site == "serve.first_token":
            tr.ttft = p.get("ttft")
            t = p.get("t")
            if t is not None:
                push(tr, "prefill", last.get(rid, t), t)
                tr.first_token_t = t
                last[rid] = t
            tr.seen_first_token = True
        elif site == "recovery.replay":
            tr.annotations.append(
                {"edge": "replay",
                 "replayed_tokens": p.get("replayed_tokens")})
        elif site == "fleet.probation":
            tr.annotations.append({"edge": "probation",
                                   "phase": p.get("phase"),
                                   "replica": p.get("replica")})
        elif site == "fleet.probation_cleared":
            tr.annotations.append({"edge": "probation_cleared",
                                   "replica": p.get("replica")})
        elif site == "fleet.readmit_parked":
            tr.annotations.append({"edge": "parked"})
        elif site in ("serve.reject", "fleet.shed"):
            tr.rejected = True
            if tr.finish_reason is None:
                tr.finish_reason = "rejected"
        elif site == "serve.retire":
            tr.finish_reason = p.get("finish_reason")
            tr.tokens = p.get("tokens", 0)
            if p.get("tenant") is not None:
                tr.tenant = p["tenant"]
            t = p.get("t")
            if t is None:
                continue
            tr.retired = t
            prev = last.get(
                rid, tr.arrival if tr.arrival is not None else t)
            tail = ("decode" if tr.seen_first_token
                    else ("prefill" if tr.admits else "queue"))
            sync = p.get("sync") or 0.0
            if 0 < sync < (t - prev):
                push(tr, tail, prev, t - sync)
                push(tr, "sync", t - sync, t)
            elif sync > 0 and (t - prev) > 0:
                push(tr, "sync", prev, t)  # whole tail was the sync
            else:
                push(tr, tail, prev, t)
            last[rid] = t
    return traces


# --------------------------------------------------------------- export
def fleet_chrome_trace(telemetry: Any,
                       traces: Optional[Dict[int, RequestTrace]] = None) \
        -> Dict[str, Any]:
    """Multi-track Chrome trace-event document for a whole fleet run:
    engine/worker spans land on ``pid`` = replica seat (the ``seat``
    span arg — stamped by the fleet in-process, or by the driver when a
    worker ships the span over ``MSG_SPAN``) and ``tid`` = KV slot;
    each request's latency segments are added as ``ph="X"`` events on
    the replica/slot that served them. Deterministic under the tick
    clock (stable sort, no wall time)."""
    if traces is None:
        traces = assemble_request_traces(telemetry.bus.events())
    # segments are client clock units (ticks or SECONDS); Chrome wants
    # µs in wall mode. Spans already come in µs (wall) or ticks (tick).
    scale = 1.0 if telemetry.clock is None else 1e6
    events: List[Dict[str, Any]] = []
    for s in telemetry.spans.spans():
        events.append({"name": s.name, "ph": "X", "ts": s.ts,
                       "dur": s.dur,
                       "pid": int(s.args.get("seat", 0) or 0),
                       "tid": int(s.args.get("slot", 0) or 0),
                       "args": s.args})
    for tr in traces.values():
        for seg in tr.segments:
            events.append({
                "name": f"req{tr.id}/{seg.label}", "ph": "X",
                "ts": seg.start * scale, "dur": seg.dur * scale,
                "pid": int(seg.replica or 0),
                "tid": int(seg.slot or 0),
                "args": {"id": tr.id, "label": seg.label,
                         "tenant": tr.tenant,
                         "failovers": tr.resubmits}})
    events.sort(key=lambda ev: (ev["ts"], -ev["dur"], ev["pid"],
                                ev["tid"], ev["name"]))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_fleet_chrome_trace(path: str, telemetry: Any,
                              traces: Optional[Dict[int, RequestTrace]]
                              = None) -> str:
    """Atomically publish :func:`fleet_chrome_trace` (tmp +
    ``os.replace``, key-sorted JSON — stable bytes under the tick
    clock); returns ``path``."""
    doc = fleet_chrome_trace(telemetry, traces)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


# -------------------------------------------------------------- reports
def _percentile(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    vs = sorted(vals)
    k = max(0, min(len(vs) - 1, int(math.ceil(q * len(vs))) - 1))
    return vs[k]


def decomposition_rows(traces: Dict[int, RequestTrace]) \
        -> List[Dict[str, Any]]:
    """Per-request latency decomposition, one plain dict per request
    (id order): identity, outcome, total, ttft, and one column per
    :data:`SEGMENT_LABELS` entry."""
    rows = []
    for tr in sorted(traces.values(), key=lambda t: t.id):
        row: Dict[str, Any] = {
            "id": tr.id, "tenant": tr.tenant,
            "finish": tr.finish_reason, "tokens": tr.tokens,
            "total": tr.total, "ttft": tr.ttft,
            "failovers": tr.resubmits}
        row.update(tr.breakdown())
        rows.append(row)
    return rows


def tenant_rollup(traces: Dict[int, RequestTrace]) \
        -> Dict[str, Dict[str, Any]]:
    """Per-tenant-class rollup: request count, TTFT/latency p50/p99,
    and the summed per-segment breakdown."""
    by_tenant: Dict[str, List[RequestTrace]] = {}
    for tr in traces.values():
        by_tenant.setdefault(tr.tenant or "-", []).append(tr)
    out: Dict[str, Dict[str, Any]] = {}
    for tenant, trs in sorted(by_tenant.items()):
        ttfts = [t.ttft for t in trs if t.ttft is not None]
        totals = [t.total for t in trs if t.total is not None]
        agg = {k: 0.0 for k in SEGMENT_LABELS}
        for t in trs:
            for k, v in t.breakdown().items():
                agg[k] += v
        out[tenant] = {
            "count": len(trs),
            "failovers": sum(t.resubmits for t in trs),
            "ttft_p50": _percentile(ttfts, 0.50),
            "ttft_p99": _percentile(ttfts, 0.99),
            "total_p50": _percentile(totals, 0.50),
            "total_p99": _percentile(totals, 0.99),
            "breakdown": agg}
    return out


def slo_miss_attribution(traces: Dict[int, RequestTrace],
                         slo: Dict[str, float]) \
        -> Dict[str, Dict[str, Any]]:
    """Where did the time go for the requests that MISSED their TTFT
    SLO? For each tenant class in ``slo``, take the requests whose TTFT
    exceeded the target and attribute their pre-first-token time (the
    segments ending at or before the first-token stamp) to
    queue/prefill/failover fractions — the "interactive p99 TTFT miss =
    78% class-queue wait" report."""
    out: Dict[str, Dict[str, Any]] = {}
    for tenant, limit in sorted(slo.items()):
        trs = [t for t in traces.values() if (t.tenant or "-") == tenant]
        missed = [t for t in trs
                  if t.ttft is not None and t.ttft > limit]
        sums: Dict[str, float] = {}
        denom = 0.0
        for tr in missed:
            cut = tr.first_token_t
            for seg in tr.segments:
                if cut is not None and seg.end > cut:
                    continue
                sums[seg.label] = sums.get(seg.label, 0.0) + seg.dur
                denom += seg.dur
        out[tenant] = {
            "slo": limit, "count": len(trs), "misses": len(missed),
            "attribution": ({k: v / denom for k, v in sorted(sums.items())}
                            if denom > 0 else {})}
    return out


def format_decomposition(traces: Dict[int, RequestTrace]) -> str:
    """Human-readable per-request table + per-tenant rollup (client
    clock units — ticks under the tick clock)."""
    def num(v: Any) -> str:
        if v is None:
            return "-"
        return f"{v:.6g}" if isinstance(v, float) else str(v)

    cols = ["id", "tenant", "finish", "tokens", "total", "ttft",
            *SEGMENT_LABELS, "failovers"]
    rows = [[num(r.get(c)) for c in cols]
            for r in decomposition_rows(traces)]
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.rjust(w) for c, w in zip(cols, widths))]
    for r in rows:
        lines.append("  ".join(v.rjust(w) for v, w in zip(r, widths)))
    lines.append("")
    lines.append("per-tenant rollup:")
    for tenant, agg in tenant_rollup(traces).items():
        bd = ", ".join(f"{k}={num(v)}"
                       for k, v in agg["breakdown"].items() if v)
        lines.append(
            f"  {tenant}: n={agg['count']} "
            f"ttft p50={num(agg['ttft_p50'])} p99={num(agg['ttft_p99'])} "
            f"total p99={num(agg['total_p99'])} "
            f"failovers={agg['failovers']}  [{bd}]")
    return "\n".join(lines)


def format_slo_report(traces: Dict[int, RequestTrace],
                      slo: Dict[str, float]) -> str:
    """One line per tenant class: miss count and the dominant
    pre-first-token attribution."""
    lines = []
    for tenant, rep in slo_miss_attribution(traces, slo).items():
        if not rep["misses"]:
            lines.append(f"  {tenant}: 0/{rep['count']} TTFT misses "
                         f"(slo={rep['slo']:g})")
            continue
        attr = ", ".join(f"{100 * v:.0f}% {k}"
                         for k, v in sorted(rep["attribution"].items(),
                                            key=lambda kv: -kv[1]))
        lines.append(f"  {tenant}: {rep['misses']}/{rep['count']} TTFT "
                     f"misses (slo={rep['slo']:g}) = {attr}")
    return "\n".join(lines)


def load_jsonl_events(path: str) -> List[Dict[str, Any]]:
    """Read a flushed JSONL event log back as plain dicts (the offline
    input to :func:`assemble_request_traces`)."""
    events: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


__all__ = [
    "SEGMENT_LABELS", "TraceSegment", "RequestTrace",
    "assemble_request_traces", "fleet_chrome_trace",
    "export_fleet_chrome_trace", "decomposition_rows", "tenant_rollup",
    "slo_miss_attribution", "format_decomposition", "format_slo_report",
    "load_jsonl_events",
]
