"""Offline request-trace report over a flushed JSONL event log (the port's: ``ray_lightning_tpu_torch``, never jax).

The same report as ``tools/trace_report.py``, run on the port's own copy
of the module, so it needs no JAX installation: a file written by either
package reads the same.

Runs the same assembly as ``Telemetry.request_traces()``
(``obs/tracing.py``) against a log file on disk — no live process
needed. Prints the per-request latency decomposition table (queue /
prefill / decode / sync / failover columns summing exactly to
end-to-end latency), the per-tenant-class rollup, and — given
``--slo`` targets — the SLO-miss attribution report ("interactive p99
TTFT miss = 78% class-queue wait"). Optionally exports the stitched
Chrome trace (request segments only: spans live in the recorder, not
the event log).

Usage:
    python tools/trace_report_torch.py logs/serve.jsonl
    python tools/trace_report_torch.py logs/serve.jsonl --slo interactive=4.0 \\
        --slo batch=50 --trace-out trace.json --json
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

from ray_lightning_tpu_torch.obs import tracing  # noqa: E402


def _parse_slo(pairs):
    slo = {}
    for pair in pairs or []:
        try:
            tenant, _, value = pair.partition("=")
            slo[tenant] = float(value)
        except ValueError:
            raise SystemExit(
                f"--slo expects class=target (e.g. interactive=4.0), "
                f"got {pair!r}")
    return slo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-request latency decomposition + SLO-miss "
                    "attribution over a flushed obs JSONL log")
    ap.add_argument("jsonl", help="event log written by "
                                  "Telemetry(jsonl_path=...) + flush()")
    ap.add_argument("--slo", action="append", metavar="CLASS=TARGET",
                    help="TTFT SLO target per tenant class (client "
                         "clock units); repeatable")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="also export the stitched Chrome trace "
                         "(request segments; load in Perfetto)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output: one JSON document "
                         "instead of tables")
    args = ap.parse_args(argv)

    events = tracing.load_jsonl_events(args.jsonl)
    traces = tracing.assemble_request_traces(events)
    slo = _parse_slo(args.slo)

    if args.trace_out:
        # offline stitching has no SpanRecorder: a stand-in telemetry
        # with no spans and the tick clock keeps the export pure-event
        class _NoSpans:
            @staticmethod
            def spans():
                return []

        class _Offline:
            clock = None
            spans = _NoSpans()

        tracing.export_fleet_chrome_trace(args.trace_out, _Offline(),
                                          traces)

    if args.json:
        doc = {
            "requests": tracing.decomposition_rows(traces),
            "tenants": tracing.tenant_rollup(traces),
        }
        if slo:
            doc["slo"] = tracing.slo_miss_attribution(traces, slo)
        print(json.dumps(doc, sort_keys=True, default=str))
        return 0

    if not traces:
        print(f"no request traces in {args.jsonl} "
              f"({len(events)} events)")
        return 0
    print(tracing.format_decomposition(traces))
    if slo:
        print()
        print("SLO-miss attribution (pre-first-token time of missed "
              "requests):")
        print(tracing.format_slo_report(traces, slo))
    if args.trace_out:
        print(f"\nChrome trace written to {args.trace_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
