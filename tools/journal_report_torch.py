"""Offline report over a serve write-ahead journal (WAL) file (the port's: ``ray_lightning_tpu_torch``, never jax).

The same report as ``tools/journal_report.py``, run on the port's own copy
of the module, so it needs no JAX installation: a file written by either
package reads the same.

Folds a journal written by ``ray_lightning_tpu_torch.serve.Journal`` with the
same reader a warm restart uses (``read_journal``) and prints what a
restart would see: admitted / retired / unretired counts, the finish-
reason breakdown, and — per unretired request — the journaled token
frontier a restore would replay from. Damage is diagnosed honestly:
a torn final record (the interrupted append a driver kill leaves) is
reported and tolerated; mid-file damage or a newer-schema journal is
reported as corrupt with the reader's verdict, and the tool exits
nonzero.

Usage:
    python tools/journal_report_torch.py /path/to/serve.wal
    python tools/journal_report_torch.py /path/to/serve.wal --json
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

from ray_lightning_tpu_torch.serve.journal import (JournalCorrupt,  # noqa: E402
                                             read_journal)


def _pending_rows(state):
    rows = []
    for req, toks in state.pending():
        rows.append({
            "id": req.id,
            "prompt_len": len(req.prompt),
            "frontier": len(toks),
            "max_new_tokens": req.max_new_tokens,
            "greedy": not req.temperature,
            "tenant": req.tenant,
            "adapter": req.adapter,
            "first_token_seen": req.first_token_time is not None,
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="admitted/retired/unretired story of a serve "
                    "write-ahead journal, with torn-tail diagnosis")
    ap.add_argument("journal", help="WAL file written by "
                                    "ServeClient(journal=Journal(...)) "
                                    "or ReplicaFleet(journal=...)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output: one JSON document "
                         "instead of tables")
    args = ap.parse_args(argv)

    try:
        state = read_journal(args.journal)
    except FileNotFoundError:
        print(f"no journal at {args.journal}", file=sys.stderr)
        return 1
    except JournalCorrupt as exc:
        if args.json:
            print(json.dumps({"corrupt": True, "detail": str(exc)}))
        else:
            print(f"CORRUPT: {exc}", file=sys.stderr)
            print("(a torn FINAL record is tolerated; this journal is "
                  "damaged earlier than the tail, so a warm restart "
                  "would refuse it too)", file=sys.stderr)
        return 1

    pending = _pending_rows(state)
    reasons = collections.Counter(state.retired.values())
    doc = {
        "path": state.path,
        "generation": state.generation,
        "schema_version": state.schema_version,
        "records": state.records,
        "torn_tail": state.torn_tail,
        "duplicate_retires": state.duplicate_retires,
        "admitted": len(state.admitted),
        "retired": len(state.retired),
        "unretired": len(pending),
        "finish_reasons": dict(sorted(reasons.items())),
        "next_request_id": state.next_request_id,
        "pending": pending,
    }
    if args.json:
        print(json.dumps(doc, sort_keys=True))
        return 0

    print(f"journal {state.path}: generation {state.generation}, "
          f"schema v{state.schema_version}, {state.records} records")
    print(f"  admitted {len(state.admitted)}, retired "
          f"{len(state.retired)}"
          + (" ({})".format(", ".join(f"{n} {r}" for r, n
                                      in sorted(reasons.items())))
             if reasons else "")
          + f", unretired {len(pending)}")
    print(f"  next_request_id {state.next_request_id}")
    if state.torn_tail:
        print("  torn tail: the final record is half-written — the "
              "append a driver kill interrupted. Dropped by the "
              "reader; everything above it is intact.")
    if state.duplicate_retires:
        print(f"  WARNING: {state.duplicate_retires} duplicate retire "
              "record(s) — the writer dedupes these, so this journal "
              "was not written by a single healthy Journal instance")
    if pending:
        print("\nunretired requests (what a warm restart replays):")
        print("  id  prompt  frontier  budget  sampling  tenant"
              "          adapter         first_token")
        for row in pending:
            print(f"  {row['id']:>2d}  {row['prompt_len']:>6d}  "
                  f"{row['frontier']:>8d}  {row['max_new_tokens']:>6d}"
                  f"  {'greedy' if row['greedy'] else 'sampled':>8s}"
                  f"  {row['tenant'] or '-':<14s}"
                  f"  {row['adapter'] or '-':<14s}"
                  f"  {'seen' if row['first_token_seen'] else '-'}")
    else:
        print("\nno unretired requests: a warm restart replays "
              "nothing (clean shutdown or fully drained run)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
