"""Write-ahead request journal: driver-death survival for serving (copied from ``ray_lightning_tpu/serve/journal.py``).

The port's own copy, unchanged but for this docstring and the module
paths: the same records, CRCs, batching and reader, so the port's client
writes the same bytes as the JAX package's for the same trace, and either
package's reader folds either package's journal.

A serving driver that dies (OOM, SIGKILL, a host reboot) loses the
request state it held in memory. The journal keeps it on disk:

- **Admissions** -- the full :class:`~ray_lightning_tpu_torch.serve.request.
  Request` (prompt, sampling params, seed, deadline, tenant class,
  adapter binding, any ``replay_tokens`` it re-admitted with).
- **Frontier progress** -- emitted-token deltas per request at each
  synced step (:meth:`ServeEngine.snapshot_in_flight` only ever reports
  tokens the driver has observed: never an un-synced async dispatch).
- **Retirements** -- completion ids with finish reason, so restart is
  exactly-once over the fsync horizon and never re-emits a request
  whose retire record is durable.

The file is append-only JSONL: each line is ``crc32hex SPACE payload``
where the CRC32 is over the canonical JSON payload bytes. Records are
schema-versioned (the ``open`` record carries ``v`` and the writer
generation). Durability is batched: the writer fsyncs every
``sync_every`` appends (and on :meth:`shutdown`), so the crash-loss
window is bounded by ``sync_every`` records -- a retire record lost to
that window replays its request on restart (at-least-once beyond the
fsync horizon, exactly-once within it).

The reader (:func:`read_journal`) folds the log into a
:class:`JournalState`: a torn final record -- the half-written line an
interrupted ``write(2)`` leaves -- is dropped and flagged
(``torn_tail``); a bad CRC *before* the final line is damage, not a
torn tail, and raises :class:`JournalCorrupt`.

Token identity across restart: a request's sampling seeds are
``row_seed(engine seed, request seed, step)`` -- position-indexed and a
pure function of no driver state -- so re-feeding ``prompt + frontier``
resumes the stream at step ``len(frontier)``.

``Journal(path)`` is handed to ``ServeClient(journal=)``; the owning
client closes it in its own ``shutdown()``. ``journal=None`` (the
default) costs one attribute read and a ``None`` check per hook.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.serve.request import Completion, Request

__all__ = ["Journal", "JournalState", "JournalCorrupt", "read_journal",
           "SCHEMA_VERSION"]

#: bump when a record's shape changes incompatibly; readers refuse
#: journals written by a NEWER schema (older ones they can still fold)
SCHEMA_VERSION = 1

REC_OPEN = "open"      # writer (re)opened the journal: {v, gen}
REC_ADMIT = "admit"    # request admitted: {req: <full Request doc>}
REC_FRONT = "front"    # frontier delta: {id, k, d[, ft]}
REC_RETIRE = "retire"  # request retired: {id, reason, n}

#: journal telemetry (the JAX package's names)
COUNTER_JOURNAL_RECORDS = "serve_journal_records_total"
COUNTER_JOURNAL_SYNCS = "serve_journal_syncs_total"
COUNTER_JOURNAL_REPLAYED = "serve_journal_replayed_requests_total"
COUNTER_JOURNAL_STALE = "serve_journal_stale_dropped_total"
EVENT_JOURNAL_RESTORED = "journal.restored"
EVENT_JOURNAL_STALE = "journal.stale_dropped"

_REQ_FIELDS = frozenset(f.name for f in dataclasses.fields(Request))


def _canonical(doc: Dict[str, Any]) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def _crc(payload: str) -> int:
    return zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF


class JournalCorrupt(ValueError):
    """Mid-file damage (bad CRC / bad JSON before the final record) or
    a journal written by a newer schema than this reader understands.
    Distinct from a torn tail, which the reader tolerates silently."""


class Journal:
    """Append-only WAL over one serving session's request state.

    ``sync_every`` bounds the durability window: the writer fsyncs
    after every ``sync_every`` appended records (1 = every record —
    maximum durability, maximum syscall cost). The ``open`` record is
    always synced immediately so the generation fence is durable
    before the first admission.

    ``generation`` counts the writer's restarts: ``restore`` reopens
    the journal with a bumped generation (the process fleet fences a
    dead driver's messages by it).

    Call :meth:`shutdown` (or :meth:`close`) when done; the owning
    ``ServeClient`` does this from its own
    ``shutdown()``. Safe mid-flight: closing never truncates, and the
    reader tolerates whatever tail a crash left behind.
    """

    def __init__(self, path: str, *, sync_every: int = 8,
                 generation: int = 0, telemetry: Any = None):
        if sync_every < 1:
            raise ValueError(
                f"sync_every must be >= 1, got {sync_every}")
        if generation < 0:
            raise ValueError(
                f"generation must be >= 0, got {generation}")
        self.path = str(path)
        self.sync_every = int(sync_every)
        self.generation = int(generation)
        self._tel = telemetry
        self._file: Optional[Any] = open(self.path, "a", encoding="utf-8")
        self._unsynced = 0
        # frontier lengths already journaled per live request id —
        # what turns note_frontier's cumulative streams into deltas
        self._sent: Dict[int, int] = {}
        self._ft_sent: set = set()
        self._retired: set = set()
        self.records = 0
        self.syncs = 0
        self._append({"t": REC_OPEN, "v": SCHEMA_VERSION,
                      "gen": self.generation})
        self.sync()

    @property
    def closed(self) -> bool:
        return self._file is None

    # ---------------------------------------------------------- writing
    def _append(self, doc: Dict[str, Any]) -> None:
        f = self._file
        if f is None:
            raise RuntimeError(f"journal {self.path} is closed")
        payload = _canonical(doc)
        f.write(f"{_crc(payload):08x} {payload}\n")
        self.records += 1
        self._unsynced += 1
        if self._unsynced >= self.sync_every:
            self.sync()
        tel = self._tel
        if tel is not None:
            tel.metrics.counter(
                COUNTER_JOURNAL_RECORDS,
                help="records appended to the serve WAL").inc()

    def sync(self) -> None:
        """Flush + fsync any unsynced appends (no-op when clean)."""
        f = self._file
        if f is None or not self._unsynced:
            return
        f.flush()
        os.fsync(f.fileno())
        self._unsynced = 0
        self.syncs += 1
        tel = self._tel
        if tel is not None:
            tel.metrics.counter(
                COUNTER_JOURNAL_SYNCS,
                help="batched fsyncs of the serve WAL").inc()

    def admit(self, request: Request) -> None:
        """Journal one admission — the full request, so restart can
        rebuild it byte-for-byte (tenant and adapter binding included).
        Re-admitting an id (failover replay, warm restart) re-journals
        it; the reader takes the LAST admit record as authoritative and
        resets the id's frontier to its ``replay_tokens``."""
        doc = dataclasses.asdict(request)
        doc["prompt"] = [int(t) for t in doc["prompt"]]
        self._append({"t": REC_ADMIT, "req": doc})
        self._sent[request.id] = len(request.replay_tokens or ())
        if request.first_token_time is not None:
            self._ft_sent.add(request.id)

    def note_frontier(self, request_id: int, tokens: Sequence[int],
                      first_token_time: Optional[float] = None) -> None:
        """Journal the part of ``tokens`` (the request's CUMULATIVE
        synced stream, replay included) not yet on disk. No delta and
        no fresh first-token stamp → no record, so idle ticks write
        nothing. Unknown or already-retired ids are ignored."""
        sent = self._sent.get(request_id)
        if sent is None:
            return
        delta = [int(t) for t in tokens[sent:]]
        ft: Optional[float] = None
        if first_token_time is not None and request_id not in self._ft_sent:
            ft = float(first_token_time)
        if not delta and ft is None:
            return
        doc: Dict[str, Any] = {"t": REC_FRONT, "id": int(request_id),
                               "k": sent, "d": delta}
        if ft is not None:
            doc["ft"] = ft
            self._ft_sent.add(request_id)
        self._append(doc)
        self._sent[request_id] = sent + len(delta)

    def retire(self, completion: Completion) -> None:
        """Journal one retirement — the exactly-once commit point.
        Duplicate retires of an id are dropped here, so a journal never
        holds two retire records for one admission epoch; the durable
        record is what stops restart from re-emitting the request."""
        rid = int(completion.request_id)
        if rid in self._retired:
            return
        self._retired.add(rid)
        self._sent.pop(rid, None)
        self._ft_sent.discard(rid)
        self._append({"t": REC_RETIRE, "id": rid,
                      "reason": completion.finish_reason,
                      "n": len(completion.tokens)})

    # --------------------------------------------------------- teardown
    def shutdown(self) -> None:
        """Sync and close the file handle. Idempotent."""
        f = self._file
        if f is None:
            return
        self.sync()
        self._file = None
        f.close()

    #: file-handle idiom alias (the teardown lint accepts either)
    close = shutdown


@dataclasses.dataclass
class JournalState:
    """A journal folded into its end state by :func:`read_journal`.

    ``admitted`` maps id → the last-journaled :class:`Request` (with
    ``first_token_time`` re-applied from frontier records);
    ``frontier`` maps id → the full synced token stream (replay
    tokens included); ``retired`` maps id → finish reason.
    ``duplicate_retires`` counts retire records for already-retired
    ids (always 0 for a journal written by :class:`Journal`; the
    report tool surfaces it as a damage diagnosis).
    """
    path: str
    generation: int = 0
    schema_version: int = SCHEMA_VERSION
    admitted: Dict[int, Request] = dataclasses.field(default_factory=dict)
    frontier: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    retired: Dict[int, str] = dataclasses.field(default_factory=dict)
    records: int = 0
    torn_tail: bool = False
    duplicate_retires: int = 0

    def pending(self) -> List[Tuple[Request, List[int]]]:
        """Unretired admissions with their journaled frontiers, in id
        order — exactly what warm restart re-admits."""
        return [(self.admitted[rid], list(self.frontier.get(rid, [])))
                for rid in sorted(self.admitted)
                if rid not in self.retired]

    @property
    def next_request_id(self) -> int:
        return max(self.admitted, default=-1) + 1


def _parse_line(line: str) -> Dict[str, Any]:
    if len(line) < 10 or line[8] != " ":
        raise ValueError(f"malformed record header: {line[:16]!r}")
    want = int(line[:8], 16)
    payload = line[9:]
    if _crc(payload) != want:
        raise ValueError("CRC mismatch")
    doc = json.loads(payload)
    if not isinstance(doc, dict) or "t" not in doc:
        raise ValueError("record is not a typed object")
    return doc


def read_journal(path: str) -> JournalState:
    """Fold a journal file into its :class:`JournalState`.

    Tolerates exactly one torn record, at the tail (dropped,
    ``torn_tail=True``): that is what an interrupted append looks
    like. Any earlier unparseable record, a frontier delta that does
    not extend its request's journaled stream contiguously, or a
    newer-schema ``open`` record raises :class:`JournalCorrupt`.
    """
    state = JournalState(path=str(path))
    with open(path, "r", encoding="utf-8") as f:
        raw = f.read()
    lines = raw.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    for i, line in enumerate(lines):
        try:
            doc = _parse_line(line)
        except ValueError:
            if i == len(lines) - 1:
                state.torn_tail = True
                break
            raise JournalCorrupt(
                f"{path}: unreadable record at line {i + 1} of "
                f"{len(lines)} — damage before the tail, not a torn "
                f"final record")
        kind = doc.get("t")
        if kind == REC_OPEN:
            v = int(doc.get("v", 0))
            if v > SCHEMA_VERSION:
                raise JournalCorrupt(
                    f"{path}: schema v{v} is newer than this reader "
                    f"(v{SCHEMA_VERSION})")
            state.schema_version = v
            state.generation = max(state.generation,
                                   int(doc.get("gen", 0)))
        elif kind == REC_ADMIT:
            rdoc = doc.get("req") or {}
            req = Request(**{k: v for k, v in rdoc.items()
                             if k in _REQ_FIELDS})
            state.admitted[req.id] = req
            state.frontier[req.id] = list(req.replay_tokens or ())
        elif kind == REC_FRONT:
            rid = int(doc["id"])
            cur = state.frontier.get(rid)
            if cur is None or rid in state.retired:
                state.records += 1
                continue
            if int(doc.get("k", -1)) != len(cur):
                raise JournalCorrupt(
                    f"{path}: frontier gap for request {rid} at line "
                    f"{i + 1}: record continues from {doc.get('k')}, "
                    f"journaled stream holds {len(cur)}")
            cur.extend(int(t) for t in doc.get("d", ()))
            if "ft" in doc:
                req = state.admitted.get(rid)
                if req is not None and req.first_token_time is None:
                    req.first_token_time = float(doc["ft"])
        elif kind == REC_RETIRE:
            rid = int(doc["id"])
            if rid in state.retired:
                state.duplicate_retires += 1
            else:
                state.retired[rid] = str(doc.get("reason", ""))
        # unknown record kinds from an older writer are skipped
        state.records += 1
    return state
