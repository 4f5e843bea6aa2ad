"""The port's write-ahead request journal (``serve/journal.py``, ``ServeClient(journal=)``, ``ServeClient.restore``) against the JAX package.

- The JAX suite's WAL unit tests (``tests/test_journal.py``) run against
  the port's module: round trip, exactly-once retires, a torn tail, damage
  before the tail, frontier gaps, newer schemas, batched fsyncs; and the
  two modules write the same bytes for the same calls.
- On a nano trace (the ``serve_nano_family`` shapes, f32, greedy rows
  with tenant classes) the port client's journal is byte-equal to the
  JAX client's, and a journal the JAX client wrote folds to the same
  :class:`JournalState` under the port's ``read_journal`` as under the
  JAX one.
- A driver killed mid-trace by the ``serve.driver`` fault site and
  restored from its journal finishes every unretired request with the
  uninterrupted run's tokens (greedy and sampled, inside the port;
  greedy also equal to the JAX client's), adapter bindings and tenant
  classes kept, and never re-emits a request whose retire record is on
  disk.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import lora as jax_lora
from ray_lightning_tpu.serve import Journal as JaxJournal
from ray_lightning_tpu.serve import ServeClient as JaxServeClient
from ray_lightning_tpu.serve import TenantClass as JaxTenantClass
from ray_lightning_tpu.serve import read_journal as jax_read_journal
from ray_lightning_tpu.serve.request import Completion as JaxCompletion
from ray_lightning_tpu.serve.request import Request as JaxRequest
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.obs import Telemetry
from ray_lightning_tpu_torch.reliability import FaultPlan, InjectedFault
from ray_lightning_tpu_torch.serve import (Journal, JournalCorrupt,
                                           ServeClient, TenantClass,
                                           read_journal)
from ray_lightning_tpu_torch.serve.journal import _canonical, _crc
from ray_lightning_tpu_torch.serve.request import Completion, Request

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

MK = dict(vocab_size=128, max_seq_len=32)
#: the short row rides first so its retire record is on disk before the
#: kill (the never-re-emit check needs one)
WORK = [
    dict(prompt=[1, 2], max_new_tokens=2, seed=103, tenant="bulk"),
    dict(prompt=[5, 17, 3, 9], max_new_tokens=6, seed=100, tenant="fast"),
    dict(prompt=[9, 2, 44], max_new_tokens=6, seed=101, tenant="bulk"),
    dict(prompt=[42, 7], max_new_tokens=6, seed=102, tenant="fast"),
]
SAMPLED = {2: dict(temperature=0.9, top_k=8), 3: dict(temperature=0.7)}


def _classes(cls):
    return [cls("fast", weight=4.0, tier="interactive"),
            cls("bulk", weight=1.0, tier="batch")]


def _req(mod, rid, prompt, **kw):
    kw.setdefault("max_new_tokens", 8)
    return mod(id=rid, prompt=list(prompt), **kw)


# ---------------------------------------------------------------- WAL unit
def _roundtrip(path, journal_cls, req_cls, comp_cls):
    j = journal_cls(path, sync_every=1, generation=3)
    j.admit(_req(req_cls, 0, [5, 17, 3], temperature=0.9, top_k=8, seed=11,
                 tenant="fast", adapter="a"))
    j.admit(_req(req_cls, 1, [9, 2], replay_tokens=[7, 7]))
    j.note_frontier(0, [40, 41], first_token_time=0.25)
    j.note_frontier(0, [40, 41, 42])           # cumulative -> delta [42]
    j.note_frontier(0, [40, 41, 42])           # no delta -> no record
    j.note_frontier(1, [7, 7, 90])             # extends past the replay
    j.note_frontier(99, [1, 2, 3])             # unknown id -> ignored
    j.retire(comp_cls(request_id=0, prompt=[1], tokens=[40, 41, 42],
                      finish_reason="eos"))
    records = j.records
    j.shutdown()
    return records


def test_wal_roundtrip_and_bytes_equal_jax(tmp_path):
    records = _roundtrip(tmp_path / "port.jsonl", Journal, Request,
                         Completion)
    _roundtrip(tmp_path / "jax.jsonl", JaxJournal, JaxRequest,
               JaxCompletion)
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax.jsonl").read_bytes()
    st = read_journal(tmp_path / "port.jsonl")
    assert st.generation == 3 and not st.torn_tail
    assert st.records == records and st.duplicate_retires == 0
    assert sorted(st.admitted) == [0, 1]
    r0 = st.admitted[0]
    assert (r0.tenant, r0.adapter, r0.temperature, r0.seed,
            r0.first_token_time) == ("fast", "a", 0.9, 11, 0.25)
    assert st.frontier == {0: [40, 41, 42], 1: [7, 7, 90]}
    assert st.retired == {0: "eos"}
    assert [(r.id, t) for r, t in st.pending()] == [(1, [7, 7, 90])]
    assert st.next_request_id == 2
    assert Journal.close is Journal.shutdown


def test_wal_retire_exactly_once(tmp_path):
    path = tmp_path / "wal.jsonl"
    j = Journal(path, sync_every=1)
    j.admit(_req(Request, 0, [1, 2]))
    before = j.records
    for reason in ("length", "length", "timeout"):
        j.retire(Completion(request_id=0, prompt=[1], tokens=[9],
                            finish_reason=reason))
    assert j.records == before + 1
    j.note_frontier(0, [9, 10])                # retired: ignored
    assert j.records == before + 1
    j.shutdown()
    st = read_journal(path)
    assert st.retired == {0: "length"} and st.duplicate_retires == 0
    assert st.pending() == []


def test_wal_torn_tail_and_damage(tmp_path):
    """A half-written final record is dropped and flagged; a bad CRC
    before the final record is damage and refused."""
    path = tmp_path / "wal.jsonl"
    j = Journal(path, sync_every=1)
    j.admit(_req(Request, 0, [1, 2]))
    j.admit(_req(Request, 1, [3]))
    j.shutdown()
    raw = path.read_bytes()
    torn = tmp_path / "torn.jsonl"
    torn.write_bytes(raw[:-9])
    st = read_journal(torn)
    assert st.torn_tail and sorted(st.admitted) == [0]
    lines = raw.decode().splitlines(keepends=True)
    lines[1] = lines[1].replace('"prompt":[1,2]', '"prompt":[1,9]')
    path.write_text("".join(lines))
    with pytest.raises(JournalCorrupt, match="unreadable record"):
        read_journal(path)


def _raw_line(doc):
    payload = _canonical(doc)
    return f"{_crc(payload):08x} {payload}\n"


def test_wal_frontier_gap_and_newer_schema_refused(tmp_path):
    gap = tmp_path / "gap.jsonl"
    gap.write_text(
        _raw_line({"t": "open", "v": 1, "gen": 0})
        + _raw_line({"t": "admit",
                     "req": {"id": 0, "prompt": [1], "max_new_tokens": 4}})
        + _raw_line({"t": "front", "id": 0, "k": 5, "d": [7]})
        + _raw_line({"t": "retire", "id": 0, "reason": "eos", "n": 1}))
    with pytest.raises(JournalCorrupt, match="frontier gap"):
        read_journal(gap)
    newer = tmp_path / "newer.jsonl"
    newer.write_text(_raw_line({"t": "open", "v": 99, "gen": 0}))
    with pytest.raises(JournalCorrupt, match="newer"):
        read_journal(newer)
    fwd = tmp_path / "fwd.jsonl"
    fwd.write_text(
        _raw_line({"t": "open", "v": 1, "gen": 2})
        + _raw_line({"t": "hint", "x": 1})
        + _raw_line({"t": "admit",
                     "req": {"id": 0, "prompt": [1], "max_new_tokens": 4}}))
    st = read_journal(fwd)
    assert st.generation == 2 and sorted(st.admitted) == [0]


def test_wal_batched_fsync_and_counters(tmp_path):
    tel = Telemetry()
    j = Journal(tmp_path / "wal.jsonl", sync_every=4, telemetry=tel)
    assert j.syncs == 1                        # the open record
    for i in range(8):
        j.admit(_req(Request, i, [1]))
    assert j.syncs == 3
    j.shutdown()
    assert j.syncs == 3                        # a clean shutdown syncs nothing
    snap = tel.metrics.snapshot()
    # the open record and its sync count too
    assert snap["serve_journal_records_total"] == 9.0
    assert snap["serve_journal_syncs_total"] == 3.0
    assert len(read_journal(tmp_path / "wal.jsonl").admitted) == 8
    with pytest.raises(ValueError, match="sync_every"):
        Journal(tmp_path / "x.jsonl", sync_every=0)


# ----------------------------------------------------------- the clients
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
    dec, params = serve_nano_family[:2]
    target = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, **MK), device="cpu"), params)
    ads = {"a": _rand_adapter(params, 1), "b": _rand_adapter(params, 2)}
    return dict(dec=dec, params=params, target=target, ads=ads)


def _client(env, jax_side, journal=None, **kw):
    kw = dict(dict(num_slots=3, prefill_len=8), **kw)
    if "adapters" not in kw:
        kw["tenant_classes"] = _classes(JaxTenantClass if jax_side
                                        else TenantClass)
    if jax_side:
        client = JaxServeClient(env["dec"], env["params"], journal=journal,
                                **kw)
    else:
        client = ServeClient(env["target"], env["target"].state_dict(),
                             journal=journal, device="cpu", **kw)
    return client


def _work(sampled):
    return [dict(w, **(SAMPLED.get(i, {}) if sampled else {}))
            for i, w in enumerate(WORK)]


def _serve(client, work):
    for w in work:
        client.submit(**w)
    out = client.run_until_idle()
    client.shutdown()
    return out


def _state(st):
    """A JournalState as plain data (requests by their fields)."""
    doc = dataclasses.asdict(st)
    doc["path"] = None
    return doc


def test_client_journal_bytes_equal_jax_and_fold_equally(env, tmp_path):
    """The same trace through the JAX and the port client writes the same
    journal bytes; the JAX client's journal folds to the same state
    under either reader."""
    paths = {}
    outs = {}
    for jax_side in (True, False):
        path = tmp_path / f"{'jax' if jax_side else 'port'}.jsonl"
        mod = JaxJournal if jax_side else Journal
        outs[jax_side] = _serve(_client(env, jax_side, mod(path,
                                                           sync_every=3)),
                                _work(False))
        paths[jax_side] = path
    assert paths[False].read_bytes() == paths[True].read_bytes()
    assert {r: c.tokens for r, c in outs[False].items()} == {
        r: c.tokens for r, c in outs[True].items()}
    mine = read_journal(paths[True])
    theirs = jax_read_journal(paths[True])
    assert _state(mine) == _state(theirs)
    assert len(mine.retired) == len(WORK) and mine.pending() == []


def _killed(env, path, ticks, sampled, **kw):
    """Serve WORK with a journal until the ``serve.driver`` site kills the
    driver at tick ``ticks``; the client is abandoned (no shutdown)."""
    client = _client(env, False, Journal(path, sync_every=1), **kw)
    for w in _adapter_work() if "adapters" in kw else _work(sampled):
        client.submit(**w)
    plan = FaultPlan.at("serve.driver", [ticks])
    with plan.armed():
        with pytest.raises(InjectedFault):
            client.run_until_idle()
    return set(client.completions)


def _adapter_work():
    """A sampled row under adapter "a", a greedy one under "b"."""
    return [dict(prompt=[1, 2, 3], max_new_tokens=6, adapter="a",
                 temperature=0.9, seed=100),
            dict(prompt=[2, 2, 3], max_new_tokens=6, adapter="b", seed=101)]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_restore_after_a_driver_kill_finishes_the_trace(env, tmp_path,
                                                        sampled):
    ref = _serve(_client(env, False), _work(sampled))
    path = tmp_path / "wal.jsonl"
    retired = _killed(env, path, 5, sampled)
    assert retired, "the short row must retire before the kill"
    st = read_journal(path)
    assert set(st.retired) == retired
    pend = {r.id for r, _ in st.pending()}
    assert pend == set(ref) - retired and pend
    assert all(toks for _, toks in st.pending()), "kill lands mid-decode"
    tel = Telemetry()
    restored = ServeClient.restore(
        path, env["target"], env["target"].state_dict(), device="cpu",
        num_slots=3, prefill_len=8, tenant_classes=_classes(TenantClass),
        telemetry=tel)
    out = restored.run_until_idle()
    restored.shutdown()
    assert set(out) == pend                    # nothing re-emitted
    for rid in pend:
        assert (out[rid].tokens, out[rid].tenant, out[rid].finish_reason) \
            == (ref[rid].tokens, ref[rid].tenant, ref[rid].finish_reason)
    assert restored._next_id >= st.next_request_id
    ev, = tel.events("journal.restored")
    assert ev.payload["replayed"] == len(pend)
    assert read_journal(path).generation == 1
    if not sampled:
        jax_ref = _serve(_client(env, True), _work(False))
        assert {r: out[r].tokens for r in pend} == {
            r: jax_ref[r].tokens for r in pend}


def test_restore_keeps_the_adapter_binding(env, tmp_path):
    akw = dict(num_slots=2, adapters=env["ads"], max_resident_adapters=2,
               lora_rank=2)
    ref = _serve(_client(env, False, **akw), _adapter_work())
    path = tmp_path / "wal.jsonl"
    _killed(env, path, 3, True, **akw)
    st = read_journal(path)
    assert {r.adapter for r, _ in st.pending()} == {"a", "b"}
    restored = ServeClient.restore(
        path, env["target"], env["target"].state_dict(), device="cpu",
        prefill_len=8, **akw)
    out = restored.run_until_idle()
    restored.shutdown()
    for rid in ref:
        assert (out[rid].tokens, out[rid].adapter) == (
            ref[rid].tokens, ref[rid].adapter), rid


def test_a_disarmed_journal_changes_nothing(env, tmp_path):
    """``journal=None`` (the default) gives the armed run's completions,
    and the client closes the journal at shutdown."""
    journal = Journal(tmp_path / "wal.jsonl")
    armed = _serve(_client(env, False, journal), _work(True))
    plain = _serve(_client(env, False), _work(True))
    assert journal.closed
    assert {r: (c.tokens, c.finish_time) for r, c in armed.items()} == {
        r: (c.tokens, c.finish_time) for r, c in plain.items()}
