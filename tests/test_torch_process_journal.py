"""Driver-death survival of the port's process replica fleet (``tests/test_journal.py``'s process cases) against the JAX package.

- A real driver kill: a driver script that imports only the port builds
  a ``backend="process"`` fleet with a journal and ``orphan_grace_s``,
  serves until every request has journaled frontier tokens, and is
  SIGKILLed. Its worker and its queue manager self-reap within the grace
  window (zero leaked processes), and ``ReplicaFleet.restore(...,
  backend="process")`` in this process (bumped generation) finishes
  every unretired request: greedy tokens equal the JAX ``ServeClient``'s
  on the same flax weights, sampled tokens the port's own fault-free
  client's.
- The split-brain fence: wrong-generation batches and beats are counted
  and dropped, never folded into the ledger or the monitor.
- ``_FencedChannel``: the generation stamp, the bounded put and the
  swallowed channel loss, on the JAX class and the port's alike.
- The two-generation kill chain (``slow``, as its JAX twin).

Workers run on the CPU (``device="cpu"``) with one torch thread.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch

import ray_lightning_tpu.launchers.serve_worker as jax_sw
import ray_lightning_tpu.serve as jax_serve
import ray_lightning_tpu_torch.launchers.serve_worker as sw
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.launchers.process_backend import (
    ORPHAN_GRACE_ENV, ProcessRay, install_orphan_guard_from_env)
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.obs import Telemetry
from ray_lightning_tpu_torch.serve import (Journal, ReplicaFleet,
                                           ServeClient, read_journal)

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port, pytest.mark.serve,
              pytest.mark.fleet_process, pytest.mark.multiproc]

ROOT = pathlib.Path(__file__).resolve().parent.parent
MK = dict(vocab_size=128, max_seq_len=32)
CKW = dict(num_slots=3, prefill_len=32)


@pytest.fixture(scope="module")
def nano(serve_nano_family):
    """The JAX decode model and params of ``serve_nano_family`` and the
    port's model and state dict on the same weights."""
    dec, params = serve_nano_family[:2]
    model = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, **MK), device="cpu"), params)
    return dec, params, model, model.state_dict()


@pytest.fixture
def weights(nano, tmp_path):
    """The state dict in a file, for a driver script that imports only
    the port."""
    path = tmp_path / "nano.pt"
    torch.save(nano[3], path)
    return path


def _references(nano, work):
    """Greedy rows: the JAX client's tokens; sampled rows: the port's
    own fault-free client's (torch cannot reproduce threefry keys)."""
    dec, params, model, sd = nano
    jax_client = jax_serve.ServeClient(dec, params, **CKW)
    port_client = ServeClient(model, sd, device="cpu", **CKW)
    for w in work:
        jax_client.submit(**w)
        port_client.submit(**w)
    jax_out = jax_client.run_until_idle()
    port_out = port_client.run_until_idle()
    jax_client.shutdown()
    port_client.shutdown()
    ref = {}
    for rid, w in enumerate(work):
        sampled = w.get("temperature", 0.0) > 0
        ref[rid] = (port_out if sampled else jax_out)[rid].tokens
    # the port's greedy rows equal JAX's too: the two references agree
    for rid, w in enumerate(work):
        if not w.get("temperature", 0.0) > 0:
            assert port_out[rid].tokens == jax_out[rid].tokens, rid
    return ref


_PRELUDE = """
import json, sys, time
import torch
torch.set_num_threads(1)
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.serve import Journal, ReplicaFleet

wal, weights = sys.argv[1], sys.argv[2]
sd = torch.load(weights)
model = TransformerLM(gpt2_config("nano", dtype=torch.float32,
                                  vocab_size=128, max_seq_len=32),
                      device="meta")
"""

_DRIVER_SCRIPT = _PRELUDE + """
fleet = ReplicaFleet(model, sd, backend="process", num_replicas=1,
                     journal=Journal(wal, sync_every=1),
                     orphan_grace_s=1.0, num_slots=3, prefill_len=32,
                     device="cpu")
for w in json.loads(sys.argv[3]):
    fleet.submit(**w)
# pump until every request has >= 2 journaled frontier tokens, then STOP
# ticking (so they stay unretired) and wait to be killed: the long
# max_new_tokens keeps the kill point mid-decode. One tick drains every
# batch the worker has flushed, journaling as it goes, and retires at its
# end: on a loaded host its drain can chase the worker from its first
# token to its last. So the kill point is checked after every journaled
# token, and the tick stops there, before the rest of its drain and its
# retirements.
class KillPoint(Exception):
    pass

journal = fleet._journal
note_frontier = journal.note_frontier

def note_and_check(*args, **kwargs):
    note_frontier(*args, **kwargs)
    sent = journal._sent
    if (not journal._retired and sent
            and all(v >= 2 for v in sent.values())):
        raise KillPoint

journal.note_frontier = note_and_check
deadline = time.time() + 240
while time.time() < deadline:
    try:
        fleet.tick()
    except KillPoint:
        break
    if fleet._journal._retired:
        raise SystemExit("request retired before the kill point")
    time.sleep(0.01)
else:
    raise SystemExit("no frontier progress before deadline")
pids = [rep.actor._proc.pid for rep in fleet._replicas]
pids.append(fleet.process_backend._manager._process.pid)
print("PIDS " + json.dumps(pids), flush=True)
print("READY", flush=True)
while True:
    time.sleep(1)
"""

_RESTART_SCRIPT = _PRELUDE + """
fleet = ReplicaFleet.restore(wal, model, sd, backend="process",
                             num_replicas=1, orphan_grace_s=1.0,
                             num_slots=3, prefill_len=32, device="cpu")
deadline = time.time() + 240
while time.time() < deadline:
    fleet.tick()
    sent = fleet._journal._sent
    if sent and all(v >= 3 for v in sent.values()):
        break
    time.sleep(0.01)
print("READY", flush=True)
while True:
    time.sleep(1)
"""


def _kill_driver(script, *args):
    """Run a driver script until it prints READY, SIGKILL it, and return
    the pids it reported (its workers and its queue manager)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            text=True)
    pids = []
    try:
        deadline = time.time() + 300
        for line in proc.stdout:
            if line.startswith("PIDS "):
                pids = json.loads(line[5:])
            if line.strip() == "READY" or time.time() > deadline:
                break
        os.kill(proc.pid, signal.SIGKILL)  # the driver death
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return pids


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def test_process_driver_sigkill_warm_restart(nano, weights, tmp_path):
    """SIGKILL the driver of a ``backend="process"`` fleet mid-decode.
    The orphaned worker AND the queue manager self-reap within the grace
    window, and a warm restart here (bumped generation) replays every
    unretired request to the references' tokens."""
    dec, params, model, sd = nano
    work = [dict(prompt=[5, 17, 3, 9], max_new_tokens=24, seed=100),
            dict(prompt=[9, 2, 44], max_new_tokens=24, temperature=0.9,
                 top_k=8, seed=101)]
    ref = _references(nano, work)
    wal = tmp_path / "wal.jsonl"
    pids = _kill_driver(_DRIVER_SCRIPT, wal, weights, json.dumps(work))
    assert len(pids) == 2, "driver never reported its worker pids"

    # orphan reaping: worker + manager exit within grace (1 s) + margin
    deadline = time.time() + 30
    while time.time() < deadline and any(_pid_alive(p) for p in pids):
        time.sleep(0.2)
    leaked = [p for p in pids if _pid_alive(p)]
    for p in leaked:  # never leak into the suite, even on failure
        os.kill(p, signal.SIGKILL)
    assert not leaked, f"orphaned processes survived the grace: {leaked}"

    st = read_journal(wal)
    assert st.generation == 0 and not st.retired
    pend = {r.id for r, _ in st.pending()}
    assert pend == set(ref)
    assert all(len(t) >= 2 for _, t in st.pending())

    fleet = ReplicaFleet.restore(wal, model, sd, backend="process",
                                 num_replicas=1, orphan_grace_s=1.0,
                                 device="cpu", **CKW)
    try:
        assert fleet._generation == 1  # the split-brain fence bumped
        out = fleet.run_until_idle()
    finally:
        fleet.shutdown()
    assert fleet.process_backend.live_actor_count() == 0
    assert set(out) == pend  # zero duplicate completions
    for rid in pend:
        assert out[rid].tokens == ref[rid], (rid, ref[rid], out[rid].tokens)
    # the restarted journal holds the whole story: generation 1 open
    # record, re-admissions with replay bindings, final retires
    st2 = read_journal(wal)
    assert st2.generation == 1
    assert set(st2.retired) == pend and not st2.pending()


def test_stale_generation_messages_refused(nano, tmp_path):
    """Split-brain fence: wrong-generation batches and beats on the
    manager queues are counted and dropped, never folded into the
    ledger or the gang monitor."""
    tel = Telemetry()
    fleet = ReplicaFleet(nano[2], nano[3], backend="process",
                         num_replicas=1,
                         journal=Journal(tmp_path / "wal.jsonl",
                                         generation=2, sync_every=1),
                         telemetry=tel, num_slots=2, prefill_len=8,
                         device="cpu")
    try:
        assert fleet._generation == 2
        rid = fleet._replicas[0].id
        # a dead driver's worker raced these over: generation 1 < 2
        fleet._out.put((sw.MSG_BATCH, rid,
                        [(sw.MSG_STATUS, rid, {"queue_depth": 77})], 1))
        fleet._hb.put((rid, 999, 0.0, 1))
        deadline = time.time() + 10
        while fleet.stale_dropped < 2 and time.time() < deadline:
            fleet.tick()
        assert fleet.stale_dropped == 2
        # the stale status never reached the mirror, the stale beat
        # never advanced the monitor
        assert fleet._replicas[0].client.scheduler.depth != 77
        assert fleet._replicas[0].last_step != 999
        assert tel.metrics.snapshot()[
            "serve_journal_stale_dropped_total"] == 2
        assert len(tel.events("journal.stale_dropped")) == 2
    finally:
        fleet.shutdown()
    assert fleet.process_backend.live_actor_count() == 0


@pytest.mark.parametrize("mod", [jax_sw, sw], ids=["jax", "port"])
def test_fenced_channel_bounds_and_stamps(mod):
    """Worker-side queue ops are bounded and generation-stamped: the
    wrapper appends the fence to every tuple, passes a timeout derived
    from the orphan grace to every put, and swallows channel loss."""

    class Rec:
        def __init__(self, fail=False):
            self.calls, self.fail = [], fail

        def put(self, item, block=True, timeout=None):
            if self.fail:
                raise OSError("manager gone")
            self.calls.append((item, block, timeout))

    q = Rec()
    ch = mod._FencedChannel(q, generation=7, grace_s=1.0)
    ch.put(("batch", 0, ["x"]))
    (item, block, timeout), = q.calls
    assert item == ("batch", 0, ["x"], 7)
    assert block is True and 0 < timeout <= 1.0
    # channel loss is swallowed (the dispatch loop must outlive it);
    # outside a spawned worker (no TL_WORKER_PROCESS) it never exits
    dead = mod._FencedChannel(Rec(fail=True), generation=7, grace_s=0.0)
    for _ in range(3):
        dead.put(("beat",))
    assert dead._first_fail is not None


def test_manager_queue_bounded_put_and_guarded_manager(monkeypatch):
    """``ProcessRay(orphan_grace_s=)`` starts its manager with the orphan
    guard; its queue's ``put`` takes ``block`` and ``timeout`` (a large
    item still crosses through a temporary file); the guard arms only
    when its variable is set."""
    monkeypatch.delenv(ORPHAN_GRACE_ENV, raising=False)
    assert install_orphan_guard_from_env() is None
    ray = ProcessRay(orphan_grace_s=5.0)
    try:
        q = ray.make_queue()
        q.put(("small", 1), True, 1.0)
        big = torch.zeros(17 << 20, dtype=torch.float32)   # 68 MiB
        q.put(big, block=True, timeout=5.0)
        assert q.get(timeout=10) == ("small", 1)
        assert torch.equal(q.get(timeout=30), big)
        assert ray._manager._process.is_alive()
    finally:
        ray.shutdown()


@pytest.mark.slow
def test_process_two_generation_kill_chain(nano, weights, tmp_path):
    """Kill the driver, restore, kill the RESTORED driver, restore again:
    one journal carries both generations and the final run still
    matches the references."""
    dec, params, model, sd = nano
    work = [dict(prompt=[5, 17, 3], max_new_tokens=24, seed=100),
            dict(prompt=[9, 2], max_new_tokens=24, temperature=0.8,
                 seed=101)]
    ref = _references(nano, work)
    wal = tmp_path / "wal.jsonl"
    _kill_driver(_DRIVER_SCRIPT, wal, weights, json.dumps(work))
    assert read_journal(wal).generation == 0
    _kill_driver(_RESTART_SCRIPT, wal, weights)
    st = read_journal(wal)
    assert st.generation == 1

    fleet = ReplicaFleet.restore(wal, model, sd, backend="process",
                                 num_replicas=1, orphan_grace_s=1.0,
                                 device="cpu", **CKW)
    try:
        assert fleet._generation == 2
        out = fleet.run_until_idle()
    finally:
        fleet.shutdown()
    for rid, tokens in ref.items():
        if rid in out:
            assert out[rid].tokens == tokens, rid
        else:
            assert rid in st.retired
