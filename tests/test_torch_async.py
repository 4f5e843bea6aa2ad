"""The port's async dispatch (``ServeClient(async_dispatch=True)``, ``step_enqueue``/``step_sync``) against the JAX package.

The port's pipelined client replays the suite's staggered nano trace
(the ``serve_nano_family`` shapes: vocab 128, max_seq_len 32, f32,
unrolled, 3 slots, prefill_len 8, so the JAX legs compile nothing new)
beside the JAX async client of the same layout: the dense slot pool,
the dense-view paged path, and page-native (JAX's Pallas engine in
interpret mode), at 1 and 3 steps a dispatch, with int8 KV, chunked
with the prefix cache, and with a draft at k = 2. Greedy tokens, finish
reasons, tick stamps (one tick = one ENQUEUED dispatch) and the order
completions arrive in must be identical.

Sampled streams cannot match across frameworks, so inside the port the
async client's sampled tokens are held to the sync client's, spec
included (a spec batch with a sampled row drains the pipeline before
its enqueue). The rest mirrors ``tests/test_async_dispatch.py``'s cases
that need no crash supervision: a deadline expiring between enqueue
and sync, the barrier guard, refused double, out-of-order and foreign
syncs, and shutdown with a dispatch in flight.
"""
import numpy as np
import pytest
import torch

from ray_lightning_tpu.serve import ServeClient as JaxServeClient
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.serve import (ServeClient, ServeEngine,
                                           SlotPoolFull)
from ray_lightning_tpu_torch.serve.request import Request

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

MK = dict(vocab_size=128, max_seq_len=32)
PROMPTS = [[5, 17, 3, 9], [9, 2, 44], [42, 7], [1]]
TRACE = [
    (0, dict(prompt=PROMPTS[0], max_new_tokens=6)),
    (0, dict(prompt=PROMPTS[1], max_new_tokens=6)),
    (3, dict(prompt=PROMPTS[2], max_new_tokens=6)),
    (5, dict(prompt=PROMPTS[3], max_new_tokens=6)),
    (6, dict(prompt=[33, 4], max_new_tokens=1)),
    (7, dict(prompt=[8, 8, 8], max_new_tokens=2)),
]
SAMPLED = [
    (0, dict(prompt=PROMPTS[0], max_new_tokens=7, temperature=0.9,
             top_k=20, seed=11)),
    (1, dict(prompt=PROMPTS[1], max_new_tokens=6, temperature=0.7,
             seed=23, eos_id=100)),
    (3, dict(prompt=PROMPTS[2], max_new_tokens=6, eos_id=100)),
]
# the port's kernel names for the JAX package's
PAGE_NATIVE = (dict(page_size=4, page_native=True, attention_kernel="cuda"),
               dict(page_size=4, page_native=True,
                    attention_kernel="pallas"))
LAYOUTS = {"dense": ({}, {}), "view": (dict(page_size=4),
                                       dict(page_size=4)),
           "page_native": PAGE_NATIVE}


@pytest.fixture(scope="module")
def nano(serve_nano_family):
    return serve_nano_family


@pytest.fixture(scope="module")
def port(nano):
    """The port's target and draft (f32, CPU) holding the JAX weights."""
    _, params, _, dparams = nano
    target = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, **MK), device="cpu"), params)
    draft = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, n_layers=1, **MK), device="cpu"),
        dparams)
    return target, draft


def _order(client, trace):
    """Replay ``trace``; returns the completions and the ids in the
    order they completed (tick by tick)."""
    order = []
    tick = client.tick

    def recording_tick():
        done = tick()
        order.extend(c.request_id for c in done)
        return done

    client.tick = recording_tick
    out = client.serve_trace(list(trace))
    client.shutdown()
    return out, order


def _run_jax(nano, trace, layout, *, draft=False, **kw):
    dec, params, jdraft, jdparams = nano
    if draft:
        kw.update(draft_model=jdraft, draft_params=jdparams, spec_k=2)
    return _order(JaxServeClient(dec, params, num_slots=3, prefill_len=8,
                                 **layout, **kw), trace)


def _run_port(port, trace, layout, *, draft=False, **kw):
    target, pdraft = port
    if draft:
        kw.update(draft_model=pdraft, draft_params=pdraft.state_dict(),
                  spec_k=2)
    return _order(ServeClient(target, target.state_dict(), num_slots=3,
                              prefill_len=8, device="cpu", **layout, **kw),
                  trace)


def _same(ref, out, stamps=True):
    (a, a_order), (b, b_order) = ref, out
    assert sorted(a) == sorted(b)
    for rid in a:
        assert (b[rid].tokens, b[rid].finish_reason) == (
            a[rid].tokens, a[rid].finish_reason), rid
        if stamps:
            assert (b[rid].arrival_time, b[rid].first_token_time,
                    b[rid].finish_time) == (
                a[rid].arrival_time, a[rid].first_token_time,
                a[rid].finish_time), rid
    if stamps:
        assert b_order == a_order


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_async_client_matches_jax_async_client(nano, port, layout, steps):
    """Tokens, stamps and completion order equal the JAX async client's
    on every layout, and the port's own sync client's tokens (its
    stamps lag: a dispatch is synced a tick after its enqueue)."""
    port_kw, jax_kw = LAYOUTS[layout]
    ref = _run_jax(nano, TRACE, jax_kw, async_dispatch=True,
                   steps_per_dispatch=steps)
    out = _run_port(port, TRACE, port_kw, async_dispatch=True,
                    steps_per_dispatch=steps)
    _same(ref, out)
    _same(out, _run_port(port, TRACE, port_kw, steps_per_dispatch=steps),
          stamps=False)


@pytest.mark.parametrize("layout", ["dense", "page_native"])
def test_async_int8_kv_matches_jax_and_the_sync_driver(nano, port, layout):
    """int8 KV: a row that retired inside an un-synced dispatch re-writes
    its frozen K/V into its own pages (re-quantized) one dispatch more
    than the sync driver does; the tokens of every row stay the sync
    driver's and the JAX async client's."""
    port_kw, jax_kw = LAYOUTS[layout]
    ref = _run_jax(nano, TRACE, jax_kw, async_dispatch=True,
                   kv_dtype="int8", steps_per_dispatch=3)
    out = _run_port(port, TRACE, port_kw, async_dispatch=True,
                    kv_dtype="int8", steps_per_dispatch=3)
    _same(ref, out)
    _same(out, _run_port(port, TRACE, port_kw, kv_dtype="int8",
                         steps_per_dispatch=3), stamps=False)


def test_async_chunked_prefix_matches_jax(nano, port):
    """Chunks are barriers; the chunk/decode alternation puts a pipelined
    step between two chunks, and the drain lands on the chunk turn.
    Prefix adoption included."""
    long_prompt = list(range(1, 13))
    trace = [(0, dict(prompt=long_prompt, max_new_tokens=6)),
             (1, dict(prompt=PROMPTS[0], max_new_tokens=6)),
             (4, dict(prompt=long_prompt[:10], max_new_tokens=5))]
    chunked = dict(prefill_chunk=8, prefix_cache=True, num_pages=48)
    port_kw, jax_kw = PAGE_NATIVE
    ref = _run_jax(nano, trace, dict(jax_kw, **chunked), async_dispatch=True)
    out = _run_port(port, trace, dict(port_kw, **chunked),
                    async_dispatch=True)
    _same(ref, out)
    assert out[0][2].prefix_hit_tokens == ref[0][2].prefix_hit_tokens > 0


def test_async_spec_matches_jax(nano, port):
    """Spec dispatches chain on the carry too (no stale rows between
    admissions): the JAX async spec client's tokens and stamps."""
    port_kw, jax_kw = PAGE_NATIVE
    ref = _run_jax(nano, TRACE, jax_kw, draft=True, async_dispatch=True)
    out = _run_port(port, TRACE, port_kw, draft=True, async_dispatch=True)
    _same(ref, out)


def test_async_deadline_between_enqueue_and_sync_matches_jax(nano, port):
    """A deadline expiring while a dispatch is in flight syncs it first,
    then judges: a row the pending dispatch retired keeps its finish
    reason, and a genuine expiry keeps the sync driver's tokens."""
    trace = [
        (0, dict(prompt=PROMPTS[0], max_new_tokens=12, deadline=6.0)),
        (0, dict(prompt=PROMPTS[1], max_new_tokens=4)),
        (2, dict(prompt=PROMPTS[2], max_new_tokens=12, deadline=7.0)),
    ]
    ref = _run_jax(nano, trace, {}, async_dispatch=True)
    out = _run_port(port, trace, {}, async_dispatch=True)
    assert ref[0][0].finish_reason == "timeout"
    assert ref[0][1].finish_reason == "length"
    _same(ref, out)
    _same(out, _run_port(port, trace, {}), stamps=False)


@pytest.mark.parametrize("draft", [False, True], ids=["step", "spec"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_async_sampled_streams_equal_the_sync_driver(port, layout, draft):
    """Sampled rows: the async client's tokens are the sync client's
    (a row's seed is its step number, which the enqueue works out from
    the synced frontier and the dispatches in flight; a spec batch with
    a sampled row drains first)."""
    port_kw = LAYOUTS[layout][0]
    for steps in (1, 3):
        ref = _run_port(port, SAMPLED, port_kw, draft=draft,
                        steps_per_dispatch=steps)
        out = _run_port(port, SAMPLED, port_kw, draft=draft,
                        steps_per_dispatch=steps, async_dispatch=True)
        _same(ref, out, stamps=False)


def _engine(port, **kw):
    target, _ = port
    return ServeEngine(target, target.state_dict(), num_slots=2,
                       prefill_len=8, device="cpu", **kw)


def test_engine_barrier_guard_and_handle_order(port):
    """With a carry deferred, admission, chunks, cancels and a sync step
    are refused; a double sync, an out-of-order sync and a foreign handle
    too. Chained enqueues synced in order give the sync driver's
    stream."""
    eng = _engine(port, page_size=4, prefill_chunk=8)
    eng.prefill([Request(id=0, prompt=[5, 17, 3], max_new_tokens=4)])
    # a long prompt queued for chunks, so prefill_chunk_step has work
    eng.prefill([Request(id=9, prompt=list(range(1, 13)),
                         max_new_tokens=2)])
    pending = eng.step_enqueue()
    assert eng.carry_deferred and pending is not None
    for call in (lambda: eng.prefill([Request(id=1, prompt=[9, 2],
                                              max_new_tokens=4)]),
                 eng.prefill_chunk_step, lambda: eng.cancel(0), eng.step):
        with pytest.raises(RuntimeError, match="synced frontier"):
            call()
    other = _engine(port, page_size=4)
    other.prefill([Request(id=0, prompt=[5, 17, 3], max_new_tokens=4)])
    foreign = other.step_enqueue()
    with pytest.raises(RuntimeError, match="foreign handle"):
        eng.step_sync(foreign)
    done = eng.step_sync(pending)
    assert not eng.carry_deferred
    with pytest.raises(RuntimeError, match="out of order"):
        eng.step_sync(pending)
    p2, p3 = eng.step_enqueue(), eng.step_enqueue()
    with pytest.raises(RuntimeError, match="out of order"):
        eng.step_sync(p3)
    done += eng.step_sync(p2) + eng.step_sync(p3)
    assert [c.request_id for c in done] == [0]
    ref = _engine(port, page_size=4)
    ref.prefill([Request(id=0, prompt=[5, 17, 3], max_new_tokens=4)])
    sync_done = []
    while not sync_done:
        sync_done = ref.step()
    assert done[0].tokens == sync_done[0].tokens
    for e in (eng, other, ref):
        e.shutdown()


def test_adapter_loads_are_barriers(port):
    """``load_adapter``/``unload_adapter`` refuse while a handle is
    outstanding; the client drains its pipeline before them."""
    target, _ = port
    from ray_lightning_tpu_torch.models.lora import extract_adapter
    eng = _engine(port, max_resident_adapters=2, lora_rank=2)
    tree = extract_adapter(eng.model, 0)
    eng.prefill([Request(id=0, prompt=[5, 17, 3], max_new_tokens=4)])
    pending = eng.step_enqueue()
    with pytest.raises(RuntimeError, match="synced frontier"):
        eng.load_adapter("a", tree)
    eng.step_sync(pending)
    eng.load_adapter("a", tree)
    pending = eng.step_enqueue()
    with pytest.raises(RuntimeError, match="synced frontier"):
        eng.unload_adapter("a")
    eng.step_sync(pending)
    eng.unload_adapter("a")
    eng.shutdown()
    client = ServeClient(target, target.state_dict(), num_slots=2,
                         prefill_len=8, device="cpu", async_dispatch=True,
                         max_resident_adapters=2, lora_rank=2)
    client.submit([5, 17, 3], max_new_tokens=8)
    client.tick()          # prefill (a barrier)
    client.tick()          # a pipelined step: enqueued, nothing synced
    assert client.dispatch_in_flight
    assert client.load_adapter("a", tree) is None
    assert not client.dispatch_in_flight
    assert client.engine.resident_adapters == ["a"]
    client.shutdown()


def test_shutdown_with_a_dispatch_in_flight(port):
    """``shutdown()`` with a dispatch in flight discards the handle and
    releases the engine: no sync, no error."""
    target, _ = port
    client = ServeClient(target, target.state_dict(), num_slots=2,
                         prefill_len=8, device="cpu", async_dispatch=True,
                         page_size=4, page_native=True)
    assert not client.dispatch_in_flight
    client.submit(PROMPTS[0], max_new_tokens=8)
    client.tick()
    client.tick()
    assert client.dispatch_in_flight and client.engine.carry_deferred
    assert client.busy
    client.shutdown()
    assert not client.dispatch_in_flight
    assert client.engine.pool is None and not client.engine.carry_deferred


def test_pipelined_enqueue_reuses_device_inputs(port):
    """A steady-state enqueue uploads nothing it uploaded before: eos,
    the page table and the adapter ids stay cached on the device until
    their host copy changes, and the row state is the carry."""
    eng = _engine(port, page_size=4, page_native=True,
                  max_resident_adapters=2, lora_rank=2)
    eng.prefill([Request(id=0, prompt=[5, 17, 3], max_new_tokens=8),
                 Request(id=1, prompt=[9, 2], max_new_tokens=8)])
    p1 = eng.step_enqueue()
    cached = {k: v[1] for k, v in eng._staged.items()}
    uploads = []
    upload = eng._upload
    eng._upload = lambda arr: uploads.append(arr.shape) or upload(arr)
    p2 = eng.step_enqueue()
    assert uploads == []
    assert {k: v[1] for k, v in eng._staged.items()} == cached
    assert p2.carry is not p1.carry and eng._carry is p2.carry
    eng.step_sync(p1)
    eng.step_sync(p2)
    eng.shutdown()


def test_a_failed_admission_leaves_no_binding(port):
    """Admission stays atomic with adapters bound: a batch refused
    mid-way gives back its slots and its adapter pins."""
    eng = _engine(port, max_resident_adapters=2, lora_rank=2)
    from ray_lightning_tpu_torch.models.lora import extract_adapter
    eng.load_adapter("a", extract_adapter(eng.model, 0))
    with pytest.raises(ValueError, match="seed"):
        eng.prefill([Request(id=i, prompt=[1], max_new_tokens=2, seed=5,
                             adapter="a") for i in range(2)])
    with pytest.raises(SlotPoolFull):
        eng.prefill([Request(id=i, prompt=[1], max_new_tokens=2,
                             adapter="a") for i in range(3)])
    assert eng.adapter_refcount("a") == 0
    assert np.all(eng._adapter_ids == -1)
    eng.shutdown()
