"""The port's dense KV layouts (``page_size=None`` and ``page_native=False``) against the JAX package.

The serve family's nano target (vocab 128, max_seq_len 32, f32,
unrolled) and its 1-layer draft, the JAX weights carried across, on the
suite's staggered trace. The JAX legs are the JAX engine in the same
layout: its dense slot pool (``_engine_step_impl``,
``_prefill_inject_impl``) and its dense-view paged path
(``_paged_step_impl``: gather, the same step, write-masked scatter),
with XLA attention, which is the only read side those layouts take.
Greedy tokens, finish reasons and tick stamps must be identical, and
the spec engine's counters too.

After an int8 trace the storage itself is compared: codes within one,
scales at rtol 1e-5 (every dispatch re-derives every scale from
``absmax / 127`` of dequantized values, and the two frameworks' K/V
differ in the last bits of f32). A fresh K/V value whose ``x / scale``
lies within that noise of a half rounds to the other code; one layer
up, the attention then reads an element a whole code step away, and
that layer's K/V and scales move by ~1e-4 relative (1.06e-4 seen on the
dense-view trace). So a layer above a flipped code holds its scales to
``SCALE_RTOL_ABOVE_FLIP``; every layer below the first flip, to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.serve import ServeClient as JaxServeClient
from ray_lightning_tpu.serve.pages import \
    dense_storage_commit as jax_dense_storage_commit
from ray_lightning_tpu.serve.pages import \
    dense_storage_values as jax_dense_storage_values
from ray_lightning_tpu.serve.pages import gather_pages as jax_gather_pages
from ray_lightning_tpu.serve.pages import \
    quantize_dense_cache as jax_quantize_dense_cache
from ray_lightning_tpu.serve.pages import scatter_pages as jax_scatter_pages
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import (DenseKV, TransformerLM,
                                            gpt2_config, new_arena)
from ray_lightning_tpu_torch.models.quant import kv_quantize, kv_scales
from ray_lightning_tpu_torch.serve import (KVSlotPool, ServeClient,
                                           ServeEngine, SlotPoolFull)
from ray_lightning_tpu_torch.serve.pages import (QuantizedDenseKV,
                                                 dense_storage_commit,
                                                 dense_storage_values,
                                                 gather_pages,
                                                 quantize_dense_cache,
                                                 scatter_pages)
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
    # a budget of one, and a short budget arriving last
    (6, dict(prompt=[33, 4], max_new_tokens=1)),
    (7, dict(prompt=[8, 8, 8], max_new_tokens=2)),
]
DENSE = {}
VIEW = dict(page_size=4)
LAYOUTS = {"dense": DENSE, "view": VIEW}
SPEC_COUNTERS = ("steps", "decode_substeps", "prefills", "spec_rounds",
                 "spec_accepted_tokens", "spec_rejected_tokens",
                 "spec_draft_steps", "tokens_generated")
# codes within one step, scales relative: see the module docstring
SCALE_RTOL = 1e-5
SCALE_RTOL_ABOVE_FLIP = 1e-3


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


@pytest.fixture(scope="module")
def eos_trace(nano):
    """TRACE with request 0 stopping at its third greedy token (an eos
    mid-flight, inside a 3-step dispatch) and request 1 given a deadline
    that expires while it decodes."""
    free, _ = _run_jax(nano, TRACE, DENSE)
    eos = free[0].tokens[2]
    trace = [(t, dict(kw)) for t, kw in TRACE]
    trace[0][1]["eos_id"] = eos
    trace[1][1].update(max_new_tokens=12, deadline=4)
    return trace


def _counters(eng):
    out = {name: getattr(eng, name) for name in SPEC_COUNTERS}
    out["refills"] = eng.spec.refills if eng.spec is not None else 0
    return out


def _run_jax(nano, trace, layout, *, draft=False, k=2, keep=False, **kw):
    dec, params, jdraft, jdparams = nano
    if draft:
        kw.update(draft_model=jdraft, draft_params=jdparams, spec_k=k)
    client = JaxServeClient(dec, params, num_slots=3, prefill_len=8,
                            **layout, **kw)
    out = client.serve_trace(list(trace))
    counters = _counters(client.engine)
    if keep:
        return out, counters, client.engine
    client.shutdown()
    return out, counters


def _run_port(port, trace, layout, *, draft=False, k=2, keep=False, **kw):
    target, pdraft = port
    if draft:
        kw.update(draft_model=pdraft, draft_params=pdraft.state_dict(),
                  spec_k=k)
    client = ServeClient(target, target.state_dict(), num_slots=3,
                         prefill_len=8, device="cpu", **layout, **kw)
    out = client.serve_trace(list(trace))
    counters = _counters(client.engine)
    if keep:
        return out, counters, client.engine
    client.shutdown()
    return out, counters


def _same_completions(ref, out):
    assert sorted(ref) == sorted(out)
    for rid in ref:
        a, b = ref[rid], out[rid]
        assert (b.tokens, b.finish_reason) == (a.tokens, a.finish_reason), rid
        assert (b.arrival_time, b.first_token_time, b.finish_time) == (
            a.arrival_time, a.first_token_time, a.finish_time), rid


def _tokens(out):
    return {rid: c.tokens for rid, c in out.items()}


def _jax_int8_layers(storage):
    """JAX int8 storage -- a dense pool or a page arena, a ``(codes,
    scales)`` pair of cache trees -- as [(k, v, k_scale, v_scale)] per
    layer, numpy."""
    q, s = storage
    blocks = sorted(q["stack"], key=lambda b: int(b.split("_")[1]))
    return [tuple(np.asarray(tree["stack"][b]["attn"][leaf])
                  for tree, leaf in ((q, "cached_key"), (q, "cached_value"),
                                     (s, "cached_key"), (s, "cached_value")))
            for b in blocks]


def _assert_int8_storage_close(jax_layers, port_layers):
    """Codes within one; scales at ``SCALE_RTOL`` up to the first layer
    with a flipped code, at ``SCALE_RTOL_ABOVE_FLIP`` above it (the
    module docstring). Returns the codes that differ, by layer."""
    flips = []
    for theirs, mine in zip(jax_layers, port_layers):
        rtol = SCALE_RTOL_ABOVE_FLIP if any(flips) else SCALE_RTOL
        for j, m in zip(theirs[2:], mine[2:]):
            np.testing.assert_allclose(m.numpy(), j, rtol=rtol, atol=0)
        moved = 0
        for j, m in zip(theirs[:2], mine[:2]):
            diff = np.abs(j.astype(np.int32) - m.numpy().astype(np.int32))
            assert diff.max() <= 1
            moved += int((diff > 0).sum())
        flips.append(moved)
    return flips


# ----------------------------------------------------------- engines
@pytest.mark.parametrize("layout", ["dense", "view"])
@pytest.mark.parametrize("kv_dtype,steps", [(None, 1), (None, 3),
                                            ("int8", 1), ("int8", 3)],
                         ids=["f32-steps1", "f32-steps3", "int8-steps1",
                              "int8-steps3"])
def test_engine_matches_jax_engine_of_the_same_layout(
        nano, port, eos_trace, layout, kv_dtype, steps):
    """Greedy tokens, finish reasons (eos mid-flight, a deadline while
    decoding, budgets of one and two) and tick stamps equal the JAX
    engine's in the same layout; with int8 KV the storage after the
    trace too. The dense-view engine's tokens also equal the port's
    page-native engine's."""
    kw = dict(kv_dtype=kv_dtype, steps_per_dispatch=steps)
    ref, ref_counts, jeng = _run_jax(nano, eos_trace, LAYOUTS[layout],
                                     keep=True, **kw)
    out, counts, eng = _run_port(port, eos_trace, LAYOUTS[layout],
                                 keep=True, **kw)
    _same_completions(ref, out)
    assert counts == ref_counts
    assert {c.finish_reason for c in ref.values()} == {
        "eos", "timeout", "length"}
    if kv_dtype == "int8":
        if layout == "dense":
            mine = [(kv.key, kv.value, kv.key_scale, kv.value_scale)
                    for kv in eng.pool.cache]
            theirs = _jax_int8_layers(jeng.pool.cache)
        else:
            mine = [(kv.k[:-1], kv.v[:-1], kv.k_scale[:-1],
                     kv.v_scale[:-1]) for kv in eng.pool.arena]
            theirs = _jax_int8_layers(jeng.pool.arena)
        _assert_int8_storage_close(theirs, mine)
    if layout == "view":
        native, _ = _run_port(port, eos_trace, dict(page_size=4,
                                                    page_native=True), **kw)
        assert _tokens(native) == _tokens(out)


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_quantized_weights_match_jax_pallas_engine(nano, port, weight_dtype):
    """int8 and int4 weights on the dense engine (the plain quantized
    matmul) give the greedy tokens and stamps of the JAX dense engine
    running its fused Pallas matmul in interpret mode."""
    kw = dict(weight_dtype=weight_dtype)
    if weight_dtype == "int4":
        kw["weight_group_size"] = 8
    ref, _ = _run_jax(nano, TRACE, DENSE, matmul_kernel="pallas", **kw)
    out, _ = _run_port(port, TRACE, DENSE, matmul_kernel="torch", **kw)
    _same_completions(ref, out)


@pytest.mark.parametrize("layout", ["dense", "view"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_spec_on_dense_targets_matches_jax(nano, port, eos_trace, layout,
                                           kv_dtype):
    """Spec at k = 2 on a dense pool (JAX ``_spec_rounds_impl``) and on a
    dense view (``_spec_rounds_paged_impl``): tokens, stamps and every
    spec counter equal JAX's; tokens equal the port's non-spec engine's
    in the same layout."""
    kw = dict(kv_dtype=kv_dtype)
    ref, ref_counts = _run_jax(nano, eos_trace, LAYOUTS[layout], draft=True,
                               **kw)
    out, counts = _run_port(port, eos_trace, LAYOUTS[layout], draft=True,
                            **kw)
    _same_completions(ref, out)
    assert counts == ref_counts
    assert counts["spec_rounds"] == counts["steps"] > 0
    assert counts["spec_draft_steps"] == 3 * counts["spec_rounds"]
    plain, _ = _run_port(port, eos_trace, LAYOUTS[layout], **kw)
    assert _tokens(plain) == _tokens(out)


def test_spec_identical_draft_on_the_dense_pool(port):
    """The target as its own draft on the dense pool: every judged draft
    accepted, tokens those of the non-spec engine."""
    target, _ = port
    client = ServeClient(target, target.state_dict(), num_slots=3,
                         prefill_len=8, device="cpu", draft_model=target,
                         draft_params=target.state_dict(), spec_k=3)
    out = client.serve_trace(list(TRACE))
    eng = client.engine
    assert eng.spec_rejected_tokens == 0 and eng.spec_accepted_tokens > 0
    plain, _ = _run_port(port, TRACE, DENSE)
    assert _tokens(out) == _tokens(plain)


def test_deadlines_and_shedding_on_the_dense_engine(nano, port):
    """Queue and mid-decode deadline expiry and a request that can never
    fit land identically on the tick clock."""
    trace = [
        (0, dict(prompt=PROMPTS[0], max_new_tokens=6, deadline=3)),
        (0, dict(prompt=PROMPTS[1], max_new_tokens=6)),
        (0, dict(prompt=PROMPTS[2], max_new_tokens=6)),
        (0, dict(prompt=PROMPTS[3], max_new_tokens=6, deadline=1)),
        (1, dict(prompt=list(range(9)), max_new_tokens=2)),
    ]
    ref, _ = _run_jax(nano, trace, DENSE)
    out, _ = _run_port(port, trace, DENSE)
    assert {c.finish_reason for c in ref.values()} == {
        "timeout", "length", "rejected"}
    _same_completions(ref, out)


# ------------------------------------------------------------ the pool
def test_slot_pool_lowest_first_and_resorted(port):
    """Slots go lowest index first; released slots return in order; a
    co-resident seed is refused; the whole row of a new tenant is its
    prefill's (zeros past ``prefill_len``)."""
    target, _ = port
    eng = ServeEngine(target, target.state_dict(), num_slots=3,
                      prefill_len=8, device="cpu")
    pool = eng.pool
    assert isinstance(pool, KVSlotPool) and eng.free_pages is None
    reqs = [Request(id=i, prompt=[1 + i, 2], max_new_tokens=4)
            for i in range(3)]
    assert eng.admissible_prefix(reqs) == 3
    eng.prefill(reqs)
    assert sorted(pool.active) == [0, 1, 2] and pool.free_slots == 0
    assert eng.admissible_prefix(reqs) == 0
    eng.cancel(2)
    eng.cancel(0)
    assert pool._free == [0, 2]
    with pytest.raises(ValueError, match="seed"):
        pool.acquire(Request(id=9, prompt=[1], max_new_tokens=1, seed=1))
    key_before = pool.cache[0].key[0].clone()
    eng.prefill([Request(id=5, prompt=[7], max_new_tokens=3)])
    assert pool.slot_of(5) == 0
    assert torch.all(pool.cache[0].key[0, 8:] == 0)
    assert not torch.equal(pool.cache[0].key[0], key_before)
    with pytest.raises(SlotPoolFull):
        eng.prefill([Request(id=i, prompt=[1], max_new_tokens=1)
                     for i in range(10, 13)])


def test_dense_engine_admission_and_validation(port):
    """On a dense engine admission is slots and the prefill width only,
    the paged-only options refuse, and a request still has to fit."""
    target, _ = port
    sd = target.state_dict()
    eng = ServeEngine(target, sd, num_slots=3, prefill_len=8,
                      prefill_batch=2, device="cpu")
    reqs = [Request(id=i, prompt=[i + 1], max_new_tokens=30)
            for i in range(3)]
    assert eng.admissible_prefix(reqs) == 2
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.validate(Request(id=7, prompt=[1, 2], max_new_tokens=31))
    for kw in (dict(num_pages=8), dict(prefill_chunk=8),
               dict(prefix_cache=True)):
        with pytest.raises(ValueError, match="paged-KV features"):
            ServeEngine(target, sd, prefill_len=8, device="cpu", **kw)


# ------------------------------------------------------- storage units
def _random_cache(rng, B=3, S=32, H=4, D=32, layers=2):
    return [(rng.standard_normal((B, S, H, D)).astype(np.float32),
             rng.standard_normal((B, S, H, D)).astype(np.float32))
            for _ in range(layers)]


def _jax_cache_tree(layers):
    return {"stack": {f"block_{i}": {"attn": {
        "cache_index": jnp.zeros((), jnp.int32),
        "cached_key": jnp.asarray(k), "cached_value": jnp.asarray(v)}}
        for i, (k, v) in enumerate(layers)}}


def test_dense_int8_storage_matches_jax(nano):
    """``quantize_dense_cache``: codes and scales byte-equal to JAX's on
    random K/V (one zero row included); ``dense_storage_values`` equal;
    a commit after writing one position moves only that position's
    codes and scale: every untouched group comes back bit for bit."""
    dec = nano[0]
    rng = np.random.default_rng(0)
    layers = _random_cache(rng)
    layers[0][0][1] = 0.0
    jstore = jax_quantize_dense_cache(dec, _jax_cache_tree(layers))
    store = quantize_dense_cache([DenseKV(torch.from_numpy(k),
                                          torch.from_numpy(v))
                                  for k, v in layers])
    assert isinstance(store[0], QuantizedDenseKV)
    for theirs, mine in zip(_jax_int8_layers(jstore), store):
        for j, m in zip(theirs, (mine.key, mine.value, mine.key_scale,
                                 mine.value_scale)):
            assert m.numpy().tobytes() == np.asarray(j).tobytes()
    jvals = jax_dense_storage_values(dec, jstore)
    vals = dense_storage_values(store, torch.float32)
    np.testing.assert_array_equal(
        vals[1].value.numpy(),
        np.asarray(jvals["stack"]["block_1"]["attn"]["cached_value"]))
    before = [(kv.key.clone(), kv.key_scale.clone()) for kv in store]
    new = rng.standard_normal((4, 32)).astype(np.float32)
    vals[0].key[2, 5] = torch.from_numpy(new)
    jvals["stack"]["block_0"]["attn"]["cached_key"] = \
        jvals["stack"]["block_0"]["attn"]["cached_key"].at[2, 5].set(new)
    dense_storage_commit(store, vals)
    jstore = jax_dense_storage_commit(dec, jstore, jvals)
    _assert_int8_storage_close(
        _jax_int8_layers(jstore),
        [(kv.key, kv.value, kv.key_scale, kv.value_scale) for kv in store])
    keep = torch.ones((3, 32), dtype=torch.bool)
    keep[2, 5] = False
    for kv, (codes, scales) in zip(store, before):
        assert torch.equal(kv.key[keep], codes[keep])
        assert torch.equal(kv.key_scale[keep], scales[keep])


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_gather_and_scatter_match_jax(nano, quantized):
    """``gather_pages`` (−1 entries clamped to page 0, int8 dequantized)
    and ``scatter_pages`` (−1 entries dropped, int8 re-quantized per
    page and head) against JAX's on a random arena and table."""
    dec = nano[0]
    cfg = gpt2_config("nano", dtype=torch.float32, **MK)
    rng = np.random.default_rng(1)
    ps, num_pages = 4, 10
    pt = np.array([[3, 0, 7, -1, -1, -1, -1, -1],
                   [-1] * 8,
                   [9, 1, 2, 4, 5, 6, 8, -1]], np.int32)
    arena = new_arena(cfg, num_pages, ps, quantized, "cpu")
    jleaves = []
    for kv in arena:
        vals = [rng.standard_normal((num_pages, ps, 4, 32)).astype(
            np.float32) for _ in range(2)]
        if quantized:
            for store, sc, x in ((kv.k, kv.k_scale, vals[0]),
                                 (kv.v, kv.v_scale, vals[1])):
                x = torch.from_numpy(x)
                s = kv_scales(x, (1, 3))
                store[:num_pages] = kv_quantize(x, s)
                sc[:num_pages] = s
            jleaves.append((kv.k[:-1].numpy(), kv.v[:-1].numpy(),
                            kv.k_scale[:-1].numpy(), kv.v_scale[:-1].numpy()))
        else:
            kv.k[:num_pages] = torch.from_numpy(vals[0])
            kv.v[:num_pages] = torch.from_numpy(vals[1])
            jleaves.append((vals[0], vals[1]))

    def tree(i):
        return {"stack": {f"block_{n}": {"attn": {
            "cache_index": jnp.zeros((), jnp.int32),
            "cached_key": jnp.asarray(leaves[i]),
            "cached_value": jnp.asarray(leaves[i + 1])}}
            for n, leaves in enumerate(jleaves)}}
    jarena = (tree(0), tree(2)) if quantized else tree(0)
    jview = jax_gather_pages(dec, jarena, jnp.asarray(pt))
    view = gather_pages(arena, torch.from_numpy(pt), torch.float32)
    for n, kv in enumerate(view):
        attn = jview["stack"][f"block_{n}"]["attn"]
        np.testing.assert_array_equal(kv.key.numpy(),
                                      np.asarray(attn["cached_key"]))
        np.testing.assert_array_equal(kv.value.numpy(),
                                      np.asarray(attn["cached_value"]))
    # write new values into the view, scatter rows 0 and 2 back
    write = np.where(np.array([True, False, True])[:, None], pt, -1)
    for n, kv in enumerate(view):
        new = rng.standard_normal(tuple(kv.key.shape)).astype(np.float32)
        kv.key.copy_(torch.from_numpy(new))
        attn = jview["stack"][f"block_{n}"]["attn"]
        attn["cached_key"] = jnp.asarray(new)
    jarena = jax_scatter_pages(dec, jarena, jview, jnp.asarray(write))
    scatter_pages(arena, view, torch.from_numpy(write))
    if quantized:
        _assert_int8_storage_close(
            _jax_int8_layers(jarena),
            [(kv.k[:-1], kv.v[:-1], kv.k_scale[:-1], kv.v_scale[:-1])
             for kv in arena])
    else:
        for n, kv in enumerate(arena):
            attn = jarena["stack"][f"block_{n}"]["attn"]
            np.testing.assert_array_equal(kv.k[:-1].numpy(),
                                          np.asarray(attn["cached_key"]))
            np.testing.assert_array_equal(kv.v[:-1].numpy(),
                                          np.asarray(attn["cached_value"]))


def test_dense_engine_steps_every_row_in_place(port):
    """A dense step writes each slot's K/V at its own position: after a
    prefill of two prompts and one step, row 0 holds the prefill's K/V at
    0..3 and the step's at 4, and the parked slot's row changes only at
    its frozen position."""
    target, _ = port
    eng = ServeEngine(target, target.state_dict(), num_slots=3,
                      prefill_len=8, device="cpu")
    eng.prefill([Request(id=0, prompt=PROMPTS[0], max_new_tokens=4),
                 Request(id=1, prompt=PROMPTS[1], max_new_tokens=4)])
    k0 = eng.pool.cache[0].key.clone()
    eng.step()
    k1 = eng.pool.cache[0].key
    changed = (k1 != k0).any(dim=(2, 3))
    assert changed[0].nonzero().flatten().tolist() == [4]
    assert changed[1].nonzero().flatten().tolist() == [3]
    assert changed[2].nonzero().flatten().tolist() == [0]
