"""Speculative decoding in the port (``ray_lightning_tpu_torch/serve/spec.py``) against the JAX package.

The serve family's nano target (vocab 128, max_seq_len 32, f32,
unrolled) and its 1-layer draft, the JAX weights carried across. Every
JAX engine leg runs page-native with ``attention_kernel="pallas"`` (the
kernel in interpret mode), as ``tests/test_torch_serve.py`` does. Greedy
spec is deterministic, so the port's tokens, finish reasons, tick stamps
and spec counters must equal the JAX spec engine's exactly, and its
tokens the port's own non-spec engine's. The unit functions (the accept
rule's greedy branch, the row distributions, the per-row dense decode
step, the draft refill, the verify) are held against their JAX
counterparts. Sampled streams cannot match across the frameworks
(different random bits): the sampling contract is held inside the port,
and the rejection rule is shown distribution-exact by frequencies.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.generate import \
    _prefill_impl as jax_prefill_impl
from ray_lightning_tpu.models.generate import decode_step as jax_decode_step
from ray_lightning_tpu.models.generate import \
    verify_step_paged as jax_verify_step_paged
from ray_lightning_tpu.serve import ServeClient as JaxServeClient
from ray_lightning_tpu.serve import ServeEngine as JaxServeEngine
from ray_lightning_tpu.serve.pages import PagePool as JaxPagePool
from ray_lightning_tpu.serve.pages import scatter_pages as jax_scatter_pages
from ray_lightning_tpu.serve.request import Request as JaxRequest
from ray_lightning_tpu.serve.spec import SpecDecoder as JaxSpecDecoder
from ray_lightning_tpu.serve.spec import \
    _draft_refill_impl as jax_draft_refill_impl
from ray_lightning_tpu.serve.spec import _row_probs as jax_row_probs
from ray_lightning_tpu.serve.spec import _spec_accept as jax_spec_accept
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import (TransformerLM, gpt2_config,
                                            new_cache, sample_logits_rows)
from ray_lightning_tpu_torch.models.generate import (_prefill_impl,
                                                    decode_step,
                                                    decode_step_paged,
                                                    verify_step_paged)
from ray_lightning_tpu_torch.serve import ServeClient, ServeEngine
from ray_lightning_tpu_torch.serve.pages import PagePool, scatter_pages
from ray_lightning_tpu_torch.serve.request import Request
from ray_lightning_tpu_torch.serve.spec import (SpecDecoder, _row_probs,
                                                _spec_accept, stream_seed,
                                                _draft_refill_impl)

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

MK = dict(vocab_size=128, max_seq_len=32)
PROMPTS = [[5, 17, 3, 9], [9, 2, 44], [42, 7], [1]]
TRACE = [
    (0, dict(prompt=PROMPTS[0], max_new_tokens=6)),
    (0, dict(prompt=PROMPTS[1], max_new_tokens=6)),
    (3, dict(prompt=PROMPTS[2], max_new_tokens=6)),
    (5, dict(prompt=PROMPTS[3], max_new_tokens=6)),
    # a budget smaller than a round's k+1 tokens, arriving last
    (6, dict(prompt=[33, 4], max_new_tokens=2)),
]
PAGED = dict(page_size=4, page_native=True)
SPEC_COUNTERS = ("steps", "decode_substeps", "spec_rounds",
                 "spec_accepted_tokens", "spec_rejected_tokens",
                 "spec_draft_steps")


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
def eos_trace(port):
    """TRACE with request 0 stopping at its third greedy token: an eos
    inside a round."""
    target, _ = port
    free = _run_port(target, None, TRACE)[0]
    eos = free[0].tokens[2]
    return [(t, dict(kw, eos_id=eos) if i == 0 else kw)
            for i, (t, kw) in enumerate(TRACE)]


def _counters(eng):
    out = {name: getattr(eng, name) for name in SPEC_COUNTERS}
    out["refills"] = eng.spec.refills if eng.spec is not None else 0
    return out


def _run_jax(nano, trace, *, draft="draft", k=2, **kw):
    dec, params, jdraft, jdparams = nano
    if draft == "target":
        jdraft, jdparams = dec, params
    client = JaxServeClient(dec, params, num_slots=3, prefill_len=8,
                            attention_kernel="pallas", draft_model=jdraft,
                            draft_params=jdparams, spec_k=k, **PAGED, **kw)
    out = client.serve_trace(list(trace))
    counters = _counters(client.engine)
    client.shutdown()
    return out, counters


def _run_port(target, draft, trace, *, k=2, observe=None, **kw):
    kw = dict(dict(num_slots=3, prefill_len=8, device="cpu", **PAGED), **kw)
    if draft is not None:
        kw.update(draft_model=draft, draft_params=draft.state_dict(),
                  spec_k=k)
    client = ServeClient(target, target.state_dict(), **kw)
    if observe is not None:
        observe(client.engine)
    out = client.serve_trace(list(trace))
    counters = _counters(client.engine)
    client.shutdown()
    return out, counters


def _same_completions(ref, out):
    assert sorted(ref) == sorted(out)
    for rid in ref:
        a, b = ref[rid], out[rid]
        assert (b.tokens, b.finish_reason) == (a.tokens, a.finish_reason), rid
        assert (b.arrival_time, b.first_token_time, b.finish_time) == (
            a.arrival_time, a.first_token_time, a.finish_time), rid
        assert b.prefix_hit_tokens == a.prefix_hit_tokens, rid


def _same_tokens(ref, out):
    assert {r: c.tokens for r, c in out.items()} == {
        r: c.tokens for r, c in ref.items()}


# ------------------------------------------------------------ engines
@pytest.mark.parametrize("k,kv_dtype,steps,draft", [
    (2, None, 1, "draft"), (4, None, 3, "draft"), (2, "int8", 1, "draft"),
    (4, "int8", 1, "draft"), (2, None, 1, "target")],
    ids=["k2-f32", "k4-f32-steps3", "k2-int8", "k4-int8",
         "k2-f32-identical-draft"])
def test_spec_engine_matches_jax_spec_engine(nano, port, eos_trace, k,
                                             kv_dtype, steps, draft):
    """Greedy spec on the staggered trace (an eos inside a round, a
    budget below k+1): tokens, finish reasons, tick stamps and every
    spec counter equal the JAX Pallas spec engine's; tokens equal the
    port's non-spec engine's. The identical draft (the target itself)
    runs the all-accept path and the bonus token."""
    target, pdraft = port
    kw = dict(kv_dtype=kv_dtype, steps_per_dispatch=steps)
    ref, ref_counts = _run_jax(nano, eos_trace, draft=draft, k=k, **kw)
    out, counts = _run_port(target, target if draft == "target" else pdraft,
                            eos_trace, k=k, attention_kernel="cuda", **kw)
    _same_completions(ref, out)
    assert counts == ref_counts
    assert ref[0].finish_reason == "eos"
    assert counts["spec_rounds"] == steps * counts["steps"]
    assert counts["spec_draft_steps"] == (k + 1) * counts["spec_rounds"]
    assert counts["refills"] == len(eos_trace)
    if draft == "target":
        assert counts["spec_rejected_tokens"] == 0
        assert counts["spec_accepted_tokens"] > 0
    plain, _ = _run_port(target, None, eos_trace, **kw)
    _same_tokens(plain, out)


def test_spec_chunked_prefix_matches_jax(nano, port):
    """Spec composed with chunked prefill and the prefix cache: the same
    tokens, stamps, adopted prefix and counters as the JAX engine; and
    no spec dispatch changes a byte of a page more than one holder
    references."""
    target, pdraft = port
    rng = np.random.default_rng(3)
    shared = [int(t) for t in rng.integers(0, 128, size=12)]
    trace = [
        (0, dict(prompt=shared + [1, 2], max_new_tokens=5)),
        (16, dict(prompt=shared + [7, 8], max_new_tokens=5)),
        (17, dict(prompt=[9, 2, 44], max_new_tokens=5)),
    ]
    kw = dict(prefill_chunk=4, prefix_cache=True)
    ref, ref_counts = _run_jax(nano, trace, k=2, **kw)
    checked = []

    def observe(eng):
        step = eng.step

        def guarded_step():
            pool = eng.pool
            shared_pages = np.flatnonzero(pool.refcounts(
                np.arange(pool.num_pages)) > 1)
            before = [(kv.k[shared_pages].clone(),
                       kv.v[shared_pages].clone()) for kv in pool.arena]
            done = step()
            for kv, (k_old, v_old) in zip(pool.arena, before):
                assert torch.equal(kv.k[shared_pages], k_old)
                assert torch.equal(kv.v[shared_pages], v_old)
            checked.append(len(shared_pages))
            return done
        eng.step = guarded_step

    out, counts = _run_port(target, pdraft, trace, k=2, observe=observe,
                            attention_kernel="cuda", **kw)
    _same_completions(ref, out)
    assert counts == ref_counts
    assert out[1].prefix_hit_tokens > 0
    assert max(checked) > 0     # shared pages existed during spec steps
    plain, _ = _run_port(target, None, trace, **kw)
    _same_tokens(plain, out)


def test_spec_quantized_weights_match_jax(nano, port, eos_trace):
    """int8 target and int8 draft (the port's plain fused matmul on the
    CPU, JAX's Pallas kernel in interpret mode): the same tokens, stamps
    and counters; ``param_bytes`` counts the draft's codes."""
    target, pdraft = port
    kw = dict(weight_dtype="int8", draft_weight_dtype="int8")
    ref, ref_counts = _run_jax(nano, eos_trace, k=2, matmul_kernel="pallas",
                               **kw)
    out, counts = _run_port(target, pdraft, eos_trace, k=2,
                            matmul_kernel="torch", **kw)
    _same_completions(ref, out)
    assert counts == ref_counts
    with_draft = ServeEngine(target, target.state_dict(), prefill_len=8,
                             device="cpu", draft_model=pdraft,
                             draft_params=pdraft.state_dict(), **kw, **PAGED)
    alone = ServeEngine(target, target.state_dict(), prefill_len=8,
                        device="cpu", weight_dtype="int8", **PAGED)
    assert with_draft.param_bytes() - alone.param_bytes() \
        == with_draft.spec.param_bytes()
    assert with_draft.spec.model.stack.blocks[0].mlp.up.qweight is not None


# --------------------------------------------------------- unit parts
def _accept_inputs(seed=0, B=5, k=3, V=16):
    """Seeded logits whose argmaxes the drafts partly agree with; row 1
    carries an eos inside its committed prefix, row 2 a budget of 2, row
    3 is inactive, row 4 agrees on every draft (the bonus)."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, k + 1, V)).astype(np.float32)
    dlog = rng.standard_normal((B, k, V)).astype(np.float32)
    tg = L.argmax(-1).astype(np.int32)
    drafts = rng.integers(0, V, (B, k)).astype(np.int32)
    drafts[0, :1] = tg[0, :1]           # one accepted, then diverges
    drafts[1] = tg[1, :k]               # all agree; eos is the second
    drafts[2] = tg[2, :k]
    drafts[3] = tg[3, :k]
    drafts[4] = tg[4, :k]
    eos = np.full((B,), -1, np.int32)
    eos[1] = tg[1, 1]
    if tg[1, 0] == eos[1]:
        eos[1] = -1
    return dict(
        L=L, draft_toks=drafts, draft_logits=dlog,
        cur=rng.integers(0, V, (B, 1)).astype(np.int32),
        pos=np.array([[3], [7], [10], [2], [29]], np.int32),
        active=np.array([True, True, True, False, True]),
        remaining=np.array([6, 6, 2, 4, 9], np.int32),
        temp=np.zeros((B,), np.float32), top_k=np.zeros((B,), np.int32),
        eos=eos, stepno=np.array([1, 3, 5, 1, 2], np.int32), k=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_accept_greedy_matches_jax(seed):
    x = _accept_inputs(seed)
    k, B = x["k"], len(x["active"])
    ref = jax_spec_accept(
        jnp.asarray(x["L"]), jnp.asarray(x["draft_toks"]),
        jnp.asarray(x["draft_logits"]), jnp.asarray(x["cur"]),
        jnp.asarray(x["pos"]), jnp.asarray(x["active"]),
        jnp.asarray(x["remaining"]), jnp.asarray(x["temp"]),
        jnp.asarray(x["top_k"]), jnp.asarray(x["eos"]),
        jnp.zeros((B, 2), jnp.uint32), jnp.asarray(x["stepno"]), 31, k=k)
    t = {n: torch.from_numpy(np.asarray(x[n])) for n in (
        "L", "draft_toks", "draft_logits", "cur", "pos", "active",
        "remaining", "eos", "stepno")}
    out = _spec_accept(t["L"], t["draft_toks"], t["draft_logits"], t["cur"],
                       t["pos"], t["active"], t["remaining"], x["temp"],
                       x["top_k"], t["eos"], t["stepno"], None, 31, k=k)
    names = ("cur", "pos", "active", "remaining", "stepno", "emitted",
             "accepted", "rejected", "finished")
    for name, a, b in zip(names, ref, out):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    emitted = out[5].numpy()
    assert (emitted[3] == -1).all()                      # inactive
    assert (emitted[2] >= 0).sum() == 2                  # budget clamp
    if x["eos"][1] >= 0:
        assert emitted[1, 1] == x["eos"][1] and (emitted[1, 2:] == -1).all()
    assert (emitted[4] >= 0).sum() == k + 1              # the bonus


def test_row_probs_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 128)).astype(np.float32) * 3
    temp = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    top_k = np.array([0, 5, 0, 3], np.int32)
    ref = np.asarray(jax_row_probs(jnp.asarray(logits), jnp.asarray(temp),
                                   jnp.asarray(top_k)))
    got = _row_probs(torch.from_numpy(logits), temp, top_k).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert (got[1] > 0).sum() == 5 and (got[3] > 0).sum() == 3


def _jax_cache(model, key, value):
    """The JAX decode cache tree of ``model`` holding (L, B, S, H, D)
    ``key``/``value``."""
    return {"stack": {f"block_{i}": {"attn": {
        "cached_key": jnp.asarray(key[i]),
        "cached_value": jnp.asarray(value[i]),
        "cache_index": jnp.zeros((), jnp.int32)}}
        for i in range(model.cfg.n_layers)}}


def _random_kv(cfg, B, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, cfg.max_seq_len, cfg.n_heads, cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _port_cache(model, key, value):
    cache = new_cache(model.cfg, key.shape[1], model.device)
    for i, layer in enumerate(cache):
        layer.key.copy_(torch.from_numpy(key[i]))
        layer.value.copy_(torch.from_numpy(value[i]))
    return cache


def test_decode_step_per_row_matches_jax(nano, port):
    """Two per-row dense steps at ragged positions (the draft's step):
    logits at 1e-5 and the whole cache after, against JAX
    ``decode_step``."""
    dec, params = nano[:2]
    target, _ = port
    key, value = _random_kv(dec.cfg, 3, seed=7)
    jcache = _jax_cache(dec, key, value)
    cache = _port_cache(target, key, value)
    pos = np.array([[3], [17], [31]], np.int32)
    for step, toks in enumerate(([[5], [60], [127]], [[9], [1], [44]])):
        toks = np.array(toks, np.int32)
        p = np.minimum(pos + step, 31)
        ref, jcache = jax_decode_step(dec, params, jcache, jnp.asarray(toks),
                                      jnp.asarray(p))
        with torch.no_grad():
            got = decode_step(target, cache, torch.from_numpy(toks),
                              torch.from_numpy(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)
    for i, layer in enumerate(cache):
        attn = jcache["stack"][f"block_{i}"]["attn"]
        np.testing.assert_allclose(layer.key.numpy(),
                                   np.asarray(attn["cached_key"]), atol=1e-5)
        np.testing.assert_allclose(layer.value.numpy(),
                                   np.asarray(attn["cached_value"]),
                                   atol=1e-5)


def test_draft_refill_matches_jax(nano, port):
    """One slot's draft row rebuilt from a 9-token context: the row
    equals JAX ``_draft_refill_impl``'s, every other row is untouched."""
    _, _, jdraft, jdparams = nano
    _, draft = port
    key, value = _random_kv(jdraft.cfg, 3, seed=11)
    context = [5, 17, 3, 9, 22, 78, 38, 38, 25]
    tokens = np.zeros((1, 32), np.int32)
    tokens[0, :len(context)] = context
    length = np.array([len(context)], np.int32)
    ref = jax_draft_refill_impl(jdraft, jdparams,
                                _jax_cache(jdraft, key, value),
                                jnp.asarray(tokens), jnp.asarray(length),
                                np.int32(1))
    cache = _port_cache(draft, key, value)
    with torch.no_grad():
        _draft_refill_impl(draft, cache, torch.from_numpy(tokens).long(),
                           torch.from_numpy(length), 1)
    attn = ref["stack"]["block_0"]["attn"]
    for got, want, orig in ((cache[0].key, attn["cached_key"], key[0]),
                            (cache[0].value, attn["cached_value"],
                             value[0])):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want)[1],
                                   atol=1e-5, rtol=0)
        for r in (0, 2):
            np.testing.assert_array_equal(got[r].numpy(), orig[r])


def test_verify_step_paged_matches_jax_and_sequential_steps(nano, port):
    """A (B, 3) verify through the page arena after a ragged prefill:
    all (B, T, V) logits against JAX ``verify_step_paged`` (1e-4, as the
    paged decode tests), and against three sequential
    ``decode_step_paged`` calls on a copy of the arena (1e-5)."""
    dec, params = nano[:2]
    target, _ = port
    prompts = PROMPTS[:3]
    n, T = len(prompts), 3
    tokens = np.zeros((n, 4), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    lengths = np.array([len(p) for p in prompts], np.int32)
    block = np.array([[7, 1, 99], [4, 4, 12], [127, 0, 3]], np.int32)
    vpos = lengths[:, None] + np.arange(T, dtype=np.int32)[None]

    jpool = JaxPagePool(dec, n, 4)
    pool = PagePool(target.cfg, n, 4, device="cpu")
    for i, p in enumerate(prompts):
        jpool.acquire(JaxRequest(id=i, prompt=p, max_new_tokens=T + 1))
        pool.acquire(Request(id=i, prompt=p, max_new_tokens=T + 1))
    jpt = jnp.asarray(jpool.page_table)
    jcache, _ = jax_prefill_impl(dec, params, jnp.asarray(tokens),
                                 jnp.asarray(lengths))
    jarena = jax_scatter_pages(dec, jpool.arena, jcache, jpt)
    ref, _ = jax_verify_step_paged(dec, params, jarena, jnp.asarray(block),
                                   jnp.asarray(vpos), jpt)
    pt = torch.from_numpy(pool.page_table)
    with torch.no_grad():
        cache, _ = _prefill_impl(target, torch.from_numpy(tokens),
                                 torch.from_numpy(lengths))
        scatter_pages(pool.arena, cache, pt)
        arena2 = copy.deepcopy(pool.arena)
        got = verify_step_paged(target, pool.arena, torch.from_numpy(block),
                                torch.from_numpy(vpos), pt)
        seq = [decode_step_paged(target, arena2,
                                 torch.from_numpy(block[:, t:t + 1]),
                                 torch.from_numpy(vpos[:, t:t + 1]), pt)
               for t in range(T)]
    assert got.shape == (n, T, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), torch.stack(seq, 1).numpy(),
                               atol=1e-5, rtol=0)


# ------------------------------------------------------------- sampled
def test_sampled_spec_stream_alone_cobatched_and_across_dispatch_sizes(port):
    """A sampled request's spec tokens depend only on (engine seed, its
    seed, step, context): alone, co-batched in another slot, and with
    three rounds a dispatch."""
    target, draft = port
    sampled = dict(prompt=PROMPTS[2], max_new_tokens=9, temperature=0.9,
                   top_k=20, seed=77)
    alone = _run_port(target, draft, [(0, sampled)])[0][0].tokens
    crowd = _run_port(target, draft, [
        (0, dict(prompt=PROMPTS[0], max_new_tokens=6)),
        (0, dict(prompt=PROMPTS[1], max_new_tokens=4, temperature=1.3,
                 seed=5)),
        (2, sampled)])[0]
    assert crowd[2].tokens == alone
    three = _run_port(target, draft, [(0, sampled)],
                      steps_per_dispatch=3)[0][0].tokens
    assert three == alone
    assert _run_port(target, draft, [(0, dict(sampled, seed=78))])[0][
        0].tokens != alone


def test_rejection_rule_is_distribution_exact():
    """At vocab 8 with fixed target p and draft q (k = 1), over 4000 seeds
    the first committed token -- the draft's proposal if accepted, else
    the residual resample -- is distributed as p: Pearson's chi-squared
    against p is below 24.32, the 0.999 quantile for 7 degrees of
    freedom; the draft's own proposals, distributed as q, are far above
    it (the test can tell the two apart)."""
    N, V = 4000, 8
    p_logits = torch.log(torch.tensor(
        [0.30, 0.20, 0.15, 0.10, 0.10, 0.08, 0.05, 0.02]))
    q_logits = torch.log(torch.tensor(
        [0.05, 0.05, 0.10, 0.30, 0.20, 0.10, 0.10, 0.10]))
    p = torch.softmax(p_logits, 0).numpy()
    temp = np.ones((N,), np.float32)
    top_k = np.zeros((N,), np.int32)
    seeds = [[(1 << 40) + 7919 * r for r in range(N)],
             [(1 << 41) + 7919 * r for r in range(N)]]
    draft_logits = q_logits.expand(N, V)
    drafts = sample_logits_rows(draft_logits,
                                [stream_seed(s, 1) for s in seeds[0]],
                                temp, top_k)
    L = torch.stack([p_logits.expand(N, V)] * 2, dim=1)
    out = _spec_accept(L, drafts[:, None], draft_logits[:, None],
                       torch.zeros((N, 1), dtype=torch.int32),
                       torch.zeros((N, 1), dtype=torch.int32),
                       torch.ones((N,), dtype=torch.bool),
                       torch.full((N,), 9, dtype=torch.int32), temp, top_k,
                       torch.full((N,), -1, dtype=torch.int32),
                       torch.ones((N,), dtype=torch.int32), seeds, 31, k=1)
    first = out[5][:, 0].numpy()

    def chi2(samples):
        counts = np.bincount(samples, minlength=V)
        return float(((counts - N * p) ** 2 / (N * p)).sum())

    assert chi2(first) < 24.32
    assert chi2(drafts.numpy()) > 10 * 24.32
    accepted = out[6].numpy()
    assert 0 < accepted.sum() < N          # both branches ran


# ----------------------------------------------------------- validation
def test_validation_matches_jax(nano, port):
    """The JAX engine's spec checks, with its error types and messages:
    verify headroom, draft/target shape mismatches, spec_k < 1, spec
    options without a draft. The port's own: spec_k + 1 above the CUDA
    kernel's MAX_T (the JAX Pallas kernel has no such limit: its engine
    takes spec_k=8)."""
    dec, params, jdraft, jdparams = nano
    target, draft = port
    sd, dsd = target.state_dict(), draft.state_dict()
    jax_kw = dict(num_slots=3, prefill_len=8, attention_kernel="pallas",
                  **PAGED)
    kw = dict(num_slots=3, prefill_len=8, device="cpu", **PAGED)
    jclient = JaxServeClient(dec, params, draft_model=jdraft,
                             draft_params=jdparams, spec_k=4, **jax_kw)
    client = ServeClient(target, sd, draft_model=draft, draft_params=dsd,
                         spec_k=4, **kw)
    for c in (jclient, client):
        with pytest.raises(ValueError, match="headroom"):
            c.submit([1, 2, 3, 4], max_new_tokens=28)
        c.submit([1, 2, 3, 4], max_new_tokens=25)       # 4 + 25 + 3 == 32
        c.shutdown()
    cases = [
        (dict(spec_k=2), "draft_model"),
        (dict(draft_params="x"), "draft_model"),
        (dict(draft_model="x"), "draft_params"),
        (dict(draft_weight_dtype="int8"), "draft_weight_dtype"),
    ]
    for extra, match in cases:
        jextra = {k: (jdraft if v == "x" and k == "draft_model" else
                      jdparams if v == "x" else v) for k, v in extra.items()}
        pextra = {k: (draft if v == "x" and k == "draft_model" else
                      dsd if v == "x" else v) for k, v in extra.items()}
        with pytest.raises(ValueError, match=match):
            JaxServeEngine(dec, params, **jax_kw, **jextra)
        with pytest.raises(ValueError, match=match):
            ServeEngine(target, sd, **kw, **pextra)
    for field, value in (("vocab_size", 64), ("max_seq_len", 16)):
        jbad = type(jdraft)(dataclasses.replace(jdraft.cfg, **{field: value}))
        bad = TransformerLM(dataclasses.replace(draft.cfg, **{field: value}),
                            device="meta")
        with pytest.raises(ValueError, match=field):
            JaxSpecDecoder(jbad, jdparams, num_slots=2, k=2,
                           target_cfg=dec.cfg)
        with pytest.raises(ValueError, match=field):
            SpecDecoder(bad, dsd, num_slots=2, k=2, target_cfg=target.cfg,
                        device="cpu")
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        JaxSpecDecoder(jdraft, jdparams, num_slots=2, k=0,
                       target_cfg=dec.cfg)
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        ServeEngine(target, sd, draft_model=draft, draft_params=dsd,
                    spec_k=0, **kw)
    # the port's own: K1 verifies at most MAX_T = 8 tokens a row
    JaxServeEngine(dec, params, draft_model=jdraft, draft_params=jdparams,
                   spec_k=8, **jax_kw).shutdown()
    with pytest.raises(ValueError, match="at most T = 8"):
        ServeEngine(target, sd, draft_model=draft, draft_params=dsd,
                    spec_k=8, attention_kernel="cuda", **kw)
    ServeEngine(target, sd, draft_model=draft, draft_params=dsd, spec_k=8,
                attention_kernel="torch", **kw).shutdown()
    ServeEngine(target, sd, draft_model=draft, draft_params=dsd, spec_k=7,
                attention_kernel="cuda", **kw).shutdown()


def test_cancel_before_the_next_dispatch_discards_the_stale_row(port):
    """A request cancelled between its activation and the next spec
    dispatch leaves the stale ledger: nothing refills its slot."""
    target, draft = port
    eng = ServeEngine(target, target.state_dict(), num_slots=2,
                      prefill_len=8, device="cpu", draft_model=draft,
                      draft_params=draft.state_dict(), spec_k=2, **PAGED)
    eng.prefill([Request(id=0, prompt=[1, 2, 3], max_new_tokens=6),
                 Request(id=1, prompt=[4, 5], max_new_tokens=6)])
    assert eng.spec.stale == [0, 1]
    eng.cancel(0)
    assert eng.spec.stale == [1]
    eng.step()
    assert eng.spec.refills == 1 and eng.spec.stale == []
    eng.shutdown()
    assert eng.spec is None
