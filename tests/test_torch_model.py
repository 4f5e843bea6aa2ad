"""The port's model (``ray_lightning_tpu_torch/models``) against the JAX package.

Same weights (the flax tree carried across by ``interop.load_flax_params``)
and the same numpy tokens, in f32 on the CPU: the plain forward's
logits, and the serving split -- ragged prefill, page scatter, then
``decode_step_paged`` steps through the page arena, teacher-forced with
the JAX greedy tokens -- at atol 1e-4 (f32 matmuls summed in another
order, through two layers and the tied head). The nano model and shapes
are the serve family's (vocab 128, max_seq_len 32, unrolled).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import TransformerLM as JaxLM
from ray_lightning_tpu.models import gpt2_config as jax_gpt2_config
from ray_lightning_tpu.models import latch_eos as jax_latch_eos
from ray_lightning_tpu.models.generate import \
    _prefill_impl as jax_prefill_impl
from ray_lightning_tpu.models.generate import \
    decode_step_paged as jax_decode_step_paged
from ray_lightning_tpu.models.quant import \
    quantize_params as jax_quantize_params
from ray_lightning_tpu.serve.pages import PagePool as JaxPagePool
from ray_lightning_tpu.serve.pages import scatter_pages as jax_scatter_pages
from ray_lightning_tpu.serve.request import Request as JaxRequest
from ray_lightning_tpu_torch.interop import (flax_state_dict,
                                             load_flax_params)
from ray_lightning_tpu_torch.models import (PagedKV, TransformerLM,
                                            gpt2_config, latch_eos,
                                            new_arena, row_seed,
                                            sample_logits_rows)
from ray_lightning_tpu_torch.models.generate import (_prefill_impl,
                                                    decode_step_paged)
from ray_lightning_tpu_torch.serve.pages import PagePool, scatter_pages
from ray_lightning_tpu_torch.serve.request import Request

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

MK = dict(vocab_size=128, max_seq_len=32)
PROMPTS = [[5, 17, 3, 9], [9, 2, 44], [42, 7], [1]]


def port_model(params, **overrides):
    """The port's nano model in f32 on the CPU, filled from ``params``."""
    cfg = gpt2_config("nano", dtype=torch.float32, **MK, **overrides)
    return load_flax_params(TransformerLM(cfg, device="cpu"), params)


@pytest.fixture(scope="module")
def nano(serve_nano_family):
    return serve_nano_family[:2]


def paged_logits(dec, params, prompts, *, kv_dtype=None, page_size=4,
                 steps=3, attention_kernel="torch", forced=None,
                 weight_dtype=None, group_size=None):
    """The serving split in both frameworks on the same prompts: ragged
    prefill, page scatter, then ``steps`` ``decode_step_paged`` calls fed
    the JAX greedy tokens (or ``forced`` (steps, B) tokens). With
    ``weight_dtype`` both sides quantize the weights first (JAX
    ``quantize_params``, the port's ``quantize_weights``). Returns
    ``(jax_logits, port_logits)``, lists of (B, V) arrays (the prefill's
    last logits first)."""
    n = len(prompts)
    width = max(len(p) for p in prompts)
    tokens = np.zeros((n, width), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    lengths = np.array([len(p) for p in prompts], np.int32)

    # JAX side: the XLA page-native path of the decode-mode model
    jpool = JaxPagePool(dec, n, page_size, kv_dtype=kv_dtype)
    for i, p in enumerate(prompts):
        jpool.acquire(JaxRequest(id=i, prompt=p,
                                 max_new_tokens=steps + 1))
    jpt = jnp.asarray(jpool.page_table)
    jparams = (params if weight_dtype is None else
               jax_quantize_params(params, weight_dtype, group_size))
    cache, last = jax_prefill_impl(dec, jparams, jnp.asarray(tokens),
                                   jnp.asarray(lengths))
    arena = jax_scatter_pages(dec, jpool.arena, cache, jpt)
    jax_out = [np.asarray(last)]
    feed = []
    pos = lengths.copy()
    for s in range(steps):
        cur = (np.asarray(forced[s]) if forced is not None
               else jax_out[-1].argmax(-1).astype(np.int32))
        feed.append(cur)
        logits, arena = jax_decode_step_paged(
            dec, jparams, arena, jnp.asarray(cur[:, None]),
            jnp.asarray(pos[:, None]), jpt)
        jax_out.append(np.asarray(logits))
        pos = pos + 1

    # the port, fed the same tokens
    model = port_model(params, attention_kernel=attention_kernel)
    if weight_dtype is not None:
        model.quantize_weights(weight_dtype, group_size)
    pool = PagePool(model.cfg, n, page_size, kv_dtype=kv_dtype,
                    device="cpu")
    for i, p in enumerate(prompts):
        pool.acquire(Request(id=i, prompt=p, max_new_tokens=steps + 1))
    pt = torch.from_numpy(pool.page_table)
    port_out = []
    with torch.no_grad():
        cache, last = _prefill_impl(model, torch.from_numpy(tokens),
                                    torch.from_numpy(lengths))
        scatter_pages(pool.arena, cache, pt)
        port_out.append(last.numpy())
        pos = torch.from_numpy(lengths)
        for cur in feed:
            logits = decode_step_paged(model, pool.arena,
                                       torch.from_numpy(cur)[:, None],
                                       pos[:, None], pt)
            port_out.append(logits.numpy())
            pos = pos + 1
    return jax_out, port_out


@pytest.mark.parametrize("layout", ["unrolled", "scanned"])
def test_forward_logits_match_jax(layout):
    """The plain forward from both param layouts: logits at 1e-4."""
    mk = dict(MK, dtype=jnp.float32, scan_layers=layout == "scanned")
    jmodel = JaxLM(jax_gpt2_config("nano", **mk))
    params = jmodel.init(jax.random.PRNGKey(3),
                         np.zeros((2, 4), np.int32))["params"]
    tokens = np.random.default_rng(0).integers(0, 128, size=(3, 20))
    ref = np.asarray(jmodel.apply({"params": params}, tokens))
    with torch.no_grad():
        out = port_model(params)(torch.from_numpy(tokens)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_bf16_embedding_and_tied_head_round_like_flax():
    """bf16 compute (the serving default): the token embedding rounds the
    looked-up f32 row to bf16 exactly as flax's ``Embed(dtype=bf16)``
    (bitwise), the tied head differs from ``Embed.attend`` by at most one
    bf16 ulp of each output (f32 accumulation order decides the last
    rounding), and the whole forward's bf16 logits stay within 4 bf16
    ulps of the largest logit (the frameworks round at other points
    inside LayerNorm, GELU and the matmuls)."""
    from flax import linen as fnn
    jmodel = JaxLM(jax_gpt2_config("nano", **MK, scan_layers=False))
    params = jmodel.init(jax.random.PRNGKey(3),
                         np.zeros((2, 4), np.int32))["params"]
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128, size=(3, 20))
    emb = np.array(params["wte"]["embedding"])
    embed = fnn.Embed(128, 128, dtype=jnp.bfloat16)
    ref = np.asarray(embed.apply({"params": {"embedding": emb}}, tokens),
                     np.float32)
    out = torch.from_numpy(emb)[torch.from_numpy(tokens)].to(
        torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(out, ref)

    x = rng.normal(size=(3, 20, 128)).astype(np.float32)
    ref = np.asarray(embed.apply({"params": {"embedding": emb}},
                                 jnp.asarray(x, jnp.bfloat16),
                                 method=fnn.Embed.attend), np.float32)
    model = load_flax_params(
        TransformerLM(gpt2_config("nano", **MK), device="cpu"), params)
    with torch.no_grad():
        out = torch.nn.functional.linear(
            torch.from_numpy(x).to(torch.bfloat16),
            model.wte.weight.to(torch.bfloat16)).float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(out - ref) <= ulp)

    ref = np.asarray(jmodel.apply({"params": params}, tokens))
    with torch.no_grad():
        out = model(torch.from_numpy(tokens)).numpy()
    top = np.exp2(np.floor(np.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(out, ref, atol=4 * top, rtol=0)


def test_load_flax_params_scanned_equals_unrolled():
    """A scanned tree and its unrolled twin fill identical weights."""
    from ray_lightning_tpu.models.transformer import unstack_scan_params
    mk = dict(MK, dtype=jnp.float32, scan_layers=True)
    params = JaxLM(jax_gpt2_config("nano", **mk)).init(
        jax.random.PRNGKey(1), np.zeros((1, 4), np.int32))["params"]
    a = port_model(params).state_dict()
    b = port_model(unstack_scan_params(params)).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_load_flax_params_is_strict(nano):
    _, params = nano
    sd = flax_state_dict(params)
    assert sd["stack.blocks.0.attn.qkv.weight"].shape == (3 * 128, 128)
    broken = jax.tree_util.tree_map(lambda x: x, params)
    broken = dict(broken, stack=dict(broken["stack"]))
    del broken["stack"]["block_1"]
    with pytest.raises(RuntimeError, match="Missing key"):
        port_model(broken)


def test_qkv_split_matches_dense_general(nano):
    """The (d, 3, H, head_dim) DenseGeneral kernel becomes rows ordered
    (3, H, head_dim): q, k and v come out where flax puts them."""
    _, params = nano
    blk = params["block_0"] if "block_0" in params else \
        params["stack"]["block_0"]
    kernel = np.asarray(blk["attn"]["qkv"]["kernel"])      # (d, 3, H, hd)
    bias = np.asarray(blk["attn"]["qkv"]["bias"])          # (3, H, hd)
    x = np.random.default_rng(1).normal(size=(2, 5, 128)).astype(np.float32)
    ref = np.einsum("btd,dshk->btshk", x, kernel) + bias
    attn = port_model(params).stack.blocks[0].attn
    with torch.no_grad():
        out = attn.qkv(torch.from_numpy(x)).view(2, 5, 3, 4, 32).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("attention_kernel", ["torch", "cuda"])
def test_prefill_and_decode_paged_logits_match_jax(nano, attention_kernel):
    """Ragged prefill (last logits at each row's length − 1) and three
    teacher-forced page-native decode steps, at 1e-4. ``"cuda"`` runs
    the kernel's wrapper, which takes the plain version on the CPU."""
    dec, params = nano
    jax_out, port_out = paged_logits(dec, params, PROMPTS,
                                     attention_kernel=attention_kernel)
    assert len(jax_out) == len(port_out) == 4
    for j, p in zip(jax_out, port_out):
        np.testing.assert_allclose(p, j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("page_size", [4, 8, 16])
def test_prefill_last_logits_ignore_the_pad_tail(nano, page_size):
    """A short row's prefill logits equal the plain forward of its own
    prompt: causality keeps the pad tail out, at any page size."""
    _, params = nano
    model = port_model(params)
    with torch.no_grad():
        _, last = _prefill_impl(
            model, torch.tensor([[9, 2, 44, 0, 0, 0], [1, 0, 0, 0, 0, 0]]),
            torch.tensor([3, 1]))
        for row, prompt in enumerate(([9, 2, 44], [1])):
            alone = model(torch.tensor([prompt]))[0, -1]
            torch.testing.assert_close(last[row], alone, atol=1e-5, rtol=0)


def test_masked_rows_write_only_the_sink(nano):
    """A row whose page-table row is −1 (write-masked) lands its K/V in
    the sink page: no page a request owns changes."""
    _, params = nano
    model = port_model(params)
    arena = new_arena(model.cfg, num_pages=6, page_size=4, quantized=False,
                      device="cpu")
    before = [kv.k[:kv.num_pages].clone() for kv in arena]
    pt = torch.full((2, 8), -1, dtype=torch.int32)
    with torch.no_grad():
        decode_step_paged(model, arena, torch.tensor([[3], [4]]),
                          torch.tensor([[5], [9]], dtype=torch.int32), pt)
    for kv, old in zip(arena, before):
        assert isinstance(kv, PagedKV)
        assert torch.equal(kv.k[:kv.num_pages], old)
        assert torch.count_nonzero(kv.k[kv.num_pages]) > 0


def test_int8_write_requantizes_the_page(nano):
    """int8 arenas: a token write re-derives its page's per-head scales
    and codes (read-modify-requantize), and only that page changes."""
    _, params = nano
    model = port_model(params)
    arena = new_arena(model.cfg, num_pages=6, page_size=4, quantized=True,
                      device="cpu")
    pt = torch.tensor([[2, -1, -1, -1, -1, -1, -1, -1]], dtype=torch.int32)
    with torch.no_grad():
        decode_step_paged(model, arena, torch.tensor([[3]]),
                          torch.tensor([[1]], dtype=torch.int32), pt)
    kv = arena[0]
    assert kv.k.dtype == torch.int8
    changed = [p for p in range(kv.num_pages)
               if torch.count_nonzero(kv.k[p])]
    assert changed == [2]
    assert torch.all(kv.k[2, 1].abs().amax(-1) == 127)
    assert not torch.equal(kv.k_scale[2], torch.ones_like(kv.k_scale[2]))


def test_latch_eos_matches_jax():
    rng = np.random.default_rng(5)
    nxt = rng.integers(0, 6, size=16).astype(np.int32)
    done = rng.random(16) < 0.3
    eos = rng.integers(-1, 6, size=16).astype(np.int32)
    ref = jax_latch_eos(jnp.asarray(nxt), jnp.asarray(done),
                        jnp.asarray(eos))
    out = latch_eos(torch.from_numpy(nxt), torch.from_numpy(done),
                    torch.from_numpy(eos))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))


def test_greedy_sampling_takes_the_first_maximum():
    """Ties in argmax go to the first index in both frameworks."""
    logits = np.zeros((3, 10), np.float32)
    logits[0, [2, 7]] = 1.0
    logits[1, [0, 9]] = 3.0
    logits[2, :] = -1.0
    out = sample_logits_rows(torch.from_numpy(logits), [0] * 3,
                             [0.0] * 3, [0] * 3)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jnp.argmax(logits, axis=-1)))


def test_sampling_streams_are_keyed_by_seed_and_step():
    """A sampled row depends only on (engine seed, request seed, step):
    the same seed draws the same token in any row, top_k keeps the draw
    among the k largest logits."""
    logits = torch.from_numpy(
        np.random.default_rng(2).normal(size=(4, 64)).astype(np.float32))
    seeds = [row_seed(0, 11, s) for s in range(4)]
    assert len(set(seeds)) == 4 and row_seed(1, 11, 0) != seeds[0]
    a = sample_logits_rows(logits, seeds, [1.0] * 4, [0] * 4)
    flipped = sample_logits_rows(logits.flip(0), seeds[::-1], [1.0] * 4,
                                 [0] * 4)
    assert torch.equal(a, flipped.flip(0))
    k = sample_logits_rows(logits, seeds, [5.0] * 4, [3] * 4)
    top3 = logits.topk(3, dim=-1).indices
    assert all(int(k[r]) in top3[r].tolist() for r in range(4))


def test_model_defaults_to_the_card():
    """``device=None`` means cuda: without a card, building raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(dataclasses.replace(gpt2_config("nano", **MK)))
