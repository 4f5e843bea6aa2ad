"""Decode outside the engine (``ray_lightning_tpu_torch/models/generate.py``) against the JAX package.

The serve family's nano model (vocab 128, max_seq_len 32, f32,
unrolled), the JAX weights carried across, the same numpy prompts on
both sides. Greedy ``generate()`` (uniform and ragged prompts, with and
without an eos, one new token) and ``generate_full_scan()`` must give
JAX's tokens exactly; ``prefill()``'s cache and last logits and
``verify_step``'s logits agree with JAX's to 1e-5 absolute (f32 sums in
another order, two layers and the tied head; logits of magnitude ~1).
Sampled streams cannot match JAX's threefry bits: a sampled
``generate()`` is held to the vocab, to its seed, and to its top-k set.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.generate import generate as jax_generate
from ray_lightning_tpu.models.generate import \
    generate_full_scan as jax_generate_full_scan
from ray_lightning_tpu.models.generate import prefill as jax_prefill
from ray_lightning_tpu.models.generate import verify_step as jax_verify_step
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import (TransformerLM, generate,
                                            generate_full_scan, gpt2_config,
                                            prefill, sample_logits,
                                            verify_step)
from ray_lightning_tpu_torch.serve import ServeClient

# the module: the package's ``generate`` attribute is the function
generate_mod = importlib.import_module("ray_lightning_tpu_torch.models.generate")

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

MK = dict(vocab_size=128, max_seq_len=32)
PROMPTS = [[5, 17, 3, 9], [9, 2, 44], [42, 7], [1]]
UNIFORM = [[5, 17, 3, 9], [9, 2, 44, 1], [3, 3, 3, 3]]
N = 6
# f32 logits and caches against JAX's (see the module docstring)
ATOL = 1e-5


@pytest.fixture(scope="module")
def nano(serve_nano_family):
    return serve_nano_family[:2]


@pytest.fixture(scope="module")
def port(nano):
    _, params = nano
    cfg = gpt2_config("nano", dtype=torch.float32, **MK)
    return load_flax_params(TransformerLM(cfg, device="cpu"), params)


def _batch(prompts):
    P = max(len(p) for p in prompts)
    batch = np.zeros((len(prompts), P), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    return batch, np.array([len(p) for p in prompts], np.int32)


@pytest.fixture(scope="module")
def free_eos(nano):
    """An eos id request 0 samples as its third ragged greedy token."""
    dec, params = nano
    batch, lengths = _batch(PROMPTS)
    out = np.asarray(jax_generate(
        dec, params, batch, N, jax.random.PRNGKey(0), temperature=0.0,
        prompt_lengths=lengths))
    return int(out[0, lengths[0] + 2])


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("with_eos", [False, True], ids=["", "eos"])
def test_greedy_generate_matches_jax(nano, port, free_eos, ragged,
                                     with_eos):
    """Greedy tokens, the whole (B, P + N) buffer, equal JAX
    ``generate()``'s: shared-index steps for uniform prompts, per-row
    steps for ragged ones, eos latched and repeated."""
    dec, params = nano
    batch, lengths = _batch(PROMPTS if ragged else UNIFORM)
    kw = dict(temperature=0.0,
              prompt_lengths=lengths if ragged else None,
              eos_id=free_eos if with_eos else None)
    ref = np.asarray(jax_generate(dec, params, batch, N,
                                  jax.random.PRNGKey(0), **kw))
    out = generate(port, None, batch, N, 0, **kw)
    assert out.dtype == torch.int32
    assert out.shape == (len(batch), batch.shape[1] + N)
    np.testing.assert_array_equal(out.numpy(), ref)
    if with_eos and ragged:
        L = lengths[0]
        assert (out[0, L + 2:L + N] == free_eos).all()


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_one_new_token_returns_after_the_prefill(nano, port, ragged):
    dec, params = nano
    batch, lengths = _batch(PROMPTS if ragged else UNIFORM)
    lens = lengths if ragged else None
    ref = np.asarray(jax_generate(dec, params, batch, 1,
                                  jax.random.PRNGKey(0), temperature=0.0,
                                  prompt_lengths=lens))
    out = generate(port, None, batch, 1, 0, temperature=0.0,
                   prompt_lengths=lens)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_full_scan_matches_jax(nano, port, free_eos, ragged):
    """``generate_full_scan``: the prompt teacher-forced through the
    one-token step, every row filled to P + N, eos latched only past a
    row's prompt -- JAX's tokens exactly; ``use_prefill=False`` routes
    to it."""
    dec, params = nano
    batch, lengths = _batch(PROMPTS if ragged else UNIFORM)
    kw = dict(temperature=0.0, prompt_lengths=lengths if ragged else None,
              eos_id=free_eos)
    ref = np.asarray(jax_generate_full_scan(dec, params, batch, N,
                                            jax.random.PRNGKey(0), **kw))
    out = generate_full_scan(port, None, batch, N, 0, **kw)
    np.testing.assert_array_equal(out.numpy(), ref)
    routed = generate(port, None, batch, N, 0, use_prefill=False, **kw)
    np.testing.assert_array_equal(routed.numpy(), ref)


def test_use_prefill_false_calls_the_full_scan(port, monkeypatch):
    seen = []
    real = generate_mod.generate_full_scan

    def spy(*args, **kwargs):
        seen.append(args[3])
        return real(*args, **kwargs)
    monkeypatch.setattr(generate_mod, "generate_full_scan", spy)
    batch, _ = _batch(UNIFORM)
    generate(port, None, batch, 3, 0, temperature=0.0, use_prefill=False)
    assert seen == [3]


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_prefill_cache_and_logits_match_jax(nano, port, ragged):
    """``prefill()``: the last logits at each row's length - 1 and every
    layer's K/V cache over the whole max_seq_len row (zeros past P)."""
    dec, params = nano
    batch, lengths = _batch(PROMPTS if ragged else UNIFORM)
    lens = lengths if ragged else None
    jcache, jlast = jax_prefill(dec, params, batch, lens)
    cache, last = prefill(port, None, batch, lens)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL,
                               rtol=0)
    for i, kv in enumerate(cache):
        attn = jcache["stack"][f"block_{i}"]["attn"]
        assert kv.index == batch.shape[1] == int(attn["cache_index"])
        np.testing.assert_allclose(kv.key.numpy(),
                                   np.asarray(attn["cached_key"]),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(kv.value.numpy(),
                                   np.asarray(attn["cached_value"]),
                                   atol=ATOL, rtol=0)


def test_verify_step_matches_jax(nano, port):
    """The dense verify: after a ragged prefill, each row scores its
    current token and 3 proposals at its own positions under the
    block-causal mask; the (B, 4, V) logits equal JAX ``verify_step``'s,
    and offset j's equal what j+1 sequential one-token steps give."""
    dec, params = nano
    batch, lengths = _batch(PROMPTS)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128, size=(len(PROMPTS), 4)).astype(np.int32)
    vpos = (lengths[:, None] + np.arange(4)[None]).astype(np.int32)
    jcache, _ = jax_prefill(dec, params, batch, lengths)
    jl, _ = jax_verify_step(dec, params, jcache, tokens, vpos)
    cache, _ = prefill(port, None, batch, lengths)
    with torch.no_grad():
        logits = verify_step(port, cache, torch.from_numpy(tokens),
                             torch.from_numpy(vpos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    cache, _ = prefill(port, None, batch, lengths)
    with torch.no_grad():
        for j in range(4):
            one = generate_mod.decode_step(
                port, cache, torch.from_numpy(tokens[:, j:j + 1]),
                torch.from_numpy(vpos[:, j:j + 1]))
            np.testing.assert_allclose(one.numpy(), logits[:, j].numpy(),
                                       atol=ATOL, rtol=0)


def test_sampled_generate_is_in_vocab_and_repeats_from_its_seed(port):
    batch, lengths = _batch(PROMPTS)
    kw = dict(temperature=0.9, top_k=20, prompt_lengths=lengths)
    a = generate(port, None, batch, N, 123, **kw)
    b = generate(port, None, batch, N, 123, **kw)
    c = generate(port, None, batch, N, torch.Generator().manual_seed(123),
                 **kw)
    d = generate(port, None, batch, N, 124, **kw)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, d)
    assert int(a.min()) >= 0 and int(a.max()) < 128
    full = generate_full_scan(port, None, batch, N, 5, **kw)
    assert torch.equal(full, generate_full_scan(port, None, batch, N, 5,
                                                **kw))
    with pytest.raises(TypeError, match="rng"):
        generate(port, None, batch, N, None, **kw)


def test_sample_logits_top_k_and_greedy():
    """Greedy is the first argmax; a top-k draw never leaves the k
    largest (ties with the k-th kept); temperature scales the draw."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0, -1.0, 2.0]]).repeat(64, 1)
    assert sample_logits(logits, None, 0.0).tolist() == [1] * 64
    draws = sample_logits(logits, gen, 5.0, top_k=2)
    assert set(draws.tolist()) <= {1, 3}
    draws = sample_logits(logits, gen, 50.0, top_k=3)
    assert set(draws.tolist()) <= {1, 3, 5} and 5 in draws.tolist()
    assert sample_logits(logits, 7, 1.0).dtype == torch.int32


def test_params_state_dict_and_the_model_unchanged(port):
    """``params`` given as a state dict runs those weights without
    touching the model's own."""
    batch, lengths = _batch(PROMPTS)
    own = generate(port, None, batch, N, 0, temperature=0.0,
                   prompt_lengths=lengths)
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    same = generate(port, sd, batch, N, 0, temperature=0.0,
                    prompt_lengths=lengths)
    assert torch.equal(own, same)
    before = port.wte.weight.clone()
    sd["wte.weight"] = torch.flip(sd["wte.weight"], dims=[0])
    other = generate(port, sd, batch, N, 0, temperature=0.0,
                     prompt_lengths=lengths)
    assert not torch.equal(own, other)
    assert torch.equal(port.wte.weight, before)


def test_over_length_and_bad_lengths_raise(port):
    batch, lengths = _batch(PROMPTS)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        generate(port, None, batch, 29, 0, temperature=0.0)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        generate_full_scan(port, None, batch, 29, 0, temperature=0.0)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        prefill(port, None, np.zeros((1, 33), np.int32))
    with pytest.raises(ValueError, match="prompt_lengths"):
        generate(port, None, batch, 2, 0, temperature=0.0,
                 prompt_lengths=[4, 3, 2, 5])
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(port, None, batch, 0, 0, temperature=0.0)


@pytest.mark.parametrize("layout", [{}, dict(page_size=4),
                                    dict(page_size=4, page_native=True)],
                         ids=["dense", "view", "page-native"])
def test_engine_greedy_rows_equal_generate(port, free_eos, layout):
    """Four ragged requests through 3 slots with staggered arrivals: every
    engine layout's completions are the ragged ``generate()`` windows,
    cut after the first eos (the port's ``tests/test_serve.py``
    interleaved case, with an eos)."""
    batch, lengths = _batch(PROMPTS)
    ref = generate(port, None, batch, N, 0, temperature=0.0,
                   prompt_lengths=lengths, eos_id=free_eos).numpy()
    client = ServeClient(port, port.state_dict(), num_slots=3,
                         prefill_len=8, device="cpu", **layout)
    out = client.serve_trace([
        (t, dict(prompt=p, max_new_tokens=N, eos_id=free_eos))
        for t, p in zip((0, 0, 3, 5), PROMPTS)])
    for rid, L in enumerate(lengths):
        window = [int(t) for t in ref[rid, L:L + N]]
        if free_eos in window:
            window = window[:window.index(free_eos) + 1]
        assert out[rid].tokens == window, rid
    assert out[0].finish_reason == "eos"


def test_quantized_model_generate_equals_the_quantized_dense_engine(port):
    """A model quantized in place (int8, the plain fused matmul) generates
    the greedy tokens the dense engine serves with ``weight_dtype="int8"``
    (the engine quantizes its own copy to the same codes)."""
    batch, lengths = _batch(PROMPTS)
    model = TransformerLM(port.cfg, device="cpu")
    model.load_state_dict(port.state_dict())
    model.quantize_weights("int8")
    out = generate(model, None, batch, N, 0, temperature=0.0,
                   prompt_lengths=lengths).numpy()
    client = ServeClient(port, port.state_dict(), num_slots=4,
                         prefill_len=8, device="cpu", weight_dtype="int8")
    served = client.serve_trace([(0, dict(prompt=p, max_new_tokens=N))
                                 for p in PROMPTS])
    for rid, L in enumerate(lengths):
        assert served[rid].tokens == out[rid, L:L + N].tolist(), rid
