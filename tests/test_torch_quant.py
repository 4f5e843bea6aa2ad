"""The port's weight quantization and quantized serving against the JAX package.

- Codes and scales of every quantized leaf of the serve family's nano
  model (vocab 128, max_seq_len 32, f32, unrolled), int8 and int4 at
  group size 8, are byte-equal to JAX ``quantize_params``; so is a qkv
  leaf at GPT-2 widths, (768, 3, 12, 64), whose 64 int8 scales are shared
  by all 36 heads.
- The plain ``quantized_matmul`` against JAX ``quantized_matmul`` in
  interpret mode: int8/int4 x dense/transposed x f32/bf16, and odd N. The
  tolerances are f32 1e-5 x max(1, max|ref|) (the f32 sums run in another
  order) and bf16 one ulp of the largest magnitude, 2**-7 x max(1,
  max|ref|) (the operands are the same bf16 values, the f32 sums differ
  in order and can flip one output rounding). Not bitwise: JAX's own
  bitwise pins of its kernel fail on this jax.
- ``ServeClient(..., weight_dtype=, matmul_kernel=)`` emits the greedy
  tokens of the JAX page-native engine with both Pallas kernels on the
  suite's staggered trace; where a token differs, the JAX top-2 margin
  there is below 1e-5 and the teacher-forced logits agree to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.pallas_matmul import \
    quantized_matmul as jax_quantized_matmul
from ray_lightning_tpu.models.quant import pack_int4 as jax_pack_int4
from ray_lightning_tpu.models.quant import quantize_params as jax_quantize
from ray_lightning_tpu.models.quant import unpack_int4 as jax_unpack_int4
from ray_lightning_tpu.serve import ServeClient as JaxServeClient
from ray_lightning_tpu_torch import interop
from ray_lightning_tpu_torch.interop import (flax_layout, flax_weights,
                                             load_flax_params,
                                             load_flax_quantized)
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.models import quantized_matmul as qmm
from ray_lightning_tpu_torch.models.quant import (DEFAULT_GROUP_SIZE,
                                                  QTensor,
                                                  dequantize_params,
                                                  is_quantized, matmul_view,
                                                  pack_int4, param_bytes,
                                                  quantize_params,
                                                  unpack_int4)
from ray_lightning_tpu_torch.serve import ServeClient, ServeEngine
from test_torch_model import paged_logits

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

GS = 8      # the serve-family nano group size (divides head_dim 32)
PROMPTS = [[5, 17, 3, 9], [9, 2, 44], [42, 7], [1]]
TRACE = [
    (0, dict(prompt=PROMPTS[0], max_new_tokens=6)),
    (0, dict(prompt=PROMPTS[1], max_new_tokens=6)),
    (3, dict(prompt=PROMPTS[2], max_new_tokens=6)),
    (5, dict(prompt=PROMPTS[3], max_new_tokens=6)),
]
PAGED = dict(page_size=4, page_native=True)
BF16_ULP = 2.0 ** -7


def _group(weight_dtype):
    return GS if weight_dtype == "int4" else None


def _quant_kw(weight_dtype):
    kw = dict(weight_dtype=weight_dtype)
    if weight_dtype == "int4":
        kw["weight_group_size"] = GS
    return kw


@pytest.fixture(scope="module")
def nano(serve_nano_family):
    return serve_nano_family[:2]


@pytest.fixture(scope="module")
def port(nano):
    _, params = nano
    cfg = gpt2_config("nano", vocab_size=128, max_seq_len=32,
                      dtype=torch.float32)
    return load_flax_params(TransformerLM(cfg, device="cpu"), params)


def _fresh(port, **overrides):
    """A copy of the port's nano model (its own weights to quantize)."""
    model = TransformerLM(dataclasses.replace(port.cfg, **overrides),
                          device="cpu")
    model.load_state_dict(port.state_dict())
    return model


def _assert_same_bytes(jleaf, qt: QTensor, name):
    assert (qt.bits, qt.group_size, qt.shape) == (
        jleaf.bits, jleaf.group_size, tuple(jleaf.shape)), name
    assert str(qt.dtype).split(".")[-1] == np.dtype(jleaf.dtype).name, name
    for mine, theirs in ((qt.q, jleaf.q), (qt.scale, jleaf.scale)):
        theirs = np.asarray(theirs)
        assert mine.shape == theirs.shape, name
        assert mine.numpy().dtype == theirs.dtype, name
        assert mine.numpy().tobytes() == theirs.tobytes(), name


# ------------------------------------------------------------- packing
def test_pack_unpack_match_jax_over_all_bytes():
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    mine = unpack_int4(torch.from_numpy(packed))
    theirs = np.asarray(jax_unpack_int4(jnp.asarray(packed)))
    assert mine.dtype == torch.int8 and mine.numpy().tobytes() == \
        theirs.tobytes()
    assert pack_int4(mine).numpy().tobytes() == packed.tobytes()
    codes = np.asarray(theirs)
    assert pack_int4(torch.from_numpy(codes)).numpy().tobytes() == \
        np.asarray(jax_pack_int4(jnp.asarray(codes))).tobytes()


# ---------------------------------------------------- codes and scales
@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_codes_and_scales_byte_equal_to_jax(nano, port, weight_dtype):
    """Every quantized leaf of the nano model (both embeddings, qkv, out,
    up, down of each layer) has JAX's codes and scales, byte for byte;
    biases and LayerNorm vectors stay f32 in both."""
    _, params = nano
    jq = jax_quantize(params, weight_dtype, group_size=_group(weight_dtype))
    mine = quantize_params(flax_weights(port), weight_dtype,
                           _group(weight_dtype))
    seen = set()
    for name, leaf in interop._flax_leaves(jq):
        if interop._is_quantized_leaf(leaf):
            _assert_same_bytes(leaf, mine[name], name)
            seen.add(name)
    assert seen == set(mine) and len(seen) == 2 + 4 * port.cfg.n_layers


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_qkv_leaf_at_gpt2_widths(weight_dtype):
    """GPT-2-small's qkv kernel (768, 3, 12, 64), quantized from the
    port's (2304, 768) weight through its flax view: int8 keeps 64
    head_dim scales shared by all 3·12 heads (not 2304 row scales), int4
    groups run along head_dim; both byte-equal to JAX."""
    rng = np.random.default_rng(11)
    flax_k = (rng.standard_normal((768, 3, 12, 64)) * 0.02).astype(
        np.float32)
    weight = torch.from_numpy(flax_k.reshape(768, -1).T.copy())
    name = "stack.blocks.0.attn.qkv.weight"
    view = flax_layout(name, weight, n_heads=12)
    assert tuple(view.shape) == (768, 3, 12, 64)
    mine = quantize_params({name: view}, weight_dtype,
                           _group(weight_dtype))[name]
    theirs = jax_quantize({"kernel": flax_k}, weight_dtype,
                          group_size=_group(weight_dtype))["kernel"]
    _assert_same_bytes(theirs, mine, name)
    if weight_dtype == "int8":
        assert tuple(mine.scale.shape) == (1, 1, 1, 64)


def test_quantize_refusals():
    w = {"k": torch.randn(8, 12)}
    with pytest.raises(ValueError, match="weight_dtype"):
        quantize_params(w, "int2")
    with pytest.raises(ValueError, match="int8 or 'int4'|weight_dtype="):
        quantize_params(w, None)
    with pytest.raises(ValueError, match="group_size is an int4 option"):
        quantize_params(w, "int8", 4)
    with pytest.raises(ValueError, match="even integer"):
        quantize_params(w, "int4", 3)
    with pytest.raises(ValueError, match="must divide"):
        quantize_params(w, "int4", 8)
    q = quantize_params(w, "int4", 4)
    assert is_quantized(q) and not is_quantized(w)
    with pytest.raises(ValueError, match="already quantized"):
        quantize_params(q, "int8")
    assert DEFAULT_GROUP_SIZE == 64
    assert quantize_params({"k": torch.randn(4, 128)}, "int4")[
        "k"].group_size == 64


def test_bias_and_vectors_stay_and_roundtrip_bounds():
    """Biases (any ndim) and vectors stay as they are; dequantized
    weights sit within half a step of their channel or group absmax."""
    g = torch.Generator().manual_seed(0)
    params = {"a.weight": torch.randn(16, 32, generator=g),
              "a.bias": torch.randn(3, 32, generator=g),
              "ln.weight": torch.randn(32, generator=g)}
    for weight_dtype, step in (("int8", 254.0), ("int4", 14.0)):
        q = quantize_params(params, weight_dtype,
                            8 if weight_dtype == "int4" else None)
        assert q["a.bias"] is params["a.bias"]
        assert q["ln.weight"] is params["ln.weight"]
        w = params["a.weight"]
        deq = dequantize_params(q)["a.weight"]
        if weight_dtype == "int8":
            bound = w.abs().amax(dim=0, keepdim=True) / step
        else:
            bound = w.reshape(16, 4, 8).abs().amax(-1, keepdim=True).expand(
                16, 4, 8).reshape(16, 32) / step
        assert bool(((deq - w).abs() <= bound * (1 + 1e-6)).all())


def test_param_bytes_and_matmul_view():
    w = torch.randn(64, 3, 2, 16)
    q8 = quantize_params({"k": w}, "int8")["k"]
    assert param_bytes({"k": q8}) == 64 * 96 + 16 * 4
    assert param_bytes({"k": w}) == 64 * 96 * 4
    codes, scales, K, N = matmul_view(q8)
    assert (tuple(codes.shape), tuple(scales.shape), K, N) == (
        (64, 96), (1, 16), 64, 96)
    assert codes.data_ptr() == q8.q.data_ptr()          # a view, no copy
    q4 = quantize_params({"k": w}, "int4", 8)["k"]
    assert param_bytes({"k": q4}) == 64 * 48 + 64 * 12 * 4
    codes, scales, K, N = matmul_view(q4)
    assert (tuple(codes.shape), tuple(scales.shape)) == ((64, 48), (64, 12))
    e4 = quantize_params({"e": torch.randn(257, 64)}, "int4", 8)["e"]
    codes, scales, K, N = matmul_view(e4, transpose=True)
    assert (tuple(codes.shape), tuple(scales.shape), K, N) == (
        (257, 32), (257, 8), 64, 257)


# ------------------------------------------------- carrying JAX's tree
@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_carry_jax_quantized_tree_across(nano, port, weight_dtype):
    """``load_flax_quantized`` takes JAX's quantized tree as it is: the
    same codes as the port quantizing for itself, and the same logits."""
    _, params = nano
    jq = jax_quantize(params, weight_dtype, group_size=_group(weight_dtype))
    carried = load_flax_quantized(
        TransformerLM(port.cfg, device="meta").to_empty(device="cpu"), jq)
    own = _fresh(port).quantize_weights(weight_dtype, _group(weight_dtype))
    a, b = carried.named_weights(), own.named_weights()
    assert sorted(a) == sorted(b)
    for name, leaf in a.items():
        if isinstance(leaf, QTensor):
            assert leaf.q.numpy().tobytes() == b[name].q.numpy().tobytes()
            assert leaf.scale.numpy().tobytes() == \
                b[name].scale.numpy().tobytes()
        else:
            assert torch.equal(leaf, b[name]), name
    toks = torch.tensor([[5, 17, 3, 9, 1, 2]])
    with torch.no_grad():
        assert torch.equal(carried(toks), own(toks))


def test_load_quantized_refusals(port):
    model = _fresh(port)
    q = quantize_params(flax_weights(model), "int8")
    with pytest.raises(ValueError, match="flax-layout shape"):
        model.load_quantized({"wte.weight": q["wpe.weight"]})
    with pytest.raises(ValueError, match="not a quantizable"):
        model.load_quantized({"ln_f.weight": q["wpe.weight"]})
    model.load_quantized({"wte.weight": q["wte.weight"]})
    with pytest.raises(ValueError, match="already quantized"):
        model.load_quantized({"wte.weight": q["wte.weight"]})
    with pytest.raises(ValueError, match="scanned"):
        interop.unstack_scan_params(
            {"layers": {"block": {"k": q["wpe.weight"]}}})


# -------------------------------------------- the plain version vs JAX
def _leaf(bits, transpose, N, rng):
    """A Dense kernel (64, *features) or a (N, 64) embedding table."""
    if transpose:
        w = rng.standard_normal((N, 64))
    else:
        feats = (3, 2, 16) if N == 96 else (N,)
        w = rng.standard_normal((64, *feats))
    return (w * 0.5).astype(np.float32)


# (bits, N, transpose): the 4 orientation x bits cases, then odd N (int4
# packs pairs along a dense leaf's output axis, so its N is even)
MATMUL_CASES = [(8, 96, False), (8, 96, True), (4, 96, False),
                (4, 96, True), (8, 257, False), (8, 257, True),
                (4, 257, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "bits,N,transpose", MATMUL_CASES,
    ids=[f"int{b}-N{n}-{'attend' if t else 'dense'}"
         for b, n, t in MATMUL_CASES])
def test_plain_matmul_matches_jax_kernel(bits, N, transpose, dtype):
    rng = np.random.default_rng(bits * 1000 + N + int(transpose))
    w = _leaf(bits, transpose, N, rng)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    weight_dtype = f"int{bits}"
    jq = jax_quantize({"w": w}, weight_dtype,
                      group_size=GS if bits == 4 else None)["w"]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax.jit(lambda v: jax_quantized_matmul(
        v, jq, transpose=transpose, interpret=True))(jnp.asarray(x, jdt))
    ref = np.asarray(ref.astype(jnp.float32))
    qt = quantize_params({"w": torch.from_numpy(w)}, weight_dtype,
                         GS if bits == 4 else None)["w"]
    tdt = getattr(torch, dtype)
    out = qmm.quantized_matmul_reference(torch.from_numpy(x).to(tdt), qt,
                                         transpose)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    tol = (1e-5 if dtype == "float32" else BF16_ULP) * scale
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=0)
    # on the CPU the wrapper is the plain version, and counts nothing
    qmm.reset_kernel_launches()
    wrapped = qmm.quantized_matmul(torch.from_numpy(x).to(tdt), qt,
                                   transpose)
    assert torch.equal(wrapped, out) and qmm.kernel_launches() == 0


def test_wrapper_checks():
    qt = quantize_params({"w": torch.randn(64, 96)}, "int8")["w"]
    with pytest.raises(ValueError, match="contraction mismatch"):
        qmm.quantized_matmul(torch.randn(3, 32), qt)
    out = qmm.quantized_matmul(torch.randn(2, 3, 64), qt)
    assert tuple(out.shape) == (2, 3, 96)


# ---------------------------------------------------------- serving
@pytest.fixture(scope="module")
def jax_runs(nano):
    """The JAX page-native engine with both Pallas kernels, per
    weight_dtype, on the trace (run once each)."""
    dec, params = nano
    out = {}
    for weight_dtype in ("int8", "int4"):
        client = JaxServeClient(dec, params, num_slots=3, prefill_len=8,
                                attention_kernel="pallas",
                                matmul_kernel="pallas",
                                **_quant_kw(weight_dtype), **PAGED)
        out[weight_dtype] = client.serve_trace(list(TRACE))
        client.shutdown()
    return out


@pytest.mark.parametrize("matmul_kernel", ["cuda", "torch"])
@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_quantized_greedy_tokens_match_jax_pallas_engine(
        nano, port, jax_runs, weight_dtype, matmul_kernel):
    ref = jax_runs[weight_dtype]
    client = ServeClient(port, port.state_dict(), num_slots=3,
                         prefill_len=8, attention_kernel="cuda",
                         matmul_kernel=matmul_kernel, device="cpu",
                         **_quant_kw(weight_dtype), **PAGED)
    out = client.serve_trace(list(TRACE))
    client.shutdown()
    dec, params = nano
    assert sorted(out) == sorted(ref)
    for rid, comp in ref.items():
        got = out[rid]
        assert got.finish_reason == comp.finish_reason
        assert (got.arrival_time, got.first_token_time, got.finish_time) \
            == (comp.arrival_time, comp.first_token_time, comp.finish_time)
        if got.tokens == comp.tokens:
            continue
        i = next(i for i, (a, b) in enumerate(zip(comp.tokens, got.tokens))
                 if a != b)
        forced = np.array(comp.tokens[:i], np.int32)[:, None]
        jax_l, port_l = paged_logits(dec, params, [PROMPTS[rid]], steps=i,
                                     forced=forced, weight_dtype=weight_dtype,
                                     group_size=_group(weight_dtype))
        top2 = np.sort(jax_l[i][0])[-2:]
        assert top2[1] - top2[0] < 1e-5, (rid, i, top2)
        np.testing.assert_allclose(port_l[i], jax_l[i], atol=1e-4, rtol=0)


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_quantized_logits_match_jax_teacher_forced(nano, weight_dtype):
    """Prefill and three decode steps through the page arena, quantized
    on both sides, teacher-forced with JAX's tokens: f32 logits to 1e-4."""
    dec, params = nano
    jax_l, port_l = paged_logits(dec, params, PROMPTS, steps=3,
                                 weight_dtype=weight_dtype,
                                 group_size=_group(weight_dtype))
    for a, b in zip(jax_l, port_l):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)


def test_engine_param_bytes(port):
    """At rest the quantized engine holds codes + scales and no f32 copy
    of a quantized matrix; its bytes are JAX's ``param_bytes``."""
    sd = port.state_dict()
    plain = ServeEngine(port, sd, prefill_len=8, device="cpu", **PAGED)
    full = plain.param_bytes()
    assert full == sum(v.numel() * 4 for v in sd.values())
    n_mat = sum(v.numel() for v in sd.values() if v.ndim >= 2)
    n_vec = sum(v.numel() for v in sd.values() if v.ndim < 2)
    eng8 = ServeEngine(port, sd, prefill_len=8, device="cpu",
                       weight_dtype="int8", **PAGED)
    eng4 = ServeEngine(port, sd, prefill_len=8, device="cpu",
                       weight_dtype="int4", weight_group_size=GS, **PAGED)
    for eng in (eng8, eng4):
        names = eng.model.state_dict().keys()
        assert not any(k in names for k in ("wte.weight", "wpe.weight",
                                            "stack.blocks.0.mlp.up.weight"))
        assert is_quantized(eng.model.named_weights())
    assert eng8.param_bytes() < n_mat + 4 * n_vec + 4 * 4096
    assert eng4.param_bytes() == n_mat // 2 + n_mat // GS * 4 + 4 * n_vec
    # int4 at group size 8 spends as much on scales as on codes
    assert eng8.param_bytes() < 0.3 * full and eng4.param_bytes() < 0.3 * full


def test_engine_validation(port):
    sd = port.state_dict()
    kw = dict(prefill_len=8, device="cpu", **PAGED)
    with pytest.raises(ValueError, match="weight_dtype"):
        ServeEngine(port, sd, weight_dtype="fp8", **kw)
    with pytest.raises(ValueError, match="matmul_kernel"):
        ServeEngine(port, sd, weight_dtype="int8", matmul_kernel="pallas",
                    **kw)
    with pytest.raises(ValueError, match="QUANTIZED"):
        ServeEngine(port, sd, matmul_kernel="cuda", **kw)
    with pytest.raises(ValueError, match="QUANTIZED"):
        ServeClient(_fresh(port, matmul_kernel="cuda"), sd, **kw)
    with pytest.raises(ValueError, match="weight_group_size"):
        ServeEngine(port, sd, weight_dtype="int8", weight_group_size=8, **kw)
    with pytest.raises(ValueError, match="weight_group_size"):
        ServeClient(port, sd, weight_group_size=8, **kw)
    with pytest.raises(ValueError, match="must divide"):
        ServeEngine(port, sd, weight_dtype="int4", weight_group_size=48,
                    **kw)
    with pytest.raises(ValueError, match="matmul_kernel must be one of"):
        gpt2_config("nano", matmul_kernel="xla")
    # the engine owns its model copy with the requested kernel; the
    # caller's model keeps its weights and config
    eng = ServeEngine(port, sd, weight_dtype="int8", matmul_kernel="cuda",
                      **kw)
    assert eng.matmul_kernel == "cuda"
    assert eng.model.cfg.matmul_kernel == "cuda"
    assert eng.model.stack.blocks[0].attn.qkv.matmul_kernel == "cuda"
    assert port.cfg.matmul_kernel == "torch"
    assert not is_quantized(port.named_weights())
    # None keeps the config's choice
    eng = ServeEngine(_fresh(port, matmul_kernel="cuda"), sd,
                      weight_dtype="int4", weight_group_size=GS, **kw)
    assert eng.matmul_kernel == "cuda"


def test_plain_model_unchanged_by_the_quantized_layers(port):
    """No quantized weight: the forward is what it always was (the tied
    head is ``F.linear`` of the rounded table, the lookups gather and
    round rows)."""
    toks = torch.tensor([[5, 17, 3, 9]])
    with torch.no_grad():
        got = port(toks)
        x = (port.wte.weight[toks].float() + port.wpe.weight[:4][None])
        x = port.ln_f(port.stack(x))
        want = torch.nn.functional.linear(x, port.wte.weight).float()
    assert torch.equal(got, want)
