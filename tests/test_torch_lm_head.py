"""The port's LM-head losses, hidden states and untied head against the JAX package.

- ``lm_head_xent`` and ``chunked_lm_head_xent`` (``ops/lm_head_loss.py``)
  against JAX's on the same numpy hidden states, table and labels: the
  loss and its gradients in the hidden states and the table, with
  ``compute_dtype`` f32 (loss 1e-6, gradients 1e-6 of the largest) and
  bf16 (the same bf16 operands and f32 sums: loss 1e-5, gradients 2 bf16
  ulps of the largest); the chunked one over a token count that is not
  a multiple of the chunk, with and without ``z_loss``.
- ``TransformerLM(return_hidden=True)`` returns JAX's hidden states, and
  the chunked loss on them equals the model's materialized loss.
- ``tie_embeddings=False``: the untied nano model's logits and loss
  gradients equal JAX's (the flax ``lm_head/kernel`` carried across by
  ``interop``), its int8 and int4 codes (the head's among them) are
  byte-equal to JAX ``quantize_params``, and its f32 greedy tokens equal
  the JAX page-native engine's with the Pallas kernels, with f32 and
  with int8 weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import TransformerLM as JaxTransformerLM
from ray_lightning_tpu.models import gpt2_config as jax_gpt2_config
from ray_lightning_tpu.models.quant import quantize_params as jax_quantize
from ray_lightning_tpu.ops.lm_head_loss import \
    chunked_lm_head_xent as jax_chunked
from ray_lightning_tpu.ops.lm_head_loss import lm_head_xent as jax_direct
from ray_lightning_tpu.serve import ServeClient as JaxServeClient
from ray_lightning_tpu_torch import interop
from ray_lightning_tpu_torch.interop import (flax_state_dict, flax_weights,
                                             load_flax_params)
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.models.quant import quantize_params
from ray_lightning_tpu_torch.models.transformer import jax_leaves
from ray_lightning_tpu_torch.ops.lm_head_loss import (chunked_lm_head_xent,
                                                      lm_head_xent)
from ray_lightning_tpu_torch.serve import ServeClient

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

N_BT, D, V = (3, 20), 32, 100     # 60 tokens
BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (loss atol, gradient atol relative to the largest gradient)
TOL = {"float32": (1e-6, 1e-6), "bfloat16": (1e-5, 2 * BF16_ULP)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((*N_BT, D)).astype(np.float32)
    table = (0.2 * rng.standard_normal((V, D))).astype(np.float32)
    labels = rng.integers(0, V, N_BT).astype(np.int32)
    return hidden, table, labels


def _jax_value_and_grads(fn, hidden, table, labels, **kw):
    loss, (gh, gt) = jax.value_and_grad(
        lambda h, t: fn(h, t, jnp.asarray(labels), **kw),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(table))
    return float(loss), np.asarray(gh), np.asarray(gt)


def _port_value_and_grads(fn, hidden, table, labels, **kw):
    h = torch.from_numpy(hidden).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    loss = fn(h, t, torch.from_numpy(labels), **kw)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.ndim == 0
    return loss.item(), h.grad.numpy(), t.grad.numpy()


def _close(got, want, dtype):
    loss_tol, grad_tol = TOL[dtype]
    assert abs(got[0] - want[0]) <= loss_tol
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=grad_tol * np.abs(w).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_direct_loss_and_grads_match_jax(dtype):
    jd, td = DTYPES[dtype]
    args = _inputs()
    _close(_port_value_and_grads(lm_head_xent, *args, compute_dtype=td),
           _jax_value_and_grads(jax_direct, *args, compute_dtype=jd), dtype)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("chunk", [16, 2048])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunked_loss_and_grads_match_jax(dtype, chunk, z_loss):
    """16 does not divide the 60 tokens: the last chunk is padded and
    masked; 2048 is one chunk of all of them."""
    jd, td = DTYPES[dtype]
    args = _inputs(1)
    _close(_port_value_and_grads(chunked_lm_head_xent, *args,
                                 chunk_size=chunk, compute_dtype=td,
                                 z_loss=z_loss),
           _jax_value_and_grads(jax_chunked, *args, chunk_size=chunk,
                                compute_dtype=jd, z_loss=z_loss), dtype)


def test_chunked_and_direct_agree_in_f32():
    hidden, table, labels = map(torch.from_numpy, _inputs(2))
    a = lm_head_xent(hidden, table, labels, compute_dtype=torch.float32)
    b = chunked_lm_head_xent(hidden, table, labels, chunk_size=7,
                             compute_dtype=torch.float32)
    assert abs(a.item() - b.item()) <= 1e-6


# ------------------------------------------------------------ the models
NANO = dict(vocab_size=128, max_seq_len=32)


def _jax_cfg(**kw):
    return jax_gpt2_config("nano", dtype=jnp.float32, scan_layers=False,
                           **NANO, **kw)


def _port_cfg(**kw):
    return gpt2_config("nano", dtype=torch.float32, **NANO, **kw)


@pytest.fixture(scope="module")
def untied():
    """The JAX untied nano model's params and a batch of tokens."""
    tokens = np.random.default_rng(5).integers(0, 128, (2, 16)).astype(
        np.int32)
    params = JaxTransformerLM(_jax_cfg(tie_embeddings=False)).init(
        jax.random.PRNGKey(0), tokens)["params"]
    assert params["lm_head"]["kernel"].shape == (128, 128)
    return params, tokens


@pytest.mark.parametrize("tie", [True, False])
def test_hidden_states_and_chunked_loss_on_them(untied, tie):
    params, tokens = untied
    if tie:
        params = {k: v for k, v in params.items() if k != "lm_head"}
    jmodel = JaxTransformerLM(_jax_cfg(tie_embeddings=tie))
    want = np.asarray(jmodel.apply({"params": params}, tokens,
                                   return_hidden=True))
    model = load_flax_params(
        TransformerLM(_port_cfg(tie_embeddings=tie), device="cpu"), params)
    toks = torch.from_numpy(tokens).long()
    hidden = model(toks, return_hidden=True)
    np.testing.assert_allclose(hidden.detach().numpy(), want, atol=1e-5,
                               rtol=0)
    head = model.wte.weight if tie else model.lm_head.weight
    inputs, targets = toks[:, :-1], toks[:, 1:]
    logits = model(inputs)
    full = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
    chunked = chunked_lm_head_xent(model(inputs, return_hidden=True), head,
                                   targets, chunk_size=8,
                                   compute_dtype=torch.float32)
    assert abs(full.item() - chunked.item()) <= 1e-6


def test_untied_logits_and_grads_match_jax(untied):
    params, tokens = untied
    jmodel = JaxTransformerLM(_jax_cfg(tie_embeddings=False))
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, inputs)
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(logits), targets[..., None], -1)), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    model = load_flax_params(
        TransformerLM(_port_cfg(tie_embeddings=False), device="cpu"), params)
    logits = model(torch.from_numpy(inputs).long())
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.from_numpy(targets).long().reshape(-1))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    want = flax_state_dict(jgrads)
    names = [n for n, _ in model.named_parameters()]
    assert set(want) == set(names)
    assert "lm_head.weight" in want and model.lm_head.bias is None
    # the optimizer's leaves: the head is a leaf of its own, flax-shaped
    assert ((128, 128), (names.index("lm_head.weight"),)) in \
        jax_leaves(model.cfg)
    for name, g in want.items():
        np.testing.assert_allclose(model.get_parameter(name).grad.numpy(), g,
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("weight_dtype,group", [("int8", None), ("int4", 8)])
def test_untied_codes_byte_equal_to_jax(untied, weight_dtype, group):
    params, _ = untied
    model = load_flax_params(
        TransformerLM(_port_cfg(tie_embeddings=False), device="cpu"), params)
    got = quantize_params(flax_weights(model), weight_dtype, group)
    seen = set()
    for name, jleaf in interop._flax_leaves(
            jax_quantize(params, weight_dtype, group)):
        if not interop._is_quantized_leaf(jleaf):
            continue
        qt = got[name]
        assert qt.shape == tuple(jleaf.shape), name
        assert qt.q.numpy().tobytes() == np.asarray(jleaf.q).tobytes(), name
        assert qt.scale.numpy().tobytes() == \
            np.asarray(jleaf.scale).tobytes(), name
        seen.add(name)
    assert "lm_head.weight" in seen and seen == set(got)


TRACE = [(0, dict(prompt=[5, 17, 3, 9], max_new_tokens=6)),
         (0, dict(prompt=[9, 2, 44], max_new_tokens=6)),
         (3, dict(prompt=[42, 7], max_new_tokens=6)),
         (5, dict(prompt=[1], max_new_tokens=6))]
SERVE = dict(num_slots=3, prefill_len=8, page_size=4, page_native=True)


@pytest.mark.parametrize("weight_dtype", [None, "int8"])
def test_untied_greedy_tokens_match_jax_pallas_engine(untied, weight_dtype):
    params, _ = untied
    dec = JaxTransformerLM(dataclasses.replace(
        _jax_cfg(tie_embeddings=False), decode=True))
    # the JAX engine takes its matmul kernel for quantized weights only
    kw = {} if weight_dtype is None else dict(weight_dtype=weight_dtype,
                                              matmul_kernel="pallas")
    jclient = JaxServeClient(dec, params, attention_kernel="pallas",
                             **SERVE, **kw)
    want = jclient.serve_trace(list(TRACE))
    jclient.shutdown()
    model = load_flax_params(
        TransformerLM(_port_cfg(tie_embeddings=False), device="cpu"), params)
    kw = {} if weight_dtype is None else dict(weight_dtype=weight_dtype,
                                              matmul_kernel="cuda")
    client = ServeClient(model, model.state_dict(), attention_kernel="cuda",
                         device="cpu", **SERVE, **kw)
    got = client.serve_trace(list(TRACE))
    client.shutdown()
    assert sorted(got) == sorted(want)
    for rid, comp in want.items():
        assert got[rid].tokens == comp.tokens, rid
        assert got[rid].finish_reason == comp.finish_reason


def test_int4_cannot_group_the_untied_gpt2_head():
    """int4 groups run along the stored last axis, and no even group
    length divides GPT-2's vocab (50257 = 29 x 1733): JAX
    ``quantize_params`` refuses the untied head's (768, 50257) kernel,
    and the port refuses it the same way; int8 takes it."""
    w = np.zeros((8, 50257), np.float32)
    with pytest.raises(ValueError, match="group_size"):
        jax_quantize({"lm_head": {"kernel": w}}, "int4")
    with pytest.raises(ValueError, match="group_size"):
        quantize_params({"lm_head.weight": torch.from_numpy(w)}, "int4")
    assert quantize_params({"lm_head.weight": torch.from_numpy(w)},
                           "int8")["lm_head.weight"].shape == (8, 50257)
