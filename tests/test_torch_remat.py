"""The port's dropout, remat and bf16 softmax against the JAX package.

Nano GPT (2 layers, d 128, vocab 256, max_seq_len 32, f32, batch 4) with
the JAX package's weights carried across by ``interop``:

- **Dropout on JAX's own masks.** The JAX model runs eagerly
  (``scan_layers=False``, no ``jit``) under ``jax.value_and_grad`` of
  ``GPTModule._loss`` with ``dropout=0.1``; the test wraps
  ``jax.random.bernoulli`` to record every keep mask in draw order (per
  layer: the attention weights, then the MLP output) and feeds them to
  the port through its one mask function, ``ops.dropout.dropout_keep``,
  monkeypatched. Loss and gradients at atol 1e-5, as
  ``tests/test_torch_train.py``.
- **Dropout's own rules.** ``deterministic=True`` equals ``dropout=0``
  bitwise; a seed gives the same masks again, another seed or site other
  ones; the keep rate lies within 5 standard deviations of the binomial's
  mean; ``flash_attention`` with dropout runs the dense path (no flash
  forward is called), as JAX's does.
- **Remat.** Under each of the five policies, loss and gradients with
  ``remat=True`` are bitwise equal to ``remat=False`` on the CPU, and
  equal to the JAX model with the same ``remat``/``remat_policy`` at
  1e-6 (dropout 0). With dropout 0.1 the same step rematerialized equals
  the plain one bitwise: the replay redraws the masks. Per step the flash
  forward runs 2 x n_layers times under remat (forward and replay), the
  backward n_layers times; the bytes autograd keeps order as
  ``None`` < ``dots_with_no_batch_dims`` < ``..._save_attn`` <
  ``..._save_attn_mlp`` <= no remat.
- **bf16 softmax.** ``dot_product_attention(softmax_dtype=bfloat16)``
  against JAX's, bf16 and f32 inputs, within 2 bf16 ulps of the largest
  output (both round the scores, the softmax and the weights to bf16 and
  may round a value the other way); the nano model's logits with
  ``attention_softmax_dtype=bfloat16`` no farther from JAX's than JAX's
  bf16-softmax logits are from its f32-softmax ones.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_lightning_tpu.models.gpt import GPTModule as JaxGPTModule
from ray_lightning_tpu.models.gpt import gpt2_config as jax_gpt2_config
from ray_lightning_tpu.ops.attention import \
    dot_product_attention as jax_dot_product_attention
from ray_lightning_tpu_torch import GPTModule, TransformerLM, gpt2_config
from ray_lightning_tpu_torch.interop import flax_state_dict, load_flax_params
from ray_lightning_tpu_torch.models import remat
from ray_lightning_tpu_torch.ops import cuda_flash as cf
from ray_lightning_tpu_torch.ops import dropout
from ray_lightning_tpu_torch.ops.attention import dot_product_attention
from ray_lightning_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

NANO = dict(vocab_size=256, max_seq_len=32)
POLICIES = [None, "dots", "dots_with_no_batch_dims",
            "dots_with_no_batch_dims_save_attn",
            "dots_with_no_batch_dims_save_attn_mlp"]
RATE = 0.1
SEED = 1234


def _jax_module(impl="flash", **kw):
    cfg = jax_gpt2_config("nano", attention_impl=impl, dtype=jnp.float32,
                          scan_layers=False, **NANO, **kw)
    return JaxGPTModule(config=cfg, batch_size=4)


def _port_module(impl="flash", **kw):
    return GPTModule(config=gpt2_config("nano", attention_impl=impl,
                                        dtype=torch.float32, **NANO, **kw),
                     batch_size=4)


@pytest.fixture(scope="module")
def init():
    """The JAX nano GPT's initial params and a training batch."""
    jmod = _jax_module()
    jmodel = jmod.configure_model()
    batch = next(iter(jmod.train_dataloader()))
    params = jmodel.init(jax.random.PRNGKey(0), batch[0])["params"]
    return params, batch


def _torch(batch):
    return tuple(torch.from_numpy(np.asarray(x)) for x in batch)


def _jax_step(jmod, params, batch, deterministic=True, masks=None,
              monkeypatch=None):
    """``jax.value_and_grad`` of ``GPTModule._loss``; with ``masks`` (a
    list) every ``jax.random.bernoulli`` draw is appended to it."""
    jmodel = jmod.configure_model()
    draw = jax.random.bernoulli
    if masks is not None:
        def recorded(key, p=0.5, shape=None, mode="low"):
            mask = draw(key, p, shape, mode)
            masks.append(np.asarray(mask))
            return mask

        monkeypatch.setattr(jax.random, "bernoulli", recorded)
    loss, grads = jax.value_and_grad(lambda p: jmod._loss(
        jmodel, {"params": p}, batch, jax.random.PRNGKey(1),
        deterministic)[0])(params)
    if masks is not None:
        monkeypatch.setattr(jax.random, "bernoulli", draw)
    return float(loss), flax_state_dict(grads)


def _port_step(module, params, batch, deterministic=True, seed=None):
    model = load_flax_params(TransformerLM(module.cfg, device="cpu"), params)
    loss, _ = module._loss(model, _torch(batch), deterministic, seed)
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


def _close(got, want, atol):
    loss, grads = got
    jloss, jgrads = want
    assert abs(loss.item() - jloss) <= atol
    assert grads.keys() == jgrads.keys()
    for name, g in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy(), g, atol=atol,
                                   rtol=0, err_msg=name)


def _bitwise(a, b):
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys()
    for name in a[1]:
        assert torch.equal(a[1][name], b[1][name]), name


# --------------------------------------------------------------- dropout
@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_dropout_loss_and_grads_match_jax_on_its_masks(init, impl,
                                                       monkeypatch):
    params, batch = init
    masks = []
    want = _jax_step(_jax_module(impl, dropout=RATE), params, batch,
                     deterministic=False, masks=masks,
                     monkeypatch=monkeypatch)
    module = _port_module(impl, dropout=RATE)
    n = module.cfg.n_layers
    assert [m.ndim for m in masks] == [4, 3] * n    # attention, MLP per layer
    fed = iter(masks)

    def keep(seed, shape, rate, device):
        mask = torch.from_numpy(next(fed).copy())
        assert tuple(mask.shape) == tuple(shape) and rate == RATE
        return mask

    monkeypatch.setattr(dropout, "dropout_keep", keep)
    got = _port_step(module, params, batch, deterministic=False, seed=SEED)
    assert next(fed, None) is None
    _close(got, want, 1e-5)


def test_deterministic_step_equals_dropout_zero(init):
    params, batch = init
    _bitwise(_port_step(_port_module(dropout=RATE), params, batch),
             _port_step(_port_module(), params, batch))


def test_masks_repeat_for_a_seed_and_differ_across_seeds_and_sites(init):
    params, batch = init
    module = _port_module("dot", dropout=RATE)
    a = _port_step(module, params, batch, False, SEED)
    _bitwise(a, _port_step(module, params, batch, False, SEED))
    assert not torch.equal(
        a[0], _port_step(module, params, batch, False, SEED + 1)[0])
    shape = (64, 64)
    seeds = {dropout.site_seed(SEED, layer, site)
             for layer in range(2) for site in (dropout.ATTENTION,
                                                dropout.MLP)}
    assert len(seeds) == 4
    first = dropout.dropout_keep(min(seeds), shape, RATE, "cpu")
    assert torch.equal(first,
                       dropout.dropout_keep(min(seeds), shape, RATE, "cpu"))
    assert not torch.equal(first,
                           dropout.dropout_keep(max(seeds), shape, RATE,
                                                "cpu"))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_within_binomial_bound(rate):
    n = 1 << 20
    kept = dropout.dropout_keep(dropout.site_seed(7, 0, 0), (n,), rate,
                                "cpu").sum().item()
    p = 1.0 - rate
    assert abs(kept - n * p) <= 5 * (n * p * (1 - p)) ** 0.5


def test_flash_with_dropout_takes_the_dense_path(monkeypatch):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 4, 32))
                                .astype(np.float32)) for _ in range(3))
    calls = []
    fwd = cf.flash_fwd
    monkeypatch.setattr(cf, "flash_fwd",
                        lambda *a: calls.append(1) or fwd(*a))
    got = flash_attention(q, k, v, causal=True, dropout_rate=RATE,
                          dropout_rng=SEED)
    want = dot_product_attention(q, k, v, causal=True, dropout_rate=RATE,
                                 dropout_rng=SEED)
    assert torch.equal(got, want) and calls == []
    # without a seed (JAX: without a key) nothing is dropped
    flash_attention(q, k, v, causal=True, dropout_rate=RATE)
    assert calls == [1]


# ----------------------------------------------------------------- remat
@pytest.mark.parametrize("impl", ["dot", "flash"])
@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_is_bitwise_and_matches_jax(init, impl, policy):
    params, batch = init
    kw = dict(remat=True, remat_policy=policy)
    got = _port_step(_port_module(impl, **kw), params, batch)
    _bitwise(got, _port_step(_port_module(impl), params, batch))
    _close(got, _jax_step(_jax_module(impl, **kw), params, batch), 1e-6)


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_replays_the_dropout_masks(init, policy):
    params, batch = init
    got = _port_step(_port_module(dropout=RATE, remat=True,
                                  remat_policy=policy),
                     params, batch, deterministic=False, seed=SEED)
    _bitwise(got, _port_step(_port_module(dropout=RATE), params, batch,
                             deterministic=False, seed=SEED))


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_replays_the_flash_forward(init, policy, monkeypatch):
    """The flash forward is no ATen op, so every policy replays it: per
    step 2 x n_layers forwards (the CUDA path's K2 launches), n_layers
    backward calls (K3, K4)."""
    params, batch = init
    counts = dict.fromkeys(("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"), 0)
    for name in counts:
        fn = getattr(cf, name)

        def counted(*a, _fn=fn, _name=name):
            counts[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(cf, name, counted)
    module = _port_module(remat=True, remat_policy=policy)
    _port_step(module, params, batch)
    n = module.cfg.n_layers
    assert counts == {"flash_fwd": 2 * n, "flash_bwd_dkv": n,
                      "flash_bwd_dq": n}


def _saved_bytes(params, batch, **kw):
    module = _port_module(**kw)
    model = load_flax_params(TransformerLM(module.cfg, device="cpu"), params)
    with remat.count_saved() as counter:
        loss, _ = module._loss(model, _torch(batch))
    loss.backward()
    return counter.bytes


def test_saved_bytes_order_by_policy(init):
    params, batch = init
    saved = {p: _saved_bytes(params, batch, remat=True, remat_policy=p)
             for p in POLICIES}
    plain = _saved_bytes(params, batch)
    assert (saved[None] < saved["dots_with_no_batch_dims"]
            < saved["dots_with_no_batch_dims_save_attn"]
            < saved["dots_with_no_batch_dims_save_attn_mlp"] <= plain)
    assert saved["dots"] >= saved["dots_with_no_batch_dims"]


# ------------------------------------------------------------ bf16 softmax
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_softmax_attention_matches_jax(dtype, causal):
    rng = np.random.default_rng(3)
    qkv = [rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
           for _ in range(3)]
    jq, jk, jv = (jnp.asarray(x, dtype) for x in qkv)
    want = np.asarray(jax_dot_product_attention(
        jq, jk, jv, causal=causal, softmax_dtype=jnp.bfloat16)
        .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in qkv)
    got = dot_product_attention(tq, tk, tv, causal=causal,
                                softmax_dtype=torch.bfloat16).float()
    assert got.dtype == torch.float32
    bound = 2 * 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=bound, rtol=0)


def test_bf16_softmax_model_logits_match_jax(init):
    """The nano model's logits with a bf16 softmax lie no farther from
    JAX's than JAX's own bf16-softmax logits lie from its f32-softmax
    ones (largest and mean difference): the frameworks differ by the
    rounding the option brings, no more."""
    params, batch = init

    def jax_logits(**kw):
        model = _jax_module("dot", **kw).configure_model()
        return np.asarray(model.apply({"params": params}, batch[0]))

    want = jax_logits(attention_softmax_dtype=jnp.bfloat16)
    rounding = np.abs(want - jax_logits())
    module = _port_module("dot", attention_softmax_dtype=torch.bfloat16)
    model = load_flax_params(TransformerLM(module.cfg, device="cpu"), params)
    with torch.no_grad():
        got = model(_torch(batch)[0]).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= rounding.max() and diff.mean() <= rounding.mean()
    assert rounding.max() > 0
