"""The port's Mixture-of-Experts LM (``models/moe.py``) against the JAX package's.

In f32 on the CPU unless named, with the JAX package's weights carried
across by ``interop.flax_state_dict`` and the same numpy inputs:

- ``route_top_k``'s dispatch and combine bitwise equal to JAX's: random
  probabilities, rows built with exact ties (``argmax`` takes the first
  index, in both), and capacities that bind;
- the capacity equal to what the JAX ``MoeMlp`` computes, over a grid of
  (N, E, k, capacity_factor) with exact-integer quotients and quotients
  that f64 rounds just above an integer;
- ``MoeMlp``'s output and aux at 1e-5 in f32 and at the bf16 bound in
  bf16, at a capacity factor where tokens drop (asserted);
- ``MoeTransformerLM``'s logits, aux and the gradients of ``ce + w·aux``
  with ``attention_impl`` "dot" and "flash" (the plain flash path);
  remat under every policy bitwise equal to no remat;
- adafactor on the 3-D expert banks against ``optax.adafactor`` step
  for step (factored over their two last axes, the experts batched);
- a few-step ``Trainer.fit`` of ``MoeModule`` against the JAX trainer
  under ``adamw`` and ``adafactor``;
- greedy ``generate()`` against JAX's ``generate`` in
  ``tests/test_moe.py``'s setting (capacity factor 16);
- ``expert_parallel_rule`` raises, naming its ROADMAP item.
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import LambdaCallback as JaxLambda
from ray_lightning_tpu.core.optim import make_optimizer as jax_make_optimizer
from ray_lightning_tpu.models import moe as jax_moe
from ray_lightning_tpu.models.generate import generate as jax_generate
from ray_lightning_tpu_torch import (MoeModule, MoeTransformerLM,
                                     RayStrategy, Trainer,
                                     expert_parallel_rule, moe_config)
from ray_lightning_tpu_torch.core import LambdaCallback
from ray_lightning_tpu_torch.core.optim import make_optimizer
from ray_lightning_tpu_torch.interop import flax_state_dict, load_flax_params
from ray_lightning_tpu_torch.models import moe
from ray_lightning_tpu_torch.models.generate import generate
from ray_lightning_tpu_torch.models.remat import POLICIES

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

NANO = dict(vocab_size=128, max_seq_len=32)
# bf16 MoeMlp output against JAX's, of the output's largest magnitude:
# the two round the expert products and bias adds to bf16 at the same
# points, but accumulate in other orders (a few bf16 ulps, 2^-8 each)
BF16_RTOL = 2.0 ** -5


def _probs(rng, n, e):
    logits = rng.standard_normal((n, e)).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def _ties(n, e):
    """Rows with exact ties: uniform rows, and rows whose two largest
    probabilities are equal and placed at various experts."""
    rows = [np.full(e, 1.0 / e, np.float32)]
    for i in range(e):
        for j in range(i + 1, e):
            r = np.full(e, 0.05, np.float32)
            r[i] = r[j] = 0.3
            rows.append(r / r.sum())
    out = np.stack([rows[k % len(rows)] for k in range(n)])
    return out.astype(np.float32)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("capacity", [2, 7, 64])
def test_route_top_k_is_bitwise_jax(k, case, capacity):
    N, E = 48, 4
    probs = (_probs(np.random.default_rng(capacity), N, E)
             if case == "random" else _ties(N, E))
    jd, jc = jax_moe.route_top_k(jnp.asarray(probs), capacity, k)
    pd, pc = moe.route_top_k(torch.from_numpy(probs), capacity, k)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    # the capacity binds where it is small: some slot is dropped
    if capacity < k * N // E:
        assert pd.sum() < k * N


def _jax_capacity(B, T, E, k, cf):
    """The capacity JAX's ``MoeMlp`` passes to ``route_top_k``, from a
    shape-only trace."""
    seen = []
    real = jax_moe.route_top_k

    def spy(probs, capacity, top_k):
        seen.append(capacity)
        return real(probs, capacity, top_k)

    cfg = jax_moe.moe_config("nano", n_experts=E, expert_top_k=k,
                             capacity_factor=float(cf),
                             dtype=jnp.float32)
    x = jax.ShapeDtypeStruct((B, T, cfg.d_model), jnp.float32)
    jax_moe.route_top_k = spy
    try:
        jax.eval_shape(lambda x: jax_moe.MoeMlp(cfg).init(
            jax.random.PRNGKey(0), x), x)
    finally:
        jax_moe.route_top_k = real
    return seen[0]


@pytest.mark.parametrize("B,T,E,k,cf", [
    (2, 32, 8, 1, 1.25),     # 64 · 1.25 / 8 = 10 exactly
    (1, 32, 4, 2, 1.0),      # 16 exactly
    (1, 30, 3, 1, 0.1),      # 30 · 0.1 / 3 = 1.0000000000000002 -> 2
    (3, 10, 3, 1, 0.3),      # 30 · 0.3 / 3 = 3.0000000000000004 -> 4
    (1, 7, 4, 2, 1.25),      # 4.375 -> 5
    (4, 128, 8, 1, 1.25),    # MoE-small's 160
    (4, 128, 8, 2, 1.25),    # and at top-2, 320
    (1, 1, 8, 1, 1.25),      # a decode step: max(1, ceil(0.15625))
    (2, 16, 4, 1, 16.0),     # tests/test_moe.py's overflow-free setting
    (5, 3, 7, 2, 1.1),
])
def test_capacity_matches_jax(B, T, E, k, cf):
    assert moe.expert_capacity(B * T, E, k, cf) == \
        _jax_capacity(B, T, E, k, cf)


def _mlp_pair(dtype, cf, E=4, k=2):
    jcfg = jax_moe.moe_config("nano", n_experts=E, expert_top_k=k,
                              capacity_factor=cf,
                              dtype=jnp.float32 if dtype == torch.float32
                              else jnp.bfloat16)
    pcfg = moe_config("nano", n_experts=E, expert_top_k=k,
                      capacity_factor=cf, dtype=dtype)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    layer = jax_moe.MoeMlp(jcfg)
    params = layer.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    port = moe.MoeMlp(pcfg, "cpu")
    port.load_state_dict({n: torch.from_numpy(np.array(v))
                          for n, v in flax_state_dict(params).items()})
    return layer, params, port, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_mlp_matches_jax_with_drops(dtype):
    layer, params, port, x = _mlp_pair(dtype, cf=0.5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jout, jaux = layer.apply({"params": params}, jnp.asarray(x, jdt))
    out, aux = port(torch.from_numpy(x).to(dtype))
    # tokens drop at this capacity: 2 slots a token, 8 per expert
    assert port.last_dispatched < 2 * 32
    want = np.asarray(jout.astype(jnp.float32))
    got = out.float().detach().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        bound = BF16_RTOL * np.abs(want).max()
        assert np.abs(got - want).max() <= bound
    # the aux loss is f32 in both
    assert abs(aux.item() - float(jaux)) <= 1e-6


def _lm_pair(impl, **kw):
    jcfg = jax_moe.moe_config("nano", attention_impl=impl,
                              dtype=jnp.float32, **NANO, **kw)
    pcfg = moe_config("nano", attention_impl=impl, dtype=torch.float32,
                      **NANO, **kw)
    toks = np.random.default_rng(5).integers(0, 128, (4, 33)).astype(
        np.int32)
    batch = (toks[:, :-1], toks[:, 1:])
    jmodel = jax_moe.MoeTransformerLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), batch[0])["params"]
    return jcfg, pcfg, jmodel, params, batch


def _port_loss(model, batch, w):
    tokens, targets = (torch.from_numpy(np.asarray(a)) for a in batch)
    logits, aux = model(tokens)
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long())
    return ce + w * aux, logits, aux


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_lm_logits_aux_and_grads_match_jax(impl):
    jcfg, pcfg, jmodel, params, batch = _lm_pair(impl, capacity_factor=1.0)
    w = jcfg.aux_loss_weight

    def loss_fn(p):
        logits, aux = jmodel.apply({"params": p}, jnp.asarray(batch[0]))
        ce = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(batch[1])))
        return ce + w * aux, (logits, aux)

    (jloss, (jlogits, jaux)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    model = load_flax_params(MoeTransformerLM(pcfg, device="cpu"), params)
    loss, logits, aux = _port_loss(model, batch, w)
    loss.backward()
    # the capacity binds in some layer
    assert min(model.dispatched()) < 4 * 32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    assert abs(aux.item() - float(jaux)) <= 1e-6
    assert abs(loss.item() - float(jloss)) <= 1e-5
    want = flax_state_dict(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g, atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_remat_is_bitwise_no_remat(policy):
    _, pcfg, _, params, batch = _lm_pair("flash", capacity_factor=1.0)
    out = []
    for cfg in (pcfg, dataclasses.replace(pcfg, remat=True,
                                          remat_policy=policy)):
        model = load_flax_params(MoeTransformerLM(cfg, device="cpu"), params)
        loss, _, _ = _port_loss(model, batch, cfg.aux_loss_weight)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    model.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


# a narrowed MoE whose expert banks and embedding factor under adafactor
# (both of their two largest axes >= 128)
FACTORED = dict(d_model=128, n_heads=2, d_ff=256, n_layers=2, n_experts=4,
                vocab_size=256, max_seq_len=32)


def test_adafactor_factors_the_expert_banks_as_optax():
    """``MoeModule``'s adafactor, on the JAX model's leaves
    (``moe.jax_leaves``), against optax on the same flax tree: the same
    gradients, 4 steps, params after every step at atol 1e-6, f32
    momentum (a bf16 one may round the other way,
    ``tests/test_torch_optim.py``). The banks (E, d, d_ff) keep factored
    moments (E, d) and (E, d_ff)."""
    jcfg = jax_moe.moe_config(**{**FACTORED, "dtype": jnp.float32})
    pcfg = moe_config(**{**FACTORED, "dtype": torch.float32})
    jmodel = jax_moe.MoeTransformerLM(jcfg)
    toks = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), toks)["params"]
    grng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(
        lambda p: np.asarray(grng.standard_normal(p.shape), np.float32),
        params) for _ in range(4)]
    kw = dict(weight_decay=0.01, moment_dtype="float32")
    tx = jax_make_optimizer("adafactor", 1e-2, **kw)
    jp, state = params, tx.init(params)
    model = load_flax_params(MoeTransformerLM(pcfg, device="cpu"), params)
    opt = make_optimizer("adafactor", 1e-2, leaves=moe.jax_leaves(pcfg),
                         **kw)(model.parameters())
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        gsd = flax_state_dict(g)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(np.array(gsd[n]))
        opt.step()
        want = flax_state_dict(jax.tree_util.tree_map(np.asarray, jp))
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n],
                                       atol=1e-6, rtol=0, err_msg=n)
    up = model.blocks[0].moe.experts_up
    st = opt.state[up]
    E, d, f = up.shape
    assert st["v_row"].shape == (E, d) and st["v_col"].shape == (E, f)


# ------------------------------------------------------------ the fits
FIT = dict(max_epochs=1, limit_train_batches=4, limit_val_batches=1, seed=0)
FIT_MODULE = dict(batch_size=8, seq_len=32, num_samples=64, lr=3e-3)


@pytest.fixture(scope="module", params=["adamw", "adafactor"])
def jax_fit(request):
    out = {"losses": []}

    def on_start(tr, m):
        out["init"] = jax.tree_util.tree_map(np.array,
                                             tr.train_state.params)

    def on_batch_end(tr, m, outputs, batch, batch_idx):
        out["losses"].append(float(np.asarray(outputs["loss"])))

    cfg = jax_moe.moe_config(**{**FACTORED, "dtype": jnp.float32,
                                "capacity_factor": 1.0})
    trainer = JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                         callbacks=[JaxLambda(on_fit_start=on_start,
                                              on_train_batch_end=on_batch_end)],
                         **FIT)
    trainer.fit(jax_moe.MoeModule(config=cfg, optimizer=request.param,
                                  **FIT_MODULE))
    out.update(final=jax.tree_util.tree_map(np.array,
                                            trainer.train_state.params),
               metrics={k: float(v) for k, v in
                        trainer.callback_metrics.items()},
               opt=request.param)
    return out


class _FromFlax(MoeModule):
    def __init__(self, init, **kw):
        super().__init__(**kw)
        self.init = init

    def init_variables(self, model, generator, batch):
        load_flax_params(model, self.init)


def test_fit_matches_the_jax_trainer(jax_fit):
    losses = []
    cfg = moe_config(**{**FACTORED, "dtype": torch.float32,
                        "capacity_factor": 1.0})
    trainer = Trainer(strategy=RayStrategy(device="cpu"),
                      callbacks=[LambdaCallback(
                          on_train_batch_end=lambda tr, m, o, b, i:
                          losses.append(float(o["loss"])))], **FIT)
    trainer.fit(_FromFlax(jax_fit["init"], config=cfg,
                          optimizer=jax_fit["opt"], **FIT_MODULE))
    assert trainer.global_step == 4
    np.testing.assert_allclose(losses, jax_fit["losses"], atol=1e-4, rtol=0)
    metrics = {k: float(v) for k, v in trainer.callback_metrics.items()}
    assert set(metrics) == set(jax_fit["metrics"])
    for name, v in jax_fit["metrics"].items():
        np.testing.assert_allclose(metrics[name], v, atol=1e-4, rtol=0,
                                   err_msg=name)
    want = flax_state_dict(jax_fit["final"])
    got = {n: p.detach().numpy() for n, p in trainer.model.named_parameters()}
    opt = trainer.train_state.optimizer
    emas = {n: float(opt.state[p]["ema"].float().abs().max())
            for n, p in trainer.model.named_parameters()} \
        if jax_fit["opt"] == "adafactor" else None
    assert_fit_params(got, want, emas, cfg, FIT_MODULE["lr"], 4)


def assert_fit_params(got, want, emas, cfg, lr, steps):
    """A fit's final params (name -> numpy) against the JAX trainer's.
    ``emas`` (adafactor: each param's largest final momentum magnitude;
    None: adamw) sets the bound."""
    assert got.keys() == want.keys()
    hd = cfg.n_heads * cfg.head_dim
    for name, g in got.items():
        w = want[name]
        if name.endswith("attn.qkv.bias"):
            # the key bias's gradient is zero in exact arithmetic (the
            # softmax is shift-invariant along the keys): both optimizers
            # normalize its rounding noise into steps of up to ~lr
            keys = slice(hd, 2 * hd)
            assert np.abs(g[keys] - w[keys]).max() <= 2 * lr * steps, name
            g, w = np.delete(g, keys), np.delete(w, keys)
        d = np.abs(g - w)
        if emas is not None:
            # the bf16 momentum may round the other way each update
            # (tests/test_torch_optim.py's free-running bound)
            assert d.max() <= 1e-5 + steps * 2.0 ** -8 * emas[name], name
        else:
            # adam's normalized step follows the sign of a near-zero
            # gradient: a few elements in a thousand may take it the
            # other way, none further than its steps
            assert (d > 1e-5).mean() <= 1e-3, name
            assert d.max() <= 2 * lr * steps, name


# ------------------------------------------------------------ decoding
def test_greedy_generate_matches_jax():
    """``tests/test_moe.py``'s setting: capacity factor 16, so no expert
    overflows in the prefill or in a decode step."""
    mk = dict(vocab_size=64, max_seq_len=16, capacity_factor=16.0)
    dec = jax_moe.MoeTransformerLM(jax_moe.moe_config(
        "nano", decode=True, dtype=jnp.float32, **mk))
    full = jax_moe.MoeTransformerLM(jax_moe.moe_config(
        "nano", dtype=jnp.float32, **mk))
    prompt = np.array([[3, 9], [7, 1]], dtype=np.int32)
    params = full.init(jax.random.PRNGKey(0), prompt)["params"]
    want = np.asarray(jax_generate(dec, params, prompt, max_new_tokens=6,
                                   rng=jax.random.PRNGKey(1),
                                   temperature=0.0))
    model = load_flax_params(MoeTransformerLM(moe_config(
        "nano", dtype=torch.float32, **mk), device="cpu"), params)
    got = generate(model, None, prompt, max_new_tokens=6, rng=0,
                   temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the full-scan reference path agrees
    scan = generate(model, None, prompt, max_new_tokens=6, rng=0,
                    temperature=0.0, use_prefill=False)
    np.testing.assert_array_equal(scan.numpy(), want)


def test_flax_tree_converts_leaf_by_leaf():
    """``interop.flax_state_dict`` on the MoE tree: the router's kernel
    transposed, the banks as they are, blocks straight under the root."""
    jcfg, pcfg, _, params, _ = _lm_pair("dot")
    sd = flax_state_dict(params)
    model = MoeTransformerLM(pcfg, device="meta")
    assert set(sd) == {n for n, _ in model.named_parameters()}
    blk = params["block_0"]["moe"]
    np.testing.assert_array_equal(sd["blocks.0.moe.router.weight"],
                                  np.asarray(blk["router"]["kernel"]).T)
    np.testing.assert_array_equal(sd["blocks.0.moe.experts_up"],
                                  np.asarray(blk["experts_up"]))
    for n, p in model.named_parameters():
        assert sd[n].shape == tuple(p.shape), n


def test_expert_parallel_rule_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="item 9"):
        expert_parallel_rule((), None)
