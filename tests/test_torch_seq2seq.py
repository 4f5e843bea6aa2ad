"""The encoder-decoder (ROADMAP A, item 8, ``seq2seq``) against the JAX package.

In f32 on the CPU at ``tests/test_seq2seq.py``'s widths (vocab 32, d 64,
4 heads, 2 + 2 layers, d_ff 128), the JAX package's weights carried
across by ``interop`` and the same numpy inputs (source S = 6, target T =
4; the JAX ``"flash"`` impl on its blockwise XLA path, the port's on the
flash kernels' plain versions):

- logits and every gradient within 1e-5 of JAX's, with the encoder's
  weights scanned and unrolled, ``dot`` and ``flash``, with no source
  mask, a partly padded row, and a row that is all padding (whose
  cross-attention is exactly 0 in both packages); bf16 logits within
  2 bf16 ulps of the largest logit;
- the counterparts of ``tests/test_seq2seq.py``'s six module tests, and
  remat under each of the five policies: bitwise the plain step, and
  within 1e-5 of JAX's step;
- the bytes autograd keeps for one rematerialized decoder block, under
  each policy, equal to what the policy table predicts (the
  cross-attention's products replayed under the ``save_attn`` policies);
- a 4-step ``Seq2SeqModule`` fit through the port's ``Trainer`` against
  the JAX ``Trainer``: per-step losses, metrics and final params;
- dropout: JAX's own masks fed through ``dropout_keep`` give JAX's loss
  and gradients; deterministic when off; no two sites of the model draw
  one seed; remat replays the masks; a fit killed mid-way and resumed
  from its stream checkpoint is bitwise the uninterrupted one;
- the converter: a round trip through the flax layout, and a tree with a
  leaf too many or too few refused.
"""
import functools
import os

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import LambdaCallback as JaxLambda
from ray_lightning_tpu.models import seq2seq as jax_seq2seq
from ray_lightning_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from ray_lightning_tpu.models.transformer import \
    unstack_scan_params as jax_unstack
from ray_lightning_tpu_torch import (ModelCheckpoint, RayStrategy,
                                     Seq2SeqModule, Seq2SeqTransformer,
                                     Trainer, TransformerConfig)
from ray_lightning_tpu_torch.core import LambdaCallback
from ray_lightning_tpu_torch.interop import (flax_state_dict, flax_weights,
                                             load_flax_params)
from ray_lightning_tpu_torch.models import remat, seq2seq
from ray_lightning_tpu_torch.ops import cuda_flash as cf
from ray_lightning_tpu_torch.ops import dropout
from ray_lightning_tpu_torch.reliability import FaultPlan, InjectedFault

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

WIDTHS = dict(vocab_size=32, max_seq_len=12, d_model=64, n_heads=4,
              n_layers=2, d_ff=128, causal=True)
POLICIES = [None, "dots", "dots_with_no_batch_dims",
            "dots_with_no_batch_dims_save_attn",
            "dots_with_no_batch_dims_save_attn_mlp"]
RATE, SEED = 0.1, 1234
B, S, T = 3, 6, 4


def jax_cfg(**kw):
    return JaxTransformerConfig(**{**WIDTHS, "dtype": jnp.float32, **kw})


def port_cfg(**kw):
    return TransformerConfig(**{**WIDTHS, "dtype": torch.float32, **kw})


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 32, (B, S)).astype(np.int32),
            rng.integers(1, 32, (B, T)).astype(np.int32))


def _mask(kind):
    """None, or (B, S): row 1 padded after 4 tokens; with ``"allpad"``
    row 2 all padding too."""
    if kind == "none":
        return None
    m = np.ones((B, S), np.int32)
    m[1, 4:] = 0
    if kind == "allpad":
        m[2] = 0
    return m


@functools.lru_cache(maxsize=None)
def _params(scan: bool = True):
    """The JAX module's initial params, its encoder scanned or unrolled
    (the same numbers: the unrolled tree is the scanned one unstacked)."""
    if not scan:
        return jax_unstack(_params(True))
    src, tgt = _tokens()
    model = jax_seq2seq.Seq2SeqTransformer(jax_cfg())
    return jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), src, tgt)["params"])


@pytest.fixture(scope="module", params=[True, False], ids=["scan", "unroll"])
def init(request):
    return request.param, _params(request.param)


@functools.lru_cache(maxsize=None)
def _jax_grad(cfg):
    """JAX's loss (mean cross-entropy against the target tokens), logits,
    cross-attention block outputs and gradients for the module of
    ``cfg``, jitted once per config: calls with a source mask of one
    shape share a compile."""
    model = jax_seq2seq.Seq2SeqTransformer(cfg)

    def loss(p, src, tgt, mask):
        logits, state = model.apply(
            {"params": p}, src, tgt, src_mask=mask,
            capture_intermediates=lambda mdl, _: isinstance(
                mdl, jax_seq2seq.CrossAttention),
            mutable=["intermediates"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, tgt).mean()
        cross = [state["intermediates"][f"dec_{i}"]["cross_attn"]
                 ["__call__"][0] for i in range(cfg.n_layers)]
        return ce, (logits, cross)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_step(scan=True, kind="none", **kw):
    """``_jax_grad`` on ``_tokens()`` and ``_mask(kind)``: the loss,
    logits, gradients by port name, and the cross-attention blocks'
    outputs."""
    src, tgt = _tokens()
    (ce, (logits, cross)), grads = _jax_grad(jax_cfg(
        scan_layers=scan, **kw))(_params(scan), src, tgt, _mask(kind))
    return (float(ce), np.asarray(logits), flax_state_dict(grads),
            [np.asarray(c) for c in cross])


def _port_model(params, **kw):
    return load_flax_params(Seq2SeqTransformer(port_cfg(**kw),
                                               device="cpu"), params)


def _port_step(model, kind="none", **fw):
    src, tgt = map(torch.from_numpy, _tokens())
    mask = _mask(kind)
    logits = model(src, tgt,
                   src_mask=None if mask is None else torch.from_numpy(mask),
                   **fw)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tgt.reshape(-1).long())
    ce.backward()
    return (ce.detach(), logits.detach(),
            {n: p.grad for n, p in model.named_parameters()})


def _close(got, want, atol=1e-5):
    ce, logits, grads = got
    jce, jlogits, jgrads = want[:3]
    assert abs(ce.item() - jce) <= atol
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=atol, rtol=0)
    assert grads.keys() == jgrads.keys()
    for name, g in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy(), g, atol=atol,
                                   rtol=0, err_msg=name)


def _bitwise(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[2].keys() == b[2].keys()
    for name in a[2]:
        assert torch.equal(a[2][name], b[2][name]), name


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("impl", ["dot", "flash"])
@pytest.mark.parametrize("kind", ["none", "partial", "allpad"])
def test_loss_logits_and_grads_match_jax(impl, kind):
    got = _port_step(_port_model(_params(), attention_impl=impl), kind)
    assert got[1].dtype == torch.float32 and got[1].shape == (B, T, 32)
    _close(got, _jax_step(kind=kind, attention_impl=impl))


def test_the_unrolled_tree_loads_the_same_model():
    """The unrolled JAX tree gives the port bitwise the model the scanned
    tree gives, and JAX's unrolled module's step."""
    scanned = _port_model(_params(True), attention_impl="flash")
    unrolled = _port_model(_params(False), scan_layers=False,
                           attention_impl="flash")
    for (n, a), (m, b) in zip(scanned.state_dict().items(),
                              unrolled.state_dict().items(), strict=True):
        assert n == m and torch.equal(a, b), n
    _close(_port_step(unrolled, "allpad"),
           _jax_step(False, "allpad", attention_impl="flash"))


def test_an_all_padding_row_gets_exactly_zero_cross_attention():
    """Row 2's source is all padding: every decoder block's
    cross-attention core gives exactly 0 for it (JAX's block output,
    ``out`` of that 0 plus a zero bias, is exactly 0 too), and the other
    rows do not."""
    model = _port_model(_params())
    cores = []
    hooks = [b.cross_attn.out.register_forward_hook(
        lambda m, args, out: cores.append(args[0].detach()))
        for b in model.decoder_blocks()]
    _port_step(model, "allpad")
    for h in hooks:
        h.remove()
    assert len(cores) == WIDTHS["n_layers"]
    for core in cores:
        assert torch.count_nonzero(core[2]) == 0
        assert torch.count_nonzero(core[:2]) > 0
    for out in _jax_step(kind="allpad", attention_impl="dot")[3]:
        assert np.count_nonzero(out[2]) == 0 and np.count_nonzero(out[:2])


def test_bf16_logits_match_jax():
    """bf16 compute: the logits within 2 bf16 ulps of the largest logit
    (the frameworks round at other points inside LayerNorm, GELU and the
    matmuls; 1e-2 is below one ulp at these logits)."""
    model = load_flax_params(Seq2SeqTransformer(TransformerConfig(**WIDTHS),
                                                device="cpu"), _params())
    assert model.cfg.dtype == torch.bfloat16
    got = _port_step(model, "allpad")[1]
    src, tgt = _tokens()
    jmodel = jax_seq2seq.Seq2SeqTransformer(jax_cfg(dtype=jnp.bfloat16))
    want = np.asarray(jax.jit(jmodel.apply)(
        {"params": _params()}, src, tgt, src_mask=_mask("allpad")))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    top = np.exp2(np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.numpy(), want, atol=2 * top, rtol=0)


def test_cross_attention_never_reaches_the_flash_kernels(monkeypatch):
    """Under ``"flash"`` and no mask the flash forward runs once per
    encoder layer and once per decoder self-attention, never for the
    cross-attention; with a source mask the encoder takes the dense
    attention (JAX's rule) and only the decoder's self-attention is
    flash."""
    calls = []
    fwd = cf.flash_fwd

    def counted(q, k, v, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return fwd(q, k, v, causal)

    monkeypatch.setattr(cf, "flash_fwd", counted)
    model = _port_model(_params(), attention_impl="flash")
    n, H, D = WIDTHS["n_layers"], WIDTHS["n_heads"], 16
    src, tgt = map(torch.from_numpy, _tokens())
    model(src, tgt)
    assert calls == [((B, S, H, D), (B, S, H, D), False)] * n + \
        [((B, T, H, D), (B, T, H, D), True)] * n
    calls.clear()
    model(src, tgt, src_mask=torch.from_numpy(_mask("partial")))
    assert calls == [((B, T, H, D), (B, T, H, D), True)] * n


def test_init_draws_flax_defaults():
    """``reset_parameters`` draws what the JAX module's init draws: each
    Dense weight truncated at two standard deviations of its variance
    1 / in (``lecun_normal``), each embedding N(0, 1 / d), LayerNorm
    scales 1, biases 0; every leaf's standard deviation within 5% of
    JAX's (the widths of the reversal task's default config)."""
    cfg = dict(WIDTHS, vocab_size=512, max_seq_len=64, d_model=128, d_ff=256)
    jparams = _params_at(tuple(sorted(cfg.items())))
    model = Seq2SeqTransformer(TransformerConfig(**cfg), device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(3))
    sd = flax_state_dict(jparams)
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), sd[name]
        if want.std() == 0:
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        assert abs(got.std() / want.std() - 1) < 0.05, name
        if name.endswith("embed.weight") or name.endswith("pos.weight"):
            assert np.abs(got).max() > 3 * got.std(), name    # untruncated
        else:
            bound = 2 * (p.shape[1] ** -0.5) / 0.87962566103423978
            assert np.abs(got).max() <= bound + 1e-7, name


@functools.lru_cache(maxsize=None)
def _params_at(items):
    model = jax_seq2seq.Seq2SeqTransformer(JaxTransformerConfig(
        **dict(items)))
    tokens = np.zeros((1, 8), np.int32)
    return jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), tokens, tokens)["params"])


# ------------------------------------ tests/test_seq2seq.py's module tests
def _small():
    model = _port_model(_params())

    def run(src, tgt, mask=None):
        with torch.no_grad():
            return model(torch.tensor(src), torch.tensor(tgt),
                         src_mask=None if mask is None
                         else torch.tensor(mask)).numpy()
    return run


def test_shapes_and_finite():
    logits = _small()([[3, 5, 7, 2], [9, 1, 4, 6]],
                      [[2, 7, 5, 3], [6, 4, 1, 9]])
    assert logits.shape == (2, 4, 32) and np.isfinite(logits).all()


def test_decoder_is_causal_over_target():
    run = _small()
    la = run([[3, 5, 7, 2]], [[1, 2, 3, 4]])
    lb = run([[3, 5, 7, 2]], [[1, 2, 9, 9]])
    np.testing.assert_allclose(la[:, :2], lb[:, :2], rtol=1e-5, atol=1e-6)
    assert np.abs(la[:, 2:] - lb[:, 2:]).max() > 1e-4


def test_cross_attention_sees_source():
    run = _small()
    assert np.abs(run([[3, 5, 7, 2]], [[1, 2, 3, 4]])
                  - run([[8, 8, 8, 8]], [[1, 2, 3, 4]])).max() > 1e-4


def test_src_mask_hides_padding():
    run = _small()
    mask = [[1, 1, 0, 0]]
    np.testing.assert_allclose(run([[3, 5, 0, 0]], [[1, 2, 3, 4]], mask),
                               run([[3, 5, 9, 9]], [[1, 2, 3, 4]], mask),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_oversized_sequences_raise(side):
    """A source, then a target, longer than ``max_seq_len`` raise naming
    it, in both packages; so does a module whose ``seq_len`` exceeds it,
    and a config that is not causal."""
    long, short = np.zeros((1, 6), np.int32), np.zeros((1, 3), np.int32)
    if side == "jax":
        model = jax_seq2seq.Seq2SeqTransformer(jax_cfg(max_seq_len=4))
        call = lambda s, t: model.init(jax.random.PRNGKey(0), s, t)  # noqa
        module, cfg = jax_seq2seq.Seq2SeqModule, jax_cfg
        build = lambda c: jax_seq2seq.Seq2SeqTransformer(c).init(  # noqa
            jax.random.PRNGKey(0), short, short)
    else:
        model = Seq2SeqTransformer(port_cfg(max_seq_len=4), device="cpu")
        call = lambda s, t: model(torch.from_numpy(s),  # noqa
                                  torch.from_numpy(t))
        module, cfg = Seq2SeqModule, port_cfg
        build = lambda c: Seq2SeqTransformer(c, device="cpu")  # noqa
    with pytest.raises(ValueError, match="source length 6 exceeds "
                                         "max_seq_len=4"):
        call(long, short)
    with pytest.raises(ValueError, match="target length 6 exceeds "
                                         "max_seq_len=4"):
        call(short, long)
    with pytest.raises(ValueError, match="exceeds config.max_seq_len"):
        module(config=cfg(max_seq_len=8), seq_len=16)
    with pytest.raises(ValueError, match="needs cfg.causal=True"):
        build(cfg(causal=False))


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_is_bitwise_plain_and_matches_jax(policy):
    """Remat under each policy (``"flash"``, a padded source: the
    encoder dense, the decoder's self-attention flash): bitwise the plain
    step, and within 1e-5 of JAX's step (a policy chooses what autograd
    keeps, never a value; every policy is held to the one JAX step)."""
    kw = dict(attention_impl="flash")
    got = _port_step(_port_model(_params(), remat=True, remat_policy=policy,
                                 **kw), "allpad")
    _bitwise(got, _port_step(_port_model(_params(), **kw), "allpad"))
    _close(got, _jax_step(kind="allpad", **kw))


# ----------------------------------------------- what a block keeps
def _block_bytes(policy, Bb=2, Tb=5, Sb=7):
    """The bytes ``count_saved`` counts for one rematerialized f32
    decoder block (input, memory and mask non-leaf tensors), and what
    the policy table predicts for it."""
    cfg = port_cfg(remat=True, remat_policy=policy)
    block = seq2seq.DecoderBlock(cfg, "cpu")
    seq2seq.init_params(block, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    d, H, Dh, F = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    x = torch.randn(Bb, Tb, d, generator=g).requires_grad_() * 1.0
    memory = torch.randn(Bb, Sb, d, generator=g).requires_grad_() * 1.0
    mask = torch.zeros(Bb, 1, 1, Sb)
    with remat.count_saved() as counter:
        out = block(x, memory, mask)
    out.sum().backward()
    N, M, f32 = Bb * Tb, Bb * Sb, 4
    inputs = N * d + M * d + Bb * Sb
    weight_dots = (N * 3 * H * Dh + N * d          # self qkv, out
                   + N * H * Dh + M * 2 * H * Dh   # cross q, kv
                   + N * d                          # cross out
                   + N * F + N * d)                 # mlp up, down
    batch_dots = (Bb * H * Tb * Tb + Bb * H * Tb * Dh      # self
                  + Bb * H * Tb * Sb + Bb * H * Tb * Dh)   # cross
    keeps = {None: 0, "dots": weight_dots + batch_dots,
             "dots_with_no_batch_dims": weight_dots,
             # the self-attention's output (attn_out); the cross-attention
             # has no seat and is replayed
             "dots_with_no_batch_dims_save_attn": weight_dots + N * H * Dh,
             "dots_with_no_batch_dims_save_attn_mlp":
                 weight_dots + N * H * Dh + N * F}[policy]
    return counter.bytes, f32 * (inputs + keeps)


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_a_decoder_block_keeps_what_the_policy_table_predicts(policy):
    got, want = _block_bytes(policy)
    assert got == want


# ------------------------------------------------------------ the fit
FIT = dict(max_epochs=1, limit_train_batches=4, limit_val_batches=1, seed=0)
MODULE = dict(batch_size=8, seq_len=8, num_samples=64, vocab_size=32,
              lr=3e-3)
METRICS = {"train_loss", "train_acc", "val_loss", "val_acc"}


@pytest.fixture(scope="module")
def jax_fit():
    """The JAX trainer's 4-step fit: initial and final params, per-step
    losses, callback metrics and global step."""
    out = {"losses": []}

    def on_fit_start(trainer, module):
        out["init"] = jax.tree_util.tree_map(np.array,
                                             trainer.train_state.params)

    def on_batch_end(trainer, module, outputs, batch, batch_idx):
        out["losses"].append(float(np.asarray(outputs["loss"])))

    trainer = JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                         callbacks=[JaxLambda(on_fit_start=on_fit_start,
                                              on_train_batch_end=on_batch_end
                                              )], **FIT)
    trainer.fit(jax_seq2seq.Seq2SeqModule(config=jax_cfg(max_seq_len=8),
                                          **MODULE))
    out.update(final=jax.tree_util.tree_map(np.array,
                                            trainer.train_state.params),
               metrics={k: float(v)
                        for k, v in trainer.callback_metrics.items()},
               global_step=trainer.global_step)
    return out


class Loaded(Seq2SeqModule):
    """``Seq2SeqModule`` started from a flax tree."""

    def __init__(self, init, **kw):
        super().__init__(**kw)
        self.init = init

    def init_variables(self, model, generator, batch):
        load_flax_params(model, self.init)


def test_fit_matches_the_jax_trainer(jax_fit):
    losses = []
    trainer = Trainer(strategy=RayStrategy(device="cpu"),
                      callbacks=[LambdaCallback(
                          on_train_batch_end=lambda tr, m, outputs, b, i:
                          losses.append(float(outputs["loss"])))], **FIT)
    trainer.fit(Loaded(jax_fit["init"], config=port_cfg(max_seq_len=8),
                       **MODULE))
    assert trainer.global_step == jax_fit["global_step"] == 4
    np.testing.assert_allclose(losses, jax_fit["losses"], atol=1e-5,
                               rtol=0)
    assert set(trainer.callback_metrics) == set(jax_fit["metrics"]) \
        == METRICS
    for key, value in jax_fit["metrics"].items():
        np.testing.assert_allclose(float(trainer.callback_metrics[key]),
                                   value, atol=1e-5, rtol=0, err_msg=key)
    assert_fit_params({n: p.detach().numpy() for n, p in
                       trainer.model.named_parameters()},
                      flax_state_dict(jax_fit["final"]), MODULE["lr"], 4)


def assert_fit_params(got, want, lr, steps):
    """A fit's final params (name -> numpy) against the JAX trainer's
    (``test_torch_moe.assert_fit_params``' rules for AdamW): within
    1e-5, but AdamW's normalized step follows the sign of a near-zero
    gradient, so a few elements in a thousand may take it the other way,
    none further than its steps; and the attention's key biases, whose
    gradient is zero in exact arithmetic (the softmax is shift-invariant
    along the keys), are held to those steps alone."""
    assert got.keys() == want.keys()
    hd = WIDTHS["d_model"]
    for name, g in got.items():
        w = want[name]
        keys = {"qkv.bias": slice(hd, 2 * hd),      # (3, H, D): k second
                "kv.bias": slice(0, hd)}.get(      # (2, H, D): k first
                    ".".join(name.split(".")[-2:]))
        if keys is not None:
            assert np.abs(g[keys] - w[keys]).max() <= 2 * lr * steps, name
            g, w = np.delete(g, keys), np.delete(w, keys)
        d = np.abs(g - w)
        assert (d > 1e-5).mean() <= 1e-3, name
        assert d.max() <= 2 * lr * steps, name


def test_reversal_pairs_are_byte_equal():
    for seed in (0, 1, 2):
        for a, b in zip(seq2seq._reversal_pairs(20, 8, 64, seed),
                        jax_seq2seq._reversal_pairs(20, 8, 64, seed),
                        strict=True):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ------------------------------------------------------------ dropout
def test_dropout_matches_jax_on_its_masks(monkeypatch):
    """The JAX module with ``dropout=0.1`` returns every keep mask it
    draws, in draw order (per encoder layer: attention, MLP; per decoder
    layer: self-attention, cross-attention, MLP); fed to the port in that
    order through ``dropout_keep``, loss, logits and gradients within
    1e-5."""
    src, tgt = _tokens()
    mask = _mask("allpad")
    masks = []
    draw = jax.random.bernoulli

    def recorded(key, p=0.5, shape=None, mode="low"):
        out = draw(key, p, shape, mode)
        masks.append(out)
        return out

    jmodel = jax_seq2seq.Seq2SeqTransformer(jax_cfg(scan_layers=False,
                                                    dropout=RATE))

    def loss(p):
        masks.clear()
        logits = jmodel.apply({"params": p}, src, tgt, src_mask=mask,
                              deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(1)})
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, tgt).mean()
        return ce, (logits, list(masks))

    monkeypatch.setattr(jax.random, "bernoulli", recorded)
    (ce, (logits, drawn)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(_params(False))
    monkeypatch.setattr(jax.random, "bernoulli", draw)
    n = WIDTHS["n_layers"]
    assert [m.ndim for m in drawn] == [4, 3] * n + [4, 4, 3] * n
    fed = iter(np.asarray(m) for m in drawn)

    def keep(seed, shape, rate, device):
        out = torch.from_numpy(next(fed).copy())
        assert tuple(out.shape) == tuple(shape) and rate == RATE
        return out

    monkeypatch.setattr(dropout, "dropout_keep", keep)
    got = _port_step(_port_model(_params(), dropout=RATE), "allpad",
                     deterministic=False, dropout_seed=SEED)
    assert next(fed, None) is None
    _close(got, (float(ce), np.asarray(logits), flax_state_dict(grads)))


def test_deterministic_equals_dropout_zero():
    _bitwise(_port_step(_port_model(_params(), dropout=RATE), "partial"),
             _port_step(_port_model(_params()), "partial"))


def test_no_two_sites_draw_one_seed(monkeypatch):
    """One training forward draws 2 masks per encoder layer and 3 per
    decoder layer, each from its own seed; a seed gives the same step
    again and another seed another step; the kept share of a large mask
    lies within 5 standard deviations of 1 - rate."""
    seeds = []
    real = dropout.dropout_keep

    def spy(seed, shape, rate, device):
        seeds.append(seed)
        return real(seed, shape, rate, device)

    monkeypatch.setattr(dropout, "dropout_keep", spy)
    model = _port_model(_params(), dropout=RATE)
    src, tgt = map(torch.from_numpy, _tokens())
    a = model(src, tgt, deterministic=False, dropout_seed=SEED)
    n = WIDTHS["n_layers"]
    assert len(seeds) == 5 * n and len(set(seeds)) == 5 * n
    assert set(seeds) == {dropout.site_seed(SEED, layer, site)
                          for layer in range(2 * n)
                          for site in ((dropout.ATTENTION, dropout.MLP)
                                       if layer < n else
                                       (dropout.ATTENTION, dropout.CROSS,
                                        dropout.MLP))}
    b = model(src, tgt, deterministic=False, dropout_seed=SEED)
    c = model(src, tgt, deterministic=False, dropout_seed=SEED + 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    size = 1 << 20
    kept = real(dropout.site_seed(SEED, n, dropout.CROSS), (size,), RATE,
                "cpu").sum().item()
    p = 1.0 - RATE
    assert abs(kept - size * p) <= 5 * (size * p * (1 - p)) ** 0.5


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_replays_the_dropout_masks(policy):
    fw = dict(deterministic=False, dropout_seed=SEED)
    _bitwise(_port_step(_port_model(_params(), dropout=RATE, remat=True,
                                    remat_policy=policy), "allpad", **fw),
             _port_step(_port_model(_params(), dropout=RATE), "allpad",
                        **fw))


def test_dropout_fit_resumes_bitwise(tmp_path):
    """``dropout=0.1``: each step draws its masks' seed from the step
    generator, which the checkpoint carries; a fit killed at step 4 of 6
    and resumed from the stream save at step 4 equals the uninterrupted
    fit bit for bit (params, optimizer state, losses)."""
    kw = dict(max_epochs=2, limit_train_batches=3, limit_val_batches=1,
              seed=0)

    def module():
        return Seq2SeqModule(config=port_cfg(max_seq_len=8, dropout=RATE),
                             **MODULE)

    def trainer(root, losses=None, **extra):
        cbs = list(extra.pop("callbacks", []))
        if losses is not None:
            cbs.append(LambdaCallback(
                on_train_batch_end=lambda tr, m, out, b, i:
                losses.append((tr.global_step, out["loss"].item()))))
        return Trainer(strategy=RayStrategy(device="cpu"),
                       default_root_dir=root, callbacks=cbs, **kw, **extra)

    ref_losses, losses = [], []
    ref = trainer(str(tmp_path / "ref"), ref_losses)
    ref.fit(module())
    ck = dict(dirpath=os.path.join(str(tmp_path), "ck"),
              save_format="stream", every_n_train_steps=2, save_top_k=-1)
    with pytest.raises(InjectedFault):
        with FaultPlan.at("train.step", [4]).armed():
            trainer(str(tmp_path), callbacks=[ModelCheckpoint(**ck)]).fit(
                module())
    resumed = trainer(str(tmp_path), losses,
                      callbacks=[ModelCheckpoint(**ck)], resume="auto")
    resumed.fit(module())
    assert resumed.resumed_from.endswith(".ckpt")
    assert resumed.global_step == ref.global_step == 6
    assert [s for s, _ in losses] == [5, 6]
    assert losses == ref_losses[-2:]
    got, want = (t.train_state.state_dict() for t in (resumed, ref))
    assert set(got["params"]) == set(want["params"])
    for k in want["params"]:
        assert torch.equal(got["params"][k], want["params"][k]), k
    for i, st in want["opt_state"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["opt_state"]["state"][i][k], v), (i, k)


# ------------------------------------------------------------ converter
def test_converter_round_trips_through_the_flax_layout(init):
    """Every port parameter's flax-layout view (``flax_weights`` for the
    matrices, a reshape for the biases) is the unrolled flax leaf it was
    loaded from, leaf for leaf."""
    scan, params = init
    model = _port_model(params, scan_layers=scan)
    port = dict(model.named_parameters())
    views = flax_weights(model)
    assert set(views) == {n for n, p in port.items() if p.ndim >= 2}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax_unstack(params))[0]:
        keys = [k.key for k in path]
        name = ".".join(
            [f"blocks.{k[6:]}" if k.startswith("block_") else k
             for k in keys[:-1]]
            + [{"kernel": "weight", "scale": "weight",
                "embedding": "weight"}.get(keys[-1], keys[-1])])
        p = port.pop(name).detach()
        view = views.get(name, p.reshape(leaf.shape))
        assert tuple(view.shape) == leaf.shape, name
        np.testing.assert_array_equal(view.numpy(), leaf, err_msg=name)
    assert not port


@pytest.mark.parametrize("what", ["extra", "missing"])
def test_converter_refuses_a_tree_that_does_not_fit(init, what):
    scan, params = init
    params = jax.tree_util.tree_map(lambda x: x, params)
    cross = params["dec_1"]["cross_attn"]
    if what == "extra":
        cross["k"] = dict(cross["q"])
    else:
        del cross["kv"]["bias"]
    with pytest.raises(RuntimeError, match="Unexpected|Missing"):
        _port_model(params, scan_layers=scan)
