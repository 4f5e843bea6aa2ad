"""The encoder family and MNIST (ROADMAP A, item 8, first half) against the JAX package.

In f32 on the CPU, with the JAX package's weights carried across by
``interop`` and the same numpy inputs (the JAX ``"flash"`` impl on its
blockwise XLA path, the port's on the flash kernels' plain versions):

- ``TransformerEncoder``'s output within 1e-5 of JAX's, ``dot`` and
  ``flash``, with and without a padding mask (a row whose every key is
  masked among them), and with segment ids on an encoder that has a
  segment table; the attention of a fully masked row exactly 0 in both;
- the parameter trees: the port's names and counts are the JAX tree's,
  BERT's without ``seg_embed`` (flax creates it only in a call that
  passes segment ids);
- ``BertClassifier``, ``ViTClassifier`` (17 tokens: the patch order) and
  ``MNISTNet`` logits within 1e-5;
- ``BertModule``, ``ViTModule`` (its default remat policy) and
  ``LightningMNISTClassifier`` through the port's ``Trainer`` against the
  JAX ``Trainer``, 4 AdamW steps from the same weights: per-step losses
  and ``callback_metrics`` within 1e-4, the same metric keys and
  ``global_step``;
- the copied generators byte-equal to JAX's, the argument checks raising
  as JAX's do, and a converter that refuses a tree with a leaf too many
  or too few.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_lightning_tpu import models as jax_models
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import LambdaCallback as JaxLambda
from ray_lightning_tpu.data import synthetic as jax_synthetic
from ray_lightning_tpu.models import bert as jax_bert
from ray_lightning_tpu.models import mnist as jax_mnist
from ray_lightning_tpu.models import vit as jax_vit
from ray_lightning_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from ray_lightning_tpu.models.transformer import \
    TransformerEncoder as JaxTransformerEncoder
from ray_lightning_tpu.ops.attention import \
    dot_product_attention as jax_dot_attention
from ray_lightning_tpu_torch import (BertClassifier, BertModule,
                                     LightningMNISTClassifier, MNISTNet,
                                     RayStrategy, Trainer,
                                     TransformerConfig, TransformerEncoder,
                                     ViTClassifier, ViTModule, bert_config,
                                     vit_config)
from ray_lightning_tpu_torch.core import LambdaCallback
from ray_lightning_tpu_torch.data import synthetic
from ray_lightning_tpu_torch.interop import flax_state_dict, load_flax_params
from ray_lightning_tpu_torch import models as port_models
from ray_lightning_tpu_torch.models import bert, vit
from ray_lightning_tpu_torch.models.transformer import padding_mask
from ray_lightning_tpu_torch.ops.attention import dot_product_attention

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

ENC = dict(vocab_size=64, max_seq_len=16, d_model=32, n_heads=2, n_layers=2,
           d_ff=64, causal=False, num_segments=2)
FIT = dict(max_epochs=1, limit_train_batches=4, limit_val_batches=1, seed=0)


def _np_tokens(seed, B=3, T=16, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (B, T),
                                                dtype=np.int32)


def _padding(B=3, T=16):
    """Row 0 whole, row 1 padded after 9 tokens, row 2 with every key
    masked."""
    m = np.ones((B, T), np.int32)
    m[1, 9:] = 0
    m[2] = 0
    return m


def _close(got: torch.Tensor, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def _init(module, *args, **kw):
    return jax.tree_util.tree_map(
        np.asarray, module.init(jax.random.PRNGKey(0), *args, **kw)["params"])


# ----------------------------------------------------------- generators
GENERATORS = {
    "mnist": lambda m: m.synthetic_mnist(96, seed=3),
    "mnist-args": lambda m: m.synthetic_mnist(40, num_classes=4,
                                              image_size=8, noise=0.5,
                                              seed=1, proto_seed=7),
    "images": lambda m: m.synthetic_images(24, seed=2),
    "images-args": lambda m: m.synthetic_images(10, num_classes=3,
                                                image_size=9, channels=1,
                                                noise=0.2, seed=5,
                                                proto_seed=11),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_image_generators_are_byte_equal(name):
    got, want = GENERATORS[name](synthetic), GENERATORS[name](jax_synthetic)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_generators_are_byte_equal(seed):
    for got, want in (
            (bert._synthetic_classification_tokens(20, 12, 100, 3, seed),
             jax_bert._synthetic_classification_tokens(20, 12, 100, 3,
                                                       seed)),
            (vit._synthetic_images(6, 8, 5, seed),
             jax_vit._synthetic_images(6, 8, 5, seed))):
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -------------------------------------------------------------- encoder
ENCODER_CASES = {
    "dot": ("dot", False, False), "flash": ("flash", False, False),
    "dot-mask": ("dot", True, False), "flash-mask": ("flash", True, False),
    "dot-segments": ("dot", False, True),
    "flash-mask-segments": ("flash", True, True),
}


@pytest.mark.parametrize("case", list(ENCODER_CASES))
def test_encoder_matches_jax(case):
    impl, masked, segmented = ENCODER_CASES[case]
    toks = _np_tokens(0)
    mask = _padding() if masked else None
    seg = (np.random.default_rng(1).integers(0, 2, toks.shape)
           .astype(np.int32) if segmented else None)
    jenc = JaxTransformerEncoder(JaxTransformerConfig(
        attention_impl=impl, dtype=jnp.float32, **ENC))
    params = _init(jenc, toks, segment_ids=seg)
    assert ("seg_embed" in params) == segmented
    want = jenc.apply({"params": params}, toks, attention_mask=mask,
                      segment_ids=seg)
    enc = load_flax_params(TransformerEncoder(TransformerConfig(
        attention_impl=impl, dtype=torch.float32, **ENC), device="cpu",
        segments=segmented), params)
    got = enc(torch.from_numpy(toks),
              attention_mask=None if mask is None else torch.from_numpy(mask),
              segment_ids=None if seg is None else torch.from_numpy(seg))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


def test_a_fully_masked_row_attends_to_nothing():
    """The attention of a row whose every key is masked is exactly 0 in
    both packages, and the other rows equal JAX's."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((3, 16, 2, 8)).astype(np.float32)
               for _ in range(3))
    m = _padding()
    want = np.asarray(jax_dot_attention(
        q, k, v, mask=jnp.where(m[:, None, None, :] > 0, 0.0,
                                jnp.finfo(jnp.float32).min)))
    got = dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                mask=padding_mask(torch.from_numpy(m)))
    assert np.count_nonzero(want[2]) == 0
    assert torch.count_nonzero(got[2]) == 0
    _close(got, want)


@pytest.mark.parametrize("segments", [False, True], ids=["bert", "segments"])
def test_parameter_trees_match_jax(segments):
    """Names and counts of the port's parameters are the JAX tree's;
    BERT's tree has no segment table."""
    toks = _np_tokens(3)
    if segments:
        jmod = JaxTransformerEncoder(JaxTransformerConfig(
            dtype=jnp.float32, **ENC))
        params = _init(jmod, toks, segment_ids=np.zeros_like(toks))
        model = TransformerEncoder(TransformerConfig(dtype=torch.float32,
                                                     **ENC), device="cpu",
                                   segments=True)
    else:
        jcfg = jax_bert.bert_config("tiny", vocab_size=64, max_seq_len=16)
        params = _init(jax_bert.BertClassifier(jcfg), toks)
        assert sorted(params["encoder"]) == ["embed_ln", "pos_embed",
                                             "stack", "tok_embed"]
        model = BertClassifier(bert_config("tiny", vocab_size=64,
                                           max_seq_len=16), device="cpu")
        assert model.encoder.seg_embed is None
    sd = flax_state_dict(params)
    got = dict(model.named_parameters())
    assert set(got) == set(sd)
    assert ("seg_embed.weight" in got) == segments
    for name, p in got.items():
        assert tuple(p.shape) == sd[name].shape, name
    assert sum(p.numel() for p in got.values()) == sum(
        x.size for x in jax.tree_util.tree_leaves(params))


def test_segments_need_a_table():
    cfg = TransformerConfig(dtype=torch.float32, **ENC)
    enc = TransformerEncoder(cfg, device="cpu")
    with pytest.raises(ValueError, match="segment"):
        enc(torch.zeros(1, 4, dtype=torch.long),
            segment_ids=torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="num_segments"):
        TransformerEncoder(TransformerConfig(dtype=torch.float32,
                                             **dict(ENC, num_segments=0)),
                           device="cpu", segments=True)


# -------------------------------------------------------------- models
def _bert_logits(impl, masked):
    toks = _np_tokens(4, vocab=128)
    mask = _padding() if masked else None
    jmodel = jax_bert.BertClassifier(jax_bert.bert_config(
        "tiny", vocab_size=128, max_seq_len=16, attention_impl=impl,
        dtype=jnp.float32), num_classes=3)
    params = _init(jmodel, toks)
    want = jmodel.apply({"params": params}, toks, attention_mask=mask)
    model = load_flax_params(BertClassifier(bert_config(
        "tiny", vocab_size=128, max_seq_len=16, attention_impl=impl,
        dtype=torch.float32), num_classes=3, device="cpu"), params)
    got = model(torch.from_numpy(toks), attention_mask=None if mask is None
                else torch.from_numpy(mask))
    return got, want


@pytest.mark.parametrize("impl", ["dot", "flash"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_bert_classifier_matches_jax(impl, masked):
    got, want = _bert_logits(impl, masked)
    assert got.dtype == torch.float32 and got.shape == (3, 3)
    _close(got, want)


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_vit_classifier_matches_jax(impl):
    """image 16, patch 4: 16 patches + CLS, so a patch-order slip shows."""
    images = np.random.default_rng(5).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)
    jcfg = jax_vit.vit_config("tiny", 16, 4, attention_impl=impl,
                              dtype=jnp.float32)
    jmodel = jax_vit.ViTClassifier(jcfg, num_classes=10, patch_size=4)
    params = _init(jmodel, images)
    assert params["patch_embed"]["kernel"].shape == (4, 4, 3, 192)
    want = jmodel.apply({"params": params}, images)
    model = load_flax_params(ViTClassifier(vit_config(
        "tiny", 16, 4, attention_impl=impl, dtype=torch.float32),
        num_classes=10, patch_size=4, device="cpu"), params)
    assert model.patch_embed.weight.shape == (192, 3, 4, 4)
    got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    _close(got, want)


def test_mnist_net_matches_jax():
    x = np.random.default_rng(6).standard_normal((5, 784)).astype(np.float32)
    jmodel = jax_mnist.MNISTNet()
    params = _init(jmodel, x)
    assert sorted(params) == ["Dense_0", "Dense_1", "Dense_2"]
    model = load_flax_params(MNISTNet(device="cpu"), params)
    _close(model(torch.from_numpy(x)), jmodel.apply({"params": params}, x))


@pytest.mark.parametrize("what", ["extra", "missing"])
def test_converter_refuses_a_tree_that_does_not_fit(what):
    x = np.zeros((1, 784), np.float32)
    params = _init(jax_mnist.MNISTNet(), x)
    if what == "extra":
        params["Dense_3"] = {"kernel": np.zeros((10, 2), np.float32),
                             "bias": np.zeros(2, np.float32)}
    else:
        del params["Dense_2"]["bias"]
    with pytest.raises(RuntimeError, match="Unexpected|Missing"):
        load_flax_params(MNISTNet(device="cpu"), params)


# ---------------------------------------------------- argument checks
# each raised by the JAX package's models and the port's alike
CHECKS = {
    "bert-seq-len": (lambda m: m.BertModule(
        config=m.bert_config("tiny", max_seq_len=16), seq_len=32),
        ValueError, "exceeds config.max_seq_len"),
    "vit-patch": (lambda m: m.vit_config("tiny", 30, 4), ValueError,
                  "divisible"),
    "vit-size": (lambda m: m.vit_config("huge"), ValueError,
                 "Unknown ViT size"),
    "vit-module-patch": (lambda m: m.ViTModule(
        config=m.vit_config("tiny", 32, 4), image_size=30, patch_size=4),
        ValueError, "not divisible"),
    "vit-module-seq": (lambda m: m.ViTModule(
        config=m.vit_config("tiny", 16, 4), image_size=32, patch_size=4),
        ValueError, "too small"),
    "remat-policy": (lambda m: m.vit_config(
        "tiny", remat=False, remat_policy="dots"), ValueError,
        "remat_policy is set but remat=False"),
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_argument_checks_raise_as_jax(case):
    make, exc, match = CHECKS[case]
    for side in (jax_models, port_models):
        with pytest.raises(exc, match=match):
            make(side)


def test_vit_remat_false_drops_the_default_policy():
    assert vit_config("tiny", remat=False).remat_policy is None
    assert jax_vit.vit_config("tiny", remat=False).remat_policy is None


# ------------------------------------------------------------ the fits
def _jax_modules():
    f32 = dict(dtype=jnp.float32)
    return {
        "bert": lambda: jax_bert.BertModule(
            config=jax_bert.bert_config("tiny", vocab_size=128,
                                        max_seq_len=16, **f32),
            num_classes=3, batch_size=4, num_samples=32, lr=1e-3),
        "vit": lambda: jax_vit.ViTModule(
            config=jax_vit.vit_config("tiny", 16, 4, **f32), image_size=16,
            patch_size=4, batch_size=4, num_samples=32),
        "mnist": lambda: jax_mnist.LightningMNISTClassifier(
            config={"batch_size": 8}, num_samples=64),
    }


def _port_module(name, init):
    f32 = dict(dtype=torch.float32)
    cls, kw = {
        "bert": (BertModule, dict(
            config=bert_config("tiny", vocab_size=128, max_seq_len=16,
                               **f32),
            num_classes=3, batch_size=4, num_samples=32, lr=1e-3)),
        "vit": (ViTModule, dict(
            config=vit_config("tiny", 16, 4, **f32), image_size=16,
            patch_size=4, batch_size=4, num_samples=32)),
        "mnist": (LightningMNISTClassifier, dict(config={"batch_size": 8},
                                                 num_samples=64)),
    }[name]

    class Loaded(cls):
        def init_variables(self, model, generator, batch):
            load_flax_params(model, init)

    return Loaded(**kw)


METRICS = {
    "bert": {"train_loss", "train_acc", "val_loss", "val_acc"},
    "vit": {"train_loss", "train_acc", "val_loss", "val_acc"},
    "mnist": {"train_loss", "ptl/train_loss", "ptl/train_accuracy",
              "ptl/val_loss", "ptl/val_accuracy"},
}


@pytest.fixture(scope="session", params=sorted(METRICS))
def jax_zoo_fit(request):
    """The JAX trainer's 4-step fit: its initial params, per-step losses,
    callback metrics and global step."""
    out = {"name": request.param, "losses": []}

    def on_fit_start(trainer, module):
        out["init"] = jax.tree_util.tree_map(np.array,
                                             trainer.train_state.params)

    def on_batch_end(trainer, module, outputs, batch, batch_idx):
        out["losses"].append(float(np.asarray(outputs["loss"])))

    trainer = JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                         callbacks=[JaxLambda(
                             on_fit_start=on_fit_start,
                             on_train_batch_end=on_batch_end)], **FIT)
    trainer.fit(_jax_modules()[request.param]())
    out.update(metrics={k: float(v)
                        for k, v in trainer.callback_metrics.items()},
               global_step=trainer.global_step)
    return out


def test_zoo_fit_matches_the_jax_trainer(jax_zoo_fit):
    name = jax_zoo_fit["name"]
    losses = []
    trainer = Trainer(strategy=RayStrategy(device="cpu"),
                      callbacks=[LambdaCallback(
                          on_train_batch_end=lambda tr, m, outputs, b, i:
                          losses.append(float(outputs["loss"])))], **FIT)
    trainer.fit(_port_module(name, jax_zoo_fit["init"]))
    assert trainer.global_step == jax_zoo_fit["global_step"] == 4
    np.testing.assert_allclose(losses, jax_zoo_fit["losses"], atol=1e-4,
                               rtol=0)
    want = jax_zoo_fit["metrics"]
    assert set(trainer.callback_metrics) == set(want) == METRICS[name]
    for key, value in want.items():
        np.testing.assert_allclose(float(trainer.callback_metrics[key]),
                                   value, atol=1e-4 * max(1.0, abs(value)),
                                   rtol=0, err_msg=key)
