"""ResNet with BatchNorm state (ROADMAP A, item 8, ``resnet``) against the JAX package.

In f32 on the CPU, with the JAX module's flax variables (``params`` and
``batch_stats``) carried across by ``interop.load_flax_params`` and the
same numpy images:

- ``ResNet``'s train-mode logits and the ``batch_stats`` flax's mutable
  apply returns, and its eval-mode logits on the running averages,
  within 1e-5, for basic and bottleneck blocks, both stems and image
  sizes 32, 17 and 224 (the odd size and the stride-2 convolutions are
  where ``"SAME"``'s asymmetric padding shows); bf16 logits against
  JAX's bf16 within a stated bound;
- ``ResNetModule(depth=10)`` (narrowed to ``num_filters=8``) through the
  port's ``Trainer`` against the JAX ``Trainer``, 4 SGD-Nesterov steps
  from the same variables: per-step losses, then params and running
  statistics, within 1e-5; with a NaN batch under the non-finite guard
  (the running statistics kept, as JAX's ``keep`` keeps
  ``model_state``) and under ``accumulate_grad_batches=2`` (they move on
  every mini-batch, as JAX's ``model_state`` does);
- the stream, directory and in-memory resumes of a killed fit bitwise
  the uninterrupted fit, buffers included;
- the running statistics set after the trainer's ``to_empty``, the
  converter's refusal of a bare ResNet param tree, the three-value step
  refused with a message that names buffers, and the counterparts of
  ``tests/test_models.py``'s ResNet cases;
- ``count_params`` equal to JAX's on ResNet-18 and GPT-2-small.
"""
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import LambdaCallback as JaxLambda
from ray_lightning_tpu.models import gpt as jax_gpt
from ray_lightning_tpu.models import resnet as jax_resnet
from ray_lightning_tpu.reliability import FaultPlan as JaxFaultPlan
from ray_lightning_tpu_torch import (ModelCheckpoint, RayStrategy, Trainer,
                                     count_params, gpt2_config, resnet18)
from ray_lightning_tpu_torch.core import LambdaCallback
from ray_lightning_tpu_torch.interop import flax_state_dict, load_flax_params
from ray_lightning_tpu_torch.models import resnet
from ray_lightning_tpu_torch.models.transformer import TransformerLM
from ray_lightning_tpu_torch.reliability import FaultPlan, InjectedFault
from ray_lightning_tpu_torch.reliability.elastic import MemoryCheckpointStore

import torch_world as tw

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

FIT = dict(max_epochs=1, limit_train_batches=4, limit_val_batches=1, seed=0)
BLOCKS = {"basic": (jax_resnet.ResNetBlock, resnet.ResNetBlock),
          "bottleneck": (jax_resnet.BottleneckBlock, resnet.BottleneckBlock)}
# bf16 logits: one bf16 ulp of the largest logit (|logits| < 2.3 here,
# 2.3 * 2**-8 < 1e-2); on the CPU both sides round alike (measured at
# most 7.2e-7 on these inputs)
BF16_TOL = 1e-2


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _close(got, want, tol=1e-5, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=what)


def _images(size, batch=4, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def _pair(block, small, dtype=None):
    """The JAX ResNet-10-shaped model at 8 filters, its variables moved
    off their init (scales and statistics perturbed, so no norm is
    trivial), and the port's twin loaded with them."""
    jb, pb = BLOCKS[block]
    kw = {} if dtype is None else {"dtype": dtype[0]}
    jm = jax_resnet.ResNet([1, 1, 1, 1], jb, num_classes=5, num_filters=8,
                           small_images=small, **kw)
    v = _np(jm.init(jax.random.PRNGKey(0), _images(8, 1), train=False))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    pm = resnet.ResNet([1, 1, 1, 1], pb, num_classes=5, num_filters=8,
                       small_images=small, device="cpu",
                       **({} if dtype is None else {"dtype": dtype[1]}))
    return jm, v, load_flax_params(pm, v)


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("size", [32, 17, 224])
@pytest.mark.parametrize("small", [True, False], ids=["cifar", "imagenet"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_resnet_matches_jax(block, small, size):
    x = _images(size, batch=2 if size == 224 else 4)
    jm, v, pm = _pair(block, small)
    logits, mutated = jm.apply(v, x, train=True, mutable=["batch_stats"])
    pm.train()
    got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (len(x), 5)
    _close(got, logits, what="train logits")
    want = flax_state_dict({"params": v["params"], **_np(mutated)})
    sd = pm.state_dict()
    assert set(sd) == set(want)
    for name in want:
        _close(sd[name], want[name], what=name)
    pm.eval()
    evald = jm.apply({"params": v["params"], **_np(mutated)}, x,
                     train=False)
    _close(pm(torch.from_numpy(x)), evald, what="eval logits")


def test_same_padding_is_xla_s():
    assert resnet.same_padding(32, 3, 2) == (0, 1)
    assert resnet.same_padding(224, 7, 2) == (2, 3)
    assert resnet.same_padding(17, 3, 2) == (1, 1)
    assert resnet.same_padding(32, 1, 2) == (0, 0)
    assert resnet.same_padding(32, 3, 1) == (1, 1)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_bf16_logits_within_bound_of_jax_bf16(block):
    x = _images(17)
    jm, v, pm = _pair(block, False, dtype=(jnp.bfloat16, torch.bfloat16))
    logits, mutated = jm.apply(v, x, train=True, mutable=["batch_stats"])
    pm.train()
    got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32       # the head stays f32
    assert all(t.dtype == torch.float32 for t in pm.state_dict().values())
    _close(got, logits, tol=BF16_TOL, what="bf16 train logits")


# ------------------------------------------------------------- the fits
class _JaxNarrow(jax_resnet.ResNetModule):
    """The JAX ``ResNetModule(depth=10)`` at ``num_filters=8``."""

    def configure_model(self):
        return jax_resnet.resnet10(self.num_classes, dtype=self.dtype,
                                   num_filters=8)


NARROW = dict(depth=10, batch_size=8, image_size=16, num_samples=32)


def _jax_fit(fault=None, **kw):
    """The JAX trainer's fit: initial and final variables (numpy), per-step
    losses, callback metrics, the trainer."""
    out = {"losses": []}

    def grab(tr, m):
        out["init"] = _np({"params": tr.train_state.params,
                           **tr.train_state.model_state})

    rec = JaxLambda(on_fit_start=grab,
                    on_train_batch_end=lambda tr, m, logs, b, i:
                    out["losses"].append(float(np.asarray(logs["loss"]))))
    trainer = JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                         callbacks=[rec], **{**FIT, **kw})
    if fault is None:
        trainer.fit(_JaxNarrow(**NARROW))
    else:
        with fault.armed():
            trainer.fit(_JaxNarrow(**NARROW))
    out["final"] = _np({"params": trainer.train_state.params,
                        **trainer.train_state.model_state})
    out["metrics"] = {k: float(v)
                      for k, v in trainer.callback_metrics.items()}
    out["trainer"] = trainer
    return out


@pytest.fixture(scope="module")
def jax_fits():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = {
                "plain": lambda: _jax_fit(),
                "guard": lambda: _jax_fit(
                    JaxFaultPlan.at("loader.next", [1], mode="nan"),
                    nonfinite_action="skip_batch"),
                "accumulate": lambda: _jax_fit(accumulate_grad_batches=2),
            }[name]()
        return cache[name]

    return get


def _port_fit(init, fault=None, **kw):
    losses = []
    trainer = Trainer(strategy=RayStrategy(device="cpu"),
                      callbacks=[LambdaCallback(
                          on_train_batch_end=lambda tr, m, outputs, b, i:
                          losses.append(float(outputs["loss"])))],
                      **{**FIT, **kw})
    if fault is None:
        trainer.fit(tw.NarrowResNet(init))
    else:
        with fault.armed():
            trainer.fit(tw.NarrowResNet(init))
    return trainer, losses


def _assert_state(trainer, final):
    """The port's params and buffers against JAX's final variables."""
    sd = trainer.train_state.state_dict()["params"]
    want = flax_state_dict(final)
    assert set(sd) == set(want)
    for name, w in want.items():
        _close(sd[name], w, what=name)


def test_fit_matches_the_jax_trainer(jax_fits):
    ref = jax_fits("plain")
    trainer, losses = _port_fit(ref["init"])
    assert trainer.global_step == ref["trainer"].global_step == 4
    np.testing.assert_allclose(losses, ref["losses"], atol=1e-5, rtol=0)
    _assert_state(trainer, ref["final"])
    assert set(trainer.callback_metrics) == set(ref["metrics"])
    for key, value in ref["metrics"].items():
        _close(float(trainer.callback_metrics[key]), value, what=key)
    # the running statistics moved off their start
    start = flax_state_dict(ref["init"])
    sd = trainer.train_state.state_dict()["params"]
    assert not np.allclose(sd["bn_init.running_var"].numpy(),
                           start["bn_init.running_var"])


def test_poisoned_step_keeps_the_buffers_as_jax(jax_fits):
    """A NaN batch under ``skip_batch``: the forward moved the running
    statistics to NaN before the verdict; the step puts them back, and
    the fit ends at JAX's variables (its ``keep`` of ``model_state``)."""
    ref = jax_fits("guard")
    trainer, losses = _port_fit(
        ref["init"], FaultPlan.at("loader.next", [1], mode="nan"),
        nonfinite_action="skip_batch")
    assert trainer.nonfinite_batches == ref["trainer"].nonfinite_batches == 1
    assert np.isnan(losses[1]) and np.isnan(ref["losses"][1])
    assert all(torch.isfinite(b).all() for b in trainer.model.buffers())
    _assert_state(trainer, ref["final"])


def test_accumulation_moves_the_buffers_every_mini_batch(jax_fits):
    ref = jax_fits("accumulate")
    trainer, losses = _port_fit(ref["init"], accumulate_grad_batches=2)
    np.testing.assert_allclose(losses, ref["losses"], atol=1e-5, rtol=0)
    _assert_state(trainer, ref["final"])


def test_the_guard_puts_back_the_buffers_of_a_bad_step():
    """The step alone: a NaN batch leaves params and running statistics
    bitwise as they were; a good one then moves them."""
    model = resnet.resnet10(num_classes=3, num_filters=8, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    state = _state(model, opt)
    step = RayStrategy(device="cpu").make_train_step(
        lambda m, b, g: (torch.nn.functional.cross_entropy(m(b[0]), b[1]),
                         {}), guard_nonfinite=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.from_numpy(_images(8))
    y = torch.tensor([0, 1, 2, 0])
    _, logs = step(state, (x * float("nan"), y))
    assert float(logs["nonfinite"]) == 1.0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    _, logs = step(state, (x, y))
    assert float(logs["nonfinite"]) == 0.0
    assert not torch.equal(model.bn_init.running_mean,
                           before["bn_init.running_mean"])


def _state(model, opt):
    from ray_lightning_tpu_torch.core.train_state import TrainState
    return TrainState(step=0, model=model, optimizer=opt,
                      generator=torch.Generator().manual_seed(0))


# ----------------------------------------------------------- checkpoints
def _ckpt_trainer(root, ck, fmt, **kw):
    return Trainer(strategy=RayStrategy(device="cpu"), max_epochs=3,
                   limit_train_batches=4, limit_val_batches=0, seed=0,
                   default_root_dir=root,
                   callbacks=[ModelCheckpoint(dirpath=ck, save_format=fmt)],
                   **kw)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ref"))
    t = _ckpt_trainer(root, os.path.join(root, "ck"), "stream")
    t.fit(tw.NarrowResNet())
    return t.train_state.state_dict()


def _assert_bitwise_params(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("tier", ["stream", "orbax", "memory"])
def test_resume_is_bitwise_the_uninterrupted_fit(tmp_path, uninterrupted,
                                                 tier):
    """Killed at step 9 (the epoch-2 checkpoint at step 8 committed),
    resumed with ``resume="auto"`` from the stream file, the directory
    (DCP) format or the in-memory tier: params, running statistics and
    optimizer state bitwise the uninterrupted fit's."""
    fmt = "stream" if tier == "memory" else tier
    ck = str(tmp_path / "ck")
    store = MemoryCheckpointStore(keep_last=2)
    with store.installed():
        with pytest.raises(InjectedFault):
            with FaultPlan.at("train.step", [9]).armed():
                _ckpt_trainer(str(tmp_path), ck, fmt).fit(tw.NarrowResNet())
        if tier != "memory":
            store.drop_rank(0)
        resumed = _ckpt_trainer(str(tmp_path), ck, fmt, resume="auto")
        resumed.fit(tw.NarrowResNet())
    if tier == "memory":
        assert resumed.resumed_from == "<memory:step=8>"
    else:
        assert resumed.resumed_from.endswith(
            ".ckpt" if fmt == "stream" else ".orbax")
    got = resumed.train_state.state_dict()
    assert got["step"] == uninterrupted["step"] == 12
    _assert_bitwise_params(got["params"], uninterrupted["params"])
    assert any(k.endswith("running_var") for k in got["params"])
    for i, st in uninterrupted["opt_state"]["state"].items():
        assert torch.equal(got["opt_state"]["state"][i]["momentum_buffer"],
                           st["momentum_buffer"])


# ------------------------------------------------------ state and checks
def test_buffers_are_set_after_to_empty():
    """The trainer builds the model on ``meta`` and ``to_empty``\\ s it,
    which leaves buffers uninitialised; ``reset_parameters`` (the
    default ``init_variables``) sets every running statistic."""
    seen = {}

    def grab(tr, m):
        seen.update({k: v.clone() for k, v in
                     tr.train_state.model.named_buffers()})

    Trainer(strategy=RayStrategy(device="cpu"), max_epochs=1,
            limit_train_batches=1, limit_val_batches=0,
            callbacks=[LambdaCallback(on_fit_start=grab)]).fit(
        tw.NarrowResNet())
    assert len(seen) == 2 * 12     # the stem, 8 in the blocks, 3 proj
    for name, t in seen.items():
        assert torch.equal(t, torch.zeros_like(t) if name.endswith("mean")
                           else torch.ones_like(t)), name
    model = resnet.resnet10(num_filters=8, device="meta").to_empty(
        device="cpu")
    for b in model.buffers():
        b.fill_(float("nan"))
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.isfinite(b).all() for b in model.buffers())
    last = [blk.BatchNorm_1.weight for blk in model.blocks]
    assert all(torch.equal(w, torch.zeros_like(w)) for w in last)
    assert torch.equal(model.bn_init.weight,
                       torch.ones_like(model.bn_init.weight))


def test_converter_refuses_a_tree_without_batch_stats():
    jm, v, pm = _pair("basic", True)
    with pytest.raises(RuntimeError, match="Missing.*running_mean"):
        load_flax_params(pm, v["params"])
    with pytest.raises(ValueError, match="collections"):
        load_flax_params(pm, {**v, "cache": {}})


def test_a_three_value_step_is_refused_naming_buffers():
    class ThreeValues(tw.NarrowResNet):
        def training_step(self, model, batch, generator):
            return super().training_step(model, batch, generator), {}, {}

    with pytest.raises(ValueError, match="buffers"):
        Trainer(strategy=RayStrategy(device="cpu"), max_epochs=1,
                limit_train_batches=1, limit_val_batches=0).fit(
            ThreeValues())


def test_resnet_batchstats_update():
    """``tests/test_models.py``'s case: the running statistics move
    through the step (the trainer's buffer path)."""
    trainer = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=1,
                      limit_train_batches=2, limit_val_batches=0)
    trainer.fit(resnet.ResNetModule(depth=10, batch_size=8, num_samples=32,
                                    lr=0.05))
    means = [b for n, b in trainer.train_state.model.named_buffers()
             if n.endswith("running_mean")]
    assert any(float(m.abs().max()) > 1e-6 for m in means), \
        "batch_stats never updated"


def test_resnet_depth_map_builds():
    x = torch.zeros(1, 8, 8, 3)
    for depth in (18, 50):
        model = resnet.ResNetModule(depth=depth).configure_model()
        model = model.to_empty(device="cpu")
        model.reset_parameters()
        model.eval()
        with torch.no_grad():
            assert model(x).shape == (1, 10)


def test_resnet_learns():
    trainer = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=2,
                      limit_train_batches=8, limit_val_batches=4, seed=0)
    trainer.fit(tw.NarrowResNet(batch_size=16, num_samples=128, lr=0.05))
    assert float(trainer.callback_metrics["val_acc"]) > 0.5


# ------------------------------------------------------------ the counts
def test_count_params_equals_jax():
    x = np.zeros((1, 32, 32, 3), np.float32)
    variables = jax.eval_shape(
        lambda: jax_resnet.resnet18(10).init(jax.random.PRNGKey(0), x,
                                             train=False))
    model = resnet18(10, device="meta")
    want = jax_gpt.count_params(variables["params"])
    assert count_params(model) == want == 11173962
    assert count_params(flax_state_dict(_np_shapes(variables))) == \
        jax_gpt.count_params(variables)
    cfg = jax_gpt.gpt2_config("small")
    toks = np.zeros((1, 8), np.int32)
    from ray_lightning_tpu.models.transformer import \
        TransformerLM as JaxTransformerLM
    jparams = jax.eval_shape(
        lambda: JaxTransformerLM(cfg).init(jax.random.PRNGKey(0), toks))
    port = TransformerLM(gpt2_config("small"), device="meta")
    assert count_params(port) == jax_gpt.count_params(jparams["params"])
    assert count_params(port.state_dict()) >= count_params(port)


def _np_shapes(tree):
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), tree)


def test_optimizer_is_optax_sgd_nesterov():
    """``torch.optim.SGD(momentum, nesterov=True)`` takes optax's
    ``sgd(lr, momentum, nesterov=True)`` steps."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = rng.standard_normal((4, 6)).astype(np.float32)
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = resnet.ResNetModule().configure_optimizers()([p])
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
    _close(p, jp, tol=1e-6)
