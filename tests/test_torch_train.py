"""The port's training slice (``Trainer.fit`` of ``GPTModule``) against the JAX package.

In f32 on the CPU, with the JAX package's weights carried across by
``interop`` and the same numpy batches:

- nano GPT (vocab 256, max_seq_len 32) with ``attention_impl`` "dot" and
  "flash": the loss and every gradient against ``jax.value_and_grad`` of
  ``GPTModule._loss`` at atol 1e-5;
- ``make_optimizer("adamw", b2=0.95, weight_decay=0.1)`` with optax's
  global-norm clipping and ``MultiSteps`` accumulation, through the
  strategy's step, against the optax chain: params at atol 1e-6;
- the slice as a whole: the port's ``Trainer(...).fit(GPTModule(...))``
  against the JAX ``Trainer(...).fit(...)`` from the same initial params
  -- with SGD the per-step losses and final params at atol 1e-5, with the
  default AdamW the loss trajectory at 1e-4, plus ``callback_metrics``,
  ``global_step`` and the order of the callback hooks;
- the device rule, every unported argument, and explicit generators.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.optim import make_optimizer as jax_make_optimizer
from ray_lightning_tpu.data.loader import ArrayDataset as JaxArrayDataset
from ray_lightning_tpu.data.loader import DataLoader as JaxDataLoader
from ray_lightning_tpu.models.gpt import GPTModule as JaxGPTModule
from ray_lightning_tpu.models.gpt import gpt2_config as jax_gpt2_config
from ray_lightning_tpu_torch import (GPTModule, RayStrategy, Trainer,
                                     TransformerLM, gpt2_config,
                                     make_optimizer)
from ray_lightning_tpu_torch.core import (Callback, EpochStatsCallback,
                                          LambdaCallback, TrainState)
from ray_lightning_tpu_torch.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.interop import (flax_state_dict,
                                             load_flax_params)
from ray_lightning_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

NANO = dict(vocab_size=256, max_seq_len=32)
FIT = dict(max_epochs=1, limit_train_batches=4, limit_val_batches=1, seed=0)
SGD_LR = 0.5
METRICS = {"train_loss", "train_ppl", "val_loss", "val_ppl"}


def jax_cfg(impl="flash"):
    return jax_gpt2_config("nano", attention_impl=impl, dtype=jnp.float32,
                           **NANO)


def port_cfg(impl="flash"):
    return gpt2_config("nano", attention_impl=impl, dtype=torch.float32,
                       **NANO)


def _torch(batch):
    return tuple(torch.from_numpy(np.asarray(x)) for x in batch)


# ----------------------------------------------------------- loss, grads
@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_nano_loss_and_grads_match_jax(impl):
    jmod = JaxGPTModule(config=jax_cfg(impl), batch_size=4)
    jmodel = jmod.configure_model()
    batch = next(iter(jmod.train_dataloader()))
    params = jmodel.init(jax.random.PRNGKey(0), batch[0])["params"]

    def loss_fn(p):
        return jmod._loss(jmodel, {"params": p}, batch,
                          jax.random.PRNGKey(1), True)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    module = GPTModule(config=port_cfg(impl), batch_size=4)
    model = load_flax_params(TransformerLM(module.cfg, device="cpu"), params)
    loss, _ = module._loss(model, _torch(batch))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5
    want = flax_state_dict(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g, atol=1e-5, rtol=0,
                                   err_msg=name)


def test_loaders_draw_the_same_batches():
    """The copied loader: the same permutation per epoch, ``set_epoch``
    and the epoch bump of a finished iteration included."""
    toks = np.arange(40 * 3, dtype=np.int32).reshape(40, 3)
    jl = JaxDataLoader(JaxArrayDataset((toks[:, :-1], toks[:, 1:])),
                       batch_size=6, shuffle=True, seed=3)
    pl = DataLoader(ArrayDataset((toks[:, :-1], toks[:, 1:])),
                    batch_size=6, shuffle=True, seed=3)
    assert len(jl) == len(pl) == 6
    for epoch in (0, None, 4):
        if epoch is not None:
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
        for a, b in zip(jl, pl, strict=True):
            for x, y in zip(a, b, strict=True):
                np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- optimizer
class _Params(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(init["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(init["b"].copy()))


def _schedule(n):
    return 1e-2 / (1.0 + n)


@pytest.mark.parametrize("clip,k,sched", [(None, 1, False), (0.5, 1, False),
                                          (0.5, 3, False), (None, 2, False),
                                          (0.5, 2, True)])
def test_adamw_clip_and_accumulation_match_optax(clip, k, sched):
    """The strategy's step against ``MultiSteps(chain(clip_by_global_norm,
    adamw), k)`` (the JAX trainer's ``_optimizer``) on one fixed gradient
    sequence, some norms above the clip and some below; ``sched`` gives
    the learning rate as a schedule of the update count (optax bakes it
    into adamw, the port's step sets it before each update)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 4), "b": (4,)}
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    seq = [{n: (scale * rng.standard_normal(s)).astype(np.float32)
            for n, s in shapes.items()}
           for scale in (0.05, 2.0, 0.1, 1.0, 3.0, 0.02)]

    tx = jax_make_optimizer("adamw", _schedule if sched else 1e-2,
                            weight_decay=0.1, b2=0.95)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    if k > 1:
        tx = optax.MultiSteps(tx, k)
    params = {n: jnp.asarray(v) for n, v in init.items()}
    opt_state = tx.init(params)

    model = _Params(init)
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        "adamw", 1e-2, weight_decay=0.1, b2=0.95)(model.parameters()),
        generator=torch.Generator().manual_seed(0))

    def loss_fn(model, batch, generator):
        # d loss / d p = the batch's gradient for p
        return (model.w * batch["w"]).sum() + (model.b * batch["b"]).sum(), {}

    step = RayStrategy(device="cpu").make_train_step(
        loss_fn, gradient_clip_val=clip, accumulate_grad_batches=k,
        log_grad_norm=True, lr_schedule=_schedule if sched else None)
    for g in seq:
        updates, opt_state = tx.update(
            {n: jnp.asarray(v) for n, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        state, logs = step(state, {n: torch.from_numpy(v)
                                   for n, v in g.items()})
        np.testing.assert_allclose(
            logs["grad_norm"].item(),
            float(optax.global_norm({n: jnp.asarray(v)
                                     for n, v in g.items()})),
            rtol=1e-6)
        for n in shapes:
            np.testing.assert_allclose(getattr(model, n).detach().numpy(),
                                       np.asarray(params[n]), atol=1e-6,
                                       rtol=0, err_msg=n)


# ------------------------------------------------------ the whole slice
class _Hooks:
    """Records (hook, global_step) for every callback hook that fires."""
    NAMES = ("setup", "on_fit_start", "on_train_start",
             "on_train_epoch_start", "on_train_batch_start",
             "on_before_optimizer_step", "on_train_batch_end",
             "on_validation_start", "on_validation_epoch_start",
             "on_validation_batch_start", "on_validation_batch_end",
             "on_validation_epoch_end", "on_validation_end",
             "on_train_epoch_end", "on_train_end", "on_fit_end",
             "teardown")

    def __init__(self, base, extra=None):
        self.seen, self.losses = [], []

        def hook(name):
            def fn(trainer, *args, **kwargs):
                self.seen.append((name, trainer.global_step))
                if name == "on_train_batch_end":
                    self.losses.append(float(np.asarray(args[1]["loss"])))
                if extra is not None:
                    extra(name, trainer)
            return fn

        self.callback = type("Recorder", (base,), {
            n: (lambda self_, *a, _f=hook(n), **k: _f(*a, **k))
            for n in self.NAMES})()


class _JaxSGD(JaxGPTModule):
    def configure_optimizers(self):
        return optax.sgd(SGD_LR)


@pytest.fixture(scope="module", params=["sgd", "adamw"])
def jax_fit(request):
    """The JAX trainer's run: initial and final params, per-step losses,
    callback metrics, global step and hook order."""
    cls = _JaxSGD if request.param == "sgd" else JaxGPTModule
    out = {}

    def grab(name, trainer):
        if name == "on_fit_start":
            out["init"] = jax.tree_util.tree_map(
                np.array, trainer.train_state.params)

    rec = _Hooks(JaxCallback, grab)
    trainer = JaxTrainer(strategy=JaxRayStrategy(num_workers=1),
                         callbacks=[rec.callback], **FIT)
    trainer.fit(cls(config=jax_cfg()))
    out.update(final=jax.tree_util.tree_map(np.array,
                                            trainer.train_state.params),
               losses=rec.losses, hooks=rec.seen,
               metrics=dict(trainer.callback_metrics),
               global_step=trainer.global_step, opt=request.param)
    return out


def _port_fit(opt, init):
    class Module(GPTModule):
        def init_variables(self, model, generator, batch):
            load_flax_params(model, init)

        def configure_optimizers(self):
            if opt == "sgd":
                return lambda p: torch.optim.SGD(p, lr=SGD_LR)
            return super().configure_optimizers()

    rec = _Hooks(Callback)
    trainer = Trainer(strategy=RayStrategy(device="cpu"),
                      callbacks=[rec.callback], **FIT)
    trainer.fit(Module(config=port_cfg()))
    return trainer, rec


def test_fit_matches_the_jax_trainer(jax_fit):
    trainer, rec = _port_fit(jax_fit["opt"], jax_fit["init"])
    tol = 1e-5 if jax_fit["opt"] == "sgd" else 1e-4
    assert trainer.global_step == jax_fit["global_step"] == 4
    np.testing.assert_allclose(rec.losses, jax_fit["losses"], atol=tol,
                               rtol=0)
    assert set(trainer.callback_metrics) == set(jax_fit["metrics"]) \
        == METRICS
    for name in METRICS:
        np.testing.assert_allclose(trainer.callback_metrics[name],
                                   float(jax_fit["metrics"][name]),
                                   atol=tol * max(1.0, abs(float(
                                       jax_fit["metrics"][name]))),
                                   rtol=0, err_msg=name)
    assert rec.seen == jax_fit["hooks"]
    if jax_fit["opt"] == "sgd":
        want = flax_state_dict(jax_fit["final"])
        got = trainer.model.state_dict()
        assert got.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w, atol=1e-5,
                                       rtol=0, err_msg=name)


def test_validate_and_loop_controls():
    """validate() reruns the validation loop on the trained state;
    ``val_check_interval`` validates mid-epoch, ``track_grad_norm`` logs
    the norm, ``max_steps`` stops the fit (without the epoch-end
    validation), ``precision="bf16"`` leaves integer batches alone, and
    ``EpochStatsCallback`` times each epoch (peak memory 0 on the CPU)."""
    vals = []
    cb = LambdaCallback(on_validation_end=lambda tr, m: vals.append(
        tr.global_step))
    stats = EpochStatsCallback(print_stats=False)
    module = GPTModule(config=port_cfg("dot"), batch_size=4,
                       num_samples=32)
    trainer = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=2,
                      limit_val_batches=1, val_check_interval=3,
                      num_sanity_val_steps=1, track_grad_norm=True,
                      precision="bf16", seed=0, callbacks=[cb, stats])
    trainer.fit(module)
    assert trainer.global_step == 16
    assert vals == [0, 3, 6, 9, 12, 15]
    assert len(stats.epoch_times) == 2 and stats.peak_memory_mib == [0.0, 0.0]
    assert {"grad_norm", "train_loss", "val_loss"} <= set(
        trainer.callback_metrics)
    out = trainer.validate(module)
    assert out[0]["val_loss"] == pytest.approx(
        trainer.callback_metrics["val_loss"])
    stopped = Trainer(strategy=RayStrategy(device="cpu"), max_steps=3,
                      limit_val_batches=1, callbacks=[cb], seed=0)
    vals.clear()
    stopped.fit(GPTModule(config=port_cfg("dot"), batch_size=4,
                          num_samples=32))
    assert stopped.global_step == 3 and vals == []
    with pytest.raises(ValueError, match="test_dataloader"):
        trainer.test(module)


# ------------------------------------------------- device and the rest
def test_trainer_and_strategy_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RayStrategy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer()


def _fit_with_ckpt_path():
    Trainer(strategy=RayStrategy(device="cpu")).fit(
        GPTModule(config=port_cfg()), ckpt_path="last.ckpt")


UNPORTED = {
    "enable_checkpointing": lambda: Trainer(
        strategy=RayStrategy(device="cpu"), enable_checkpointing=True),
    "resume": lambda: Trainer(strategy=RayStrategy(device="cpu"),
                              resume="auto"),
    "nonfinite_action": lambda: Trainer(
        strategy=RayStrategy(device="cpu"), nonfinite_action="raise"),
    "telemetry": lambda: Trainer(strategy=RayStrategy(device="cpu"),
                                 telemetry=object()),
    "profiler": lambda: Trainer(strategy=RayStrategy(device="cpu"),
                                profiler="simple"),
    "limit_predict_batches": lambda: Trainer(
        strategy=RayStrategy(device="cpu"), limit_predict_batches=2),
    "ckpt_path": _fit_with_ckpt_path,
    "predict": lambda: Trainer(strategy=RayStrategy(device="cpu")).predict(
        GPTModule(config=port_cfg())),
    "validate_ckpt_path": lambda: Trainer(
        strategy=RayStrategy(device="cpu")).validate(
            GPTModule(config=port_cfg()), ckpt_path="best"),
    "num_workers": lambda: RayStrategy(num_workers=2, device="cpu"),
    "use_ray": lambda: RayStrategy(use_ray=True, device="cpu"),
    "gang": lambda: RayStrategy(gang=object(), device="cpu"),
    "standby": lambda: RayStrategy(standby=object(), device="cpu"),
    "resources_per_worker": lambda: RayStrategy(
        resources_per_worker={"CPU": 2}, device="cpu"),
    "ddp_kwargs": lambda: RayStrategy(find_unused_parameters=True,
                                      device="cpu"),
    "adamw_bf16m": lambda: make_optimizer("adamw_bf16m"),
    "adafactor": lambda: make_optimizer("adafactor"),
    "factored": lambda: make_optimizer("adamw", factored=True),
    "moment_dtype": lambda: make_optimizer("adamw",
                                           moment_dtype=torch.bfloat16),
    "gpt_adafactor": lambda: Trainer(strategy=RayStrategy(
        device="cpu")).fit(GPTModule(config=port_cfg(),
                                     optimizer="adafactor")),
    "dropout": lambda: gpt2_config("nano", dropout=0.1),
    "remat": lambda: gpt2_config("nano", remat=True),
    "ring": lambda: gpt2_config("nano", attention_impl="ring"),
    "ulysses": lambda: gpt2_config("nano", attention_impl="ulysses"),
    "attention_dropout": lambda: flash_attention(
        *(torch.zeros(1, 4, 2, 32),) * 3, dropout_rate=0.1),
}


def test_a_schedule_goes_beside_the_factory():
    with pytest.raises(NotImplementedError, match="configure_optimizers"):
        make_optimizer("adamw", _schedule)


@pytest.mark.parametrize("what", sorted(UNPORTED))
def test_unported_arguments_raise(what):
    with pytest.raises(NotImplementedError, match="not ported"):
        UNPORTED[what]()


def test_init_draws_only_from_the_given_generator():
    cfg = port_cfg()

    def model(seed):
        m = TransformerLM(cfg, device="meta").to_empty(device="cpu")
        m.reset_parameters(torch.Generator().manual_seed(seed))
        return m.state_dict()

    before = torch.random.get_rng_state()
    a, b, c = model(7), model(7), model(8)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert any(not torch.equal(a[n], c[n]) for n in a)
    # the trainer initialises from Generator().manual_seed(seed)
    init = {}
    cb = LambdaCallback(on_fit_start=lambda tr, m: init.update(
        {n: t.clone() for n, t in tr.model.state_dict().items()}))
    Trainer(strategy=RayStrategy(device="cpu"), max_steps=1, seed=7,
            callbacks=[cb]).fit(GPTModule(config=cfg, num_samples=16))
    assert all(torch.equal(init[n], a[n]) for n in a)
