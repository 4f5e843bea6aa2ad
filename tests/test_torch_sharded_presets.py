"""The memory presets under ZeRO and FSDP2 against the JAX package's two-device fits.

Two spawned gloo workers (``device="cpu"``), one module-scoped world
reused through ``RayLauncher(workers=)``, fit nano GPT on the flash path
in f32 with ``adamw_bf16m`` and ``adafactor`` under
``RayShardedStrategy`` (ZeRO by the JAX package's split of the optimizer
state) and ``FSDPStrategy`` (FSDP2), from the JAX trainer's initial
params and on the same numpy batches:

- against the JAX trainer's ``num_workers=2`` fit with the same preset
  and strategy: per-step losses, ``train_loss`` and ``val_loss`` at
  ``tests/test_torch_ddp.py``'s AdamW tolerance (1e-4; ``adafactor`` at
  the bf16-state presets' 1e-3 of ``tests/test_torch_train.py``, see
  ``JAX_TOL``), and against the port's one-process fit at 1e-4, with
  ``adafactor``'s factored params (whose update has no per-element
  denominator; a normalised update, as AdamW's, turns last-bit gradient
  differences into differences of the order of the learning rate, so
  ``tests/test_torch_ddp.py`` compares no AdamW params either);
- each rank's ``opt_state_bytes`` under ZeRO against the JAX rule's
  bytes on that device (the shards of the JAX fit's optimizer state),
  for AdamW and both presets;
- preset checkpoints written on two workers and resumed on one, and the
  other way: the loaded state equals the saved one bitwise, and the
  resumed fit's losses equal the writer's at 1e-4;
- the shard-aware adafactor math alone (``core/optim.py``): params split
  unevenly, split along either factored dimension, and split so that a
  rank's extent falls under ``min_dim_size_to_factor`` while the full
  one does not, against the same steps on the whole tensors.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_lightning_tpu import FSDPStrategy as JaxFSDPStrategy
from ray_lightning_tpu import RayShardedStrategy as JaxRayShardedStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import LambdaCallback as JaxLambda
from ray_lightning_tpu.models.gpt import GPTModule as JaxGPTModule
from ray_lightning_tpu.models.gpt import gpt2_config as jax_gpt2_config
from ray_lightning_tpu_torch import (FSDPStrategy, RayShardedStrategy,
                                     RayStrategy, Trainer)
from ray_lightning_tpu_torch.core.optim import Adafactor, _factored_dims
from ray_lightning_tpu_torch.interop import flax_state_dict

import torch_world as tw

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port, pytest.mark.multiproc]

FIT = dict(max_epochs=1, limit_train_batches=4, limit_val_batches=1, seed=0)
TOL = 1e-4          # tests/test_torch_ddp.py's AdamW tolerance
# against the JAX trainer: adafactor at the bf16-state presets' 1e-3 of
# tests/test_torch_train.py: its bf16 momentum can round the other way
# than optax's (its f32 means sum in another order)
JAX_TOL = {"adamw_bf16m": TOL, "adafactor": 1e-3}
PRESETS = ("adamw_bf16m", "adafactor")
STRATEGIES = {"zero": (RayShardedStrategy, JaxRayShardedStrategy),
              "fsdp": (FSDPStrategy, JaxFSDPStrategy)}


@pytest.fixture(scope="module")
def world():
    w = tw.World()
    yield w
    w.ray.shutdown()
    assert w.ray.live_actor_count() == 0


@functools.lru_cache(maxsize=None)
def jax_fit(name: str, preset: str) -> dict:
    """The JAX trainer's two-device fit: initial and final params,
    per-step losses, metrics, and the optimizer state's bytes on each
    device."""
    out = {"losses": []}

    def on_start(trainer, module):
        out["init"] = jax.tree_util.tree_map(np.array,
                                             trainer.train_state.params)

    def on_batch_end(trainer, module, outputs, batch, batch_idx):
        out["losses"].append(float(np.asarray(outputs["loss"])))

    trainer = JaxTrainer(
        strategy=STRATEGIES[name][1](num_workers=2),
        callbacks=[JaxLambda(on_fit_start=on_start,
                             on_train_batch_end=on_batch_end)], **FIT)
    trainer.fit(JaxGPTModule(config=jax_gpt2_config(
        "nano", attention_impl="flash", dtype=jnp.float32, **tw.NANO),
        optimizer=preset))
    out["final"] = jax.tree_util.tree_map(np.array,
                                          trainer.train_state.params)
    out["metrics"] = {k: float(v) for k, v in trainer.callback_metrics.items()}
    leaves = [x for x in jax.tree_util.tree_leaves(
        trainer.train_state.opt_state) if hasattr(x, "addressable_shards")]
    devices = sorted({s.device.id for x in leaves
                      for s in x.addressable_shards})
    out["device_bytes"] = [
        sum(s.data.nbytes for x in leaves for s in x.addressable_shards
            if s.device.id == d) for d in devices]
    out["n_leaves"] = len(leaves)
    return out


def fit2(world, cls, module, callbacks=(), **kw):
    rec = tw.LossRecorder()
    trainer = Trainer(strategy=cls(num_workers=2, device="cpu"),
                      callbacks=[rec, *callbacks], **{**FIT, **kw})
    world.run(trainer, "fit", module)
    return trainer, rec.losses


@functools.lru_cache(maxsize=None)
def one_process(preset: str):
    """The port's one-process fit from the JAX run's initial params:
    (per-step losses, metrics, final params as numpy)."""
    rec = tw.LossRecorder()
    trainer = Trainer(strategy=RayStrategy(device="cpu"), callbacks=[rec],
                      **FIT)
    trainer.fit(tw.Nano(init=jax_fit("zero", preset)["init"],
                        optimizer=preset))
    return rec.losses, dict(trainer.callback_metrics), tw.host(
        trainer.model.state_dict())


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_two_process_preset_fit_matches_jax_two_device_fit(world, name,
                                                          preset):
    """Against the JAX two-device fit: losses, ``train_loss`` and
    ``val_loss``; against the port's one-process fit: the same and, for
    ``adafactor``, the final params."""
    ref = jax_fit(name, preset)
    tol = JAX_TOL[preset]
    trainer, losses = fit2(world, STRATEGIES[name][0],
                           tw.Nano(init=ref["init"], optimizer=preset))
    assert trainer.global_step == 4
    np.testing.assert_allclose(losses, ref["losses"], atol=tol, rtol=0)
    for key in ("train_loss", "val_loss"):
        want = ref["metrics"][key]
        np.testing.assert_allclose(trainer.callback_metrics[key], want,
                                   atol=tol * max(1.0, abs(want)), rtol=0)
    losses1, metrics1, params1 = one_process(preset)
    np.testing.assert_allclose(losses, losses1, atol=TOL, rtol=0)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(trainer.callback_metrics[key],
                                   metrics1[key], atol=TOL, rtol=0)
    if preset == "adafactor":
        # the factored params, where the shard-aware means act: their
        # update has no per-element denominator (an unfactored one
        # normalises each element, as AdamW does, and turns the last-bit
        # differences of near-zero gradients into differences of the
        # order of the learning rate)
        got = trainer.train_state_dict["params"]
        assert got.keys() == params1.keys()
        factored = [n for n, w in params1.items()
                    if _factored_dims(w.shape, True) is not None]
        assert len(factored) == 1 + 4 * 2     # wte + 4 a block
        for n in factored:
            np.testing.assert_allclose(np.asarray(got[n]), params1[n],
                                       atol=TOL, rtol=0, err_msg=n)


def _rule_bytes(full, world: int) -> int:
    """A full tensor's bytes on one of ``world`` devices by the JAX
    package's rule (its own ``largest_divisible_dim``)."""
    from ray_lightning_tpu.parallel.sharding import largest_divisible_dim
    n = full.numel() * full.element_size()
    if full.ndim and largest_divisible_dim(tuple(full.shape),
                                           world) is not None:
        return n // world
    return n


@pytest.mark.parametrize("preset", ("adamw",) + PRESETS)
def test_zero_holds_the_jax_rules_bytes_on_each_rank(world, preset):
    """Each ZeRO rank's ``opt_state_bytes`` is the bytes of its shards by
    the JAX package's rule, applied to every array of the (gathered)
    optimizer state; for ``adamw`` and ``adamw_bf16m``, whose state
    trees have the JAX package's shapes, that is the JAX fit's optimizer
    state on the same device. ``torch.optim.AdamW`` keeps an f32 step
    count a tensor where optax keeps one int32 count; every rank holds
    them whole, and they are counted out. ``adafactor`` decides its
    factoring on the JAX leaves, as the JAX preset does."""
    ref = jax_fit("zero", preset)
    trainer, _ = fit2(world, RayShardedStrategy, tw.Nano(optimizer=preset),
                      callbacks=[tw.OptStateBytes()])
    state = trainer.train_state_dict["opt_state"]["state"]
    tensors = [t for st in state.values()
               for t in (st.values() if isinstance(st, dict) else [st])
               if isinstance(t, torch.Tensor)]
    by_rule = sum(_rule_bytes(t, 2) for t in tensors)
    m = trainer.callback_metrics
    for rank in range(2):
        assert m[f"opt_state_bytes_rank{rank}"] == by_rule, rank
    extra = 0
    if preset == "adamw":
        extra = sum(st["step"].numel() * st["step"].element_size()
                    for st in state.values()) - 4
    assert [by_rule - extra] * 2 == ref["device_bytes"]
    assert m["opt_state_bytes_rank0"] < m["opt_state_bytes_world"] / 1.5


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("name", sorted(STRATEGIES))
@pytest.mark.parametrize("saved_on,resumed_on", [(2, 1), (1, 2)])
def test_preset_checkpoints_move_between_world_sizes(world, tmp_path, name,
                                                     preset, saved_on,
                                                     resumed_on):
    """A fit on ``saved_on`` workers saves after step 2 of 4. Loaded on
    ``resumed_on`` workers with nothing left to train, the state comes
    back bitwise as saved (params, moments, factored moments, counts);
    resumed for the last 2 steps, the losses equal the writer's."""
    path = str(tmp_path / "ck.ckpt")
    cls = STRATEGIES[name][0] if saved_on == 2 else RayStrategy

    def run(n, cls, ckpt_path=None, callbacks=(), steps=4):
        rec = tw.LossRecorder()
        strategy = cls(num_workers=n, device="cpu")
        trainer = Trainer(strategy=strategy, callbacks=[rec, *callbacks],
                          **{**FIT, "limit_val_batches": 0,
                             "limit_train_batches": steps})
        module = tw.Nano(optimizer=preset)
        if n > 1:
            world.run(trainer, "fit", module, ckpt_path=ckpt_path)
            state = trainer.train_state_dict
        else:
            trainer.fit(module, ckpt_path=ckpt_path)
            state = tw_state(trainer)
        return state, rec.losses

    _, want = run(saved_on, cls, callbacks=[tw.SaveAt(2, path)])
    with open(path, "rb") as f:
        saved = torch.load(f, map_location="cpu", weights_only=True)
    cls = STRATEGIES[name][0] if resumed_on == 2 else RayStrategy
    loaded, _ = run(resumed_on, cls, ckpt_path=path, steps=2)
    assert_same(loaded, saved["state"])
    _, losses = run(resumed_on, cls, ckpt_path=path)
    np.testing.assert_allclose(losses[2:], want[2:], atol=TOL, rtol=0)


def tw_state(trainer):
    """A one-process trainer's state dict, its tensors copied out."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x
    return copy(trainer.train_state.state_dict())


def assert_same(got, want, where="state"):
    """Two state nests equal bitwise: tensors (dtype, shape, values) and
    plain values; the optimizer's param groups by their entries."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert torch.equal(got.cpu(), want.cpu()), where
    elif isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}/{i}")
    else:
        assert got == want, where


# ------------------------------------------- the shard-aware math alone
SHARD_CASES = (
    ((201, 160), 0),   # uneven (101 + 100 rows); a rank's 101 < 128
    ((160, 384), 1),   # split along the largest (row-mean) dimension
    ((256, 160), 1),   # split along the column-mean dimension
    ((130,), 0),       # one dimension: not factored
    ((3, 200), 1),     # second dimension under min_dim: not factored
)
SHARD_STEPS = 3


def test_adafactor_on_uneven_shards_equals_the_whole_tensors(world):
    got = world.collective(tw.adafactor_on_shards, SHARD_CASES, SHARD_STEPS)
    params = [torch.nn.Parameter(torch.from_numpy(
        tw.adafactor_case(shape, SHARD_STEPS, seed=i)[0]))
        for i, (shape, _dim) in enumerate(SHARD_CASES)]
    opt = Adafactor(params, **tw.ADAFACTOR)
    for step in range(SHARD_STEPS):
        for i, ((shape, _dim), p) in enumerate(zip(SHARD_CASES, params)):
            p.grad = torch.from_numpy(
                tw.adafactor_case(shape, SHARD_STEPS, seed=i)[1][step])
        opt.step()
    want = opt.state_dict()
    for i, p in enumerate(params):
        np.testing.assert_allclose(got["params"][i], p.detach(), atol=1e-6,
                                   rtol=0, err_msg=str(SHARD_CASES[i]))
        for k in ("v_row", "v_col", "v", "ema"):
            w, g = want["state"][i][k], got["state"]["state"][i][k]
            assert g.shape == w.shape and g.dtype == w.dtype, (i, k)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{SHARD_CASES[i]} {k}")
    assert got["state"]["state"]["count"] == want["state"]["count"]
    # the factoring is the full shape's: (201, 160) is factored although
    # each rank holds at most 101 rows; the moment that lost the split
    # dimension is kept split by the JAX rule, the other as the param is
    assert _factored_dims((201, 160), True) is not None
    assert _factored_dims((101, 160), True) is None
    assert got["local_moments"][0] == ((80,), (101,))
    assert got["local_moments"][1] == ((80,), (192,))
    assert got["local_moments"][2] == ((80,), (128,))


# ------------------------------------------ the JAX preset's leaves
@pytest.mark.parametrize("size", ["nano", "small"])
def test_adafactor_state_equals_the_jax_preset(size):
    """The JAX package's qkv kernel is ``(d, 3, H, D)``, stacked over the
    layers: optax factors a second moment over its two largest
    dimensions only when the smaller of them is at least 128, so the JAX
    preset keeps that weight's second moment whole (D = 64), and it
    keeps one placeholder per stacked leaf. ``GPTModule``'s adafactor
    decides on the JAX leaves (``transformer.jax_leaves``), so the
    port's optimizer-state bytes equal the JAX preset's. Both sides from
    shapes alone (``eval_shape``; the port's state made on the meta
    device)."""
    from ray_lightning_tpu.core.optim import make_optimizer as jax_make
    from ray_lightning_tpu_torch import GPTModule
    from ray_lightning_tpu_torch.core.optim import opt_state_bytes
    from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
    kw = tw.NANO if size == "nano" else {}
    jmod = JaxGPTModule(config=jax_gpt2_config(size, **kw))
    model = jmod.configure_model()
    params = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    state = jax.eval_shape(jax_make("adafactor", 3e-4).init, params)
    jax_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                    for x in jax.tree_util.tree_leaves(state))
    cfg = gpt2_config(size, **kw)
    port = TransformerLM(cfg, device="meta")
    opt = GPTModule(config=cfg, optimizer="adafactor").configure_optimizers()(
        port.parameters())
    for p in port.parameters():
        p.grad = torch.empty_like(p)
    opt.step()
    assert _factored_dims((cfg.n_layers, cfg.d_model, 3, cfg.n_heads,
                           cfg.d_model // cfg.n_heads), True) is None
    qkv = port.stack.blocks[0].attn.qkv.weight
    assert opt.state[qkv]["v"].shape == qkv.shape       # kept whole
    assert len(opt.param_groups) == len(jax.tree_util.tree_leaves(params))
    assert opt_state_bytes(opt) == jax_bytes
    if size == "small":     # phase O's adafactor bytes
        assert jax_bytes == 334_953_400
