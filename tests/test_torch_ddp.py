"""The port's data parallelism, one process per device, against the JAX package's two-device fits.

Two spawned gloo workers (``device="cpu"``), one module-scoped world
reused through ``RayLauncher(workers=)``, fit nano GPT on the flash path
in f32 under each of ``RayStrategy`` (DDP), ``HorovodRayStrategy`` (the
explicit all-reduce), ``RayShardedStrategy`` (ZeRO-1) and
``FSDPStrategy`` (FSDP2), started from the JAX trainer's initial params
and fed the same numpy batches:

- against the JAX trainer's one-process ``num_workers=2`` fit under the
  same strategy (a two-device mesh on the virtual CPU devices): per-step
  losses, ``train_loss`` and ``val_loss`` at ``tests/test_torch_train.py``'s
  tolerances (SGD 1e-5, AdamW 1e-4), and, as there, the final params
  under SGD (AdamW's normalised update turns last-bit gradient
  differences into parameter differences of the order of its learning
  rate).
  ``train_ppl`` and ``val_ppl`` are exp of a loss: the port averages a
  log over ranks (Lightning's ``sync_dist``), which is what JAX's
  ``HorovodRayStrategy`` does with ``pmean``, while JAX's SPMD strategies
  take it on the global batch; the two differ by the Jensen gap
  (``ROADMAP.md`` C). So ``train_ppl`` is held against the JAX
  ``HorovodRayStrategy`` fit's, and ``val_ppl`` against the mean over the
  two ranks' shards of exp(the JAX model's shard loss);
- against the port's own one-process fit at the same global batch:
  losses, ``train_loss``/``val_loss`` and (SGD) params at the same
  tolerances;
- accumulation with clipping, a learning-rate schedule under ZeRO, the
  non-finite guard's one verdict over ranks, each rank's share of
  ZeRO's and FSDP's optimizer state, and ``validate``/``test`` averaged
  over ranks, each against the one-process fit;
- a DDP fit with ``remat=True`` bitwise the same fit without it, with
  and without dropout.
"""
import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_lightning_tpu import FSDPStrategy as JaxFSDPStrategy
from ray_lightning_tpu import HorovodRayStrategy as JaxHorovodRayStrategy
from ray_lightning_tpu import RayShardedStrategy as JaxRayShardedStrategy
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import LambdaCallback as JaxLambda
from ray_lightning_tpu.models.gpt import GPTModule as JaxGPTModule
from ray_lightning_tpu.models.gpt import gpt2_config as jax_gpt2_config
from ray_lightning_tpu_torch import (BoringModel, FSDPStrategy,
                                     HorovodRayStrategy, RayShardedStrategy,
                                     RayStrategy, Trainer)
from ray_lightning_tpu_torch.interop import flax_state_dict

import torch_world as tw

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port, pytest.mark.multiproc]

FIT = dict(max_epochs=1, limit_train_batches=4, limit_val_batches=1, seed=0)
TOL = {"sgd": 1e-5, "adamw": 1e-4}
STRATEGIES = {  # name: (port strategy, JAX strategy)
    "ddp": (RayStrategy, JaxRayStrategy),
    "horovod": (HorovodRayStrategy, JaxHorovodRayStrategy),
    "zero": (RayShardedStrategy, JaxRayShardedStrategy),
    "fsdp": (FSDPStrategy, JaxFSDPStrategy),
}


@pytest.fixture(scope="module")
def world():
    w = tw.World()
    yield w
    w.ray.shutdown()
    assert w.ray.live_actor_count() == 0


def fit2(world, strategy_cls, module, callbacks=(), **kw):
    """A fit across the two workers: (trainer, per-step losses)."""
    rec = tw.LossRecorder()
    strategy = strategy_cls(num_workers=2, device="cpu")
    trainer = Trainer(strategy=strategy, callbacks=[rec, *callbacks],
                      **{**FIT, **kw})
    world.run(trainer, "fit", module)
    return trainer, rec.losses


def fit1(module, callbacks=(), **kw):
    """The port's one-process fit: (trainer, per-step losses)."""
    rec = tw.LossRecorder()
    trainer = Trainer(strategy=RayStrategy(device="cpu"),
                      callbacks=[rec, *callbacks], **{**FIT, **kw})
    trainer.fit(module)
    return trainer, rec.losses


# ------------------------------------------------------------ the JAX side
def jax_cfg():
    return jax_gpt2_config("nano", attention_impl="flash", dtype=jnp.float32,
                           **tw.NANO)


class _JaxSGD(JaxGPTModule):
    def configure_optimizers(self):
        return optax.sgd(tw.SGD_LR)


@functools.lru_cache(maxsize=None)
def jax_fit(name: str, opt: str) -> dict:
    """The JAX trainer's ``num_workers=2`` fit: initial and final params
    (flax layout, numpy), per-step losses, callback metrics, and
    ``val_ppl`` as the port's two ranks compute it (the mean of exp of
    each half-batch's loss)."""
    out = {"losses": []}

    def on_start(trainer, module):
        out["init"] = jax.tree_util.tree_map(np.array,
                                             trainer.train_state.params)

    def on_batch_end(trainer, module, outputs, batch, batch_idx):
        out["losses"].append(float(np.asarray(outputs["loss"])))

    jmod = (_JaxSGD if opt == "sgd" else JaxGPTModule)(config=jax_cfg())
    trainer = JaxTrainer(strategy=STRATEGIES[name][1](num_workers=2),
                         callbacks=[JaxLambda(on_fit_start=on_start,
                                              on_train_batch_end=on_batch_end)],
                         **FIT)
    trainer.fit(jmod)
    out["final"] = jax.tree_util.tree_map(np.array,
                                          trainer.train_state.params)
    out["metrics"] = {k: float(v) for k, v in trainer.callback_metrics.items()}
    jmodel = jmod.configure_model()
    inputs, targets = next(iter(jmod.val_dataloader()))
    half = len(inputs) // 2
    out["val_ppl_ranks"] = float(np.mean([
        np.exp(float(jmod._loss(jmodel, {"params": out["final"]},
                                (inputs[r * half:(r + 1) * half],
                                 targets[r * half:(r + 1) * half]),
                                jax.random.PRNGKey(0), True)[0]))
        for r in range(2)]))
    return out


def close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, abs(want)),
                               rtol=0, err_msg=what)


def assert_params(got, want_flax, tol):
    want = flax_state_dict(want_flax)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), w, atol=tol,
                                   rtol=0, err_msg=name)


@functools.lru_cache(maxsize=None)
def one_process(opt: str):
    """The port's one-process fit from the JAX run's initial params:
    (per-step losses, callback metrics, final params as numpy)."""
    init = jax_fit("ddp", opt)["init"]
    trainer, losses = fit1(tw.Nano(init=init, opt=opt))
    return losses, dict(trainer.callback_metrics), tw.host(
        trainer.model.state_dict())


# --------------------------------------------------------------- the fits
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_two_process_fit_matches_jax_two_device_fit(world, name, opt):
    ref = jax_fit(name, opt)
    tol = TOL[opt]
    trainer, losses = fit2(world, STRATEGIES[name][0],
                           tw.Nano(init=ref["init"], opt=opt))
    assert trainer.global_step == 4 and len(losses) == 4
    np.testing.assert_allclose(losses, ref["losses"], atol=tol, rtol=0)
    m = trainer.callback_metrics
    assert set(m) == set(ref["metrics"]) == {"train_loss", "train_ppl",
                                             "val_loss", "val_ppl"}
    for key in ("train_loss", "val_loss"):
        close(m[key], ref["metrics"][key], tol, key)
    close(m["train_ppl"], jax_fit("horovod", opt)["metrics"]["train_ppl"],
          tol, "train_ppl (mean over ranks, as JAX's pmean)")
    close(m["val_ppl"], ref["val_ppl_ranks"], tol, "val_ppl")
    if opt == "sgd":
        # as test_fit_matches_the_jax_trainer: AdamW's normalised update
        # turns the last-bit differences of near-zero f32 gradients into
        # parameter differences of the order of its learning rate
        assert_params(trainer.train_state_dict["params"], ref["final"], tol)
    stats = trainer.state_stream_stats
    assert stats["bytes"] > 0 and stats["load_s"] >= 0


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_two_process_fit_matches_one_process_fit(world, name, opt):
    """The same global batches in one process: the two workers' rows
    together are the one process's batch, and equal-length rows make the
    mean over ranks of each rank's mean loss the global mean."""
    tol = TOL[opt]
    losses1, metrics1, params1 = one_process(opt)
    trainer, losses = fit2(world, STRATEGIES[name][0],
                           tw.Nano(init=jax_fit("ddp", opt)["init"],
                                   opt=opt))
    np.testing.assert_allclose(losses, losses1, atol=tol, rtol=0)
    for key in ("train_loss", "val_loss"):
        close(trainer.callback_metrics[key], metrics1[key], tol, key)
    got = trainer.train_state_dict["params"]
    assert got.keys() == params1.keys()
    if opt == "sgd":  # AdamW: see the JAX comparison above
        for name_, w in params1.items():
            np.testing.assert_allclose(got[name_].numpy(), w, atol=tol,
                                       rtol=0, err_msg=name_)


@pytest.mark.parametrize("name", ["ddp", "fsdp"])
def test_accumulation_and_clipping(world, name):
    """``accumulate_grad_batches=2`` with a clip that bites: the running
    mean of gradients already averaged over ranks, clipped by their
    global norm (sharded DTensors under FSDP), equals the one-process
    fit."""
    kw = dict(accumulate_grad_batches=2, gradient_clip_val=0.05,
              track_grad_norm=True)
    one, losses1 = fit1(tw.Nano(opt="adamw"), **kw)
    two, losses2 = fit2(world, STRATEGIES[name][0], tw.Nano(opt="adamw"),
                        **kw)
    np.testing.assert_allclose(losses2, losses1, atol=1e-5, rtol=0)
    close(two.callback_metrics["grad_norm"], one.callback_metrics[
        "grad_norm"], 1e-5, "grad_norm")
    assert one.callback_metrics["grad_norm"] > 0.05   # the clip bites
    want = tw.host(one.model.state_dict())
    for n, w in want.items():
        np.testing.assert_allclose(two.train_state_dict["params"][n],
                                   w, atol=1e-5, rtol=0, err_msg=n)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_remat_fit_equals_the_plain_fit(world, rate):
    """Two workers under DDP with ``remat=True`` equal the same fit
    without remat bitwise, with dropout too: each rank's masks come from
    its own step generator and the replay redraws them."""
    fits = []
    for remat in (False, True):
        cfg = dataclasses.replace(tw.nano_cfg(), dropout=rate, remat=remat)
        trainer, losses = fit2(world, RayStrategy, tw.Nano(cfg=cfg))
        fits.append((losses, trainer.train_state_dict["params"]))
    (losses1, params1), (losses2, params2) = fits
    assert losses2 == losses1
    assert params2.keys() == params1.keys()
    for n, w in params1.items():
        assert torch.equal(params2[n], w), n


def test_zero_schedule_reaches_the_local_optimizer(world):
    """A ``(factory, schedule)`` module under ZeRO: the learning rate the
    step writes into the wrapper's param groups reaches each rank's local
    optimizer (the params equal the one-process fit's), and the saved
    optimizer state is the one-process layout."""
    one, _ = fit1(tw.Nano(opt="sgd", schedule=True))
    two, _ = fit2(world, RayShardedStrategy, tw.Nano(opt="sgd",
                                                     schedule=True))
    want = tw.host(one.model.state_dict())
    for n, w in want.items():
        np.testing.assert_allclose(two.train_state_dict["params"][n], w,
                                   atol=1e-6, rtol=0, err_msg=n)
    opt = two.train_state_dict["opt_state"]
    want = one.train_state.optimizer.state_dict()
    assert opt["param_groups"][0]["lr"] == pytest.approx(tw.lr_schedule(3))
    assert opt["param_groups"][0].keys() == want["param_groups"][0].keys()
    assert opt["param_groups"][0]["params"] == want["param_groups"][0][
        "params"]


@pytest.mark.parametrize("name", ["zero", "fsdp"])
def test_sharded_strategies_hold_a_share_of_the_optimizer_state(world,
                                                                name):
    """``opt_state_bytes`` on each rank is that rank's share: below the
    one-process state, and the world's shares add up to it."""
    one, _ = fit1(tw.Nano(), callbacks=[tw.OptStateBytes()])
    two, _ = fit2(world, STRATEGIES[name][0], tw.Nano(),
                  callbacks=[tw.OptStateBytes()])
    full = one.callback_metrics["opt_state_bytes"]
    mine = two.callback_metrics["opt_state_bytes"]
    world_bytes = two.callback_metrics["opt_state_bytes_world"]
    assert 0 < mine < full
    # ZeRO splits every tensor along its largest dimension that the
    # world size divides (the JAX package's rule), FSDP along dimension
    # 0; under both, every rank holds torch.optim.AdamW's step counts
    assert abs(world_bytes - full) <= 4 * 1024


def test_dump_checkpoint_consolidate_false_keeps_fsdp_shards(world):
    """``dump_checkpoint(consolidate=False)`` -- the JAX trainer's
    keyword -- keeps FSDP's shards (what the directory format writes):
    DTensors holding this rank's part, where ``consolidate=True`` gives
    whole tensors. The old ``full=`` keyword raises ``TypeError``."""
    two, _ = fit2(world, FSDPStrategy, tw.Nano(),
                  callbacks=[tw.DumpProbe()])
    m = two.callback_metrics
    assert m["dtensors_kept"] > 0 and m["dtensors_whole"] == 0
    assert m["numel_kept"] < m["numel_whole"]
    assert m["full_keyword_refused"] == 1.0


def test_guard_skips_on_every_rank_together(world):
    """A NaN loss on rank 1 alone: the verdict is reduced over ranks, so
    rank 0 skips the update too, and the params equal a one-process fit
    that skips the same batch."""
    kw = dict(nonfinite_action="skip_batch", max_epochs=1,
              limit_train_batches=4, limit_val_batches=0)
    one, _ = fit1(tw.Poisoned(poison_at=2, poison_rank=0), **kw)
    two, _ = fit2(world, RayStrategy, tw.Poisoned(poison_at=2,
                                                  poison_rank=1), **kw)
    assert one.callback_metrics["nonfinite"] == 0.25
    assert two.callback_metrics["nonfinite"] == 0.25
    want = tw.host(one.model.state_dict())
    for n, w in want.items():
        np.testing.assert_allclose(two.train_state_dict["params"][n], w,
                                   atol=1e-6, rtol=0, err_msg=n)


def test_validate_and_test_average_over_ranks(world):
    """``validate`` and ``test`` after a two-worker fit run in the
    workers from the returned state; their logs, averaged over ranks,
    equal the one-process evaluation of the same params."""
    one, _ = fit1(BoringModel())
    strategy = RayStrategy(num_workers=2, device="cpu")
    two = Trainer(strategy=strategy, **FIT)
    world.run(two, "fit", BoringModel())
    for stage, key in (("validate", "x"), ("test", "y")):
        want = getattr(one, stage)(BoringModel())[0][key]
        got = world.run(two, stage, BoringModel())[0][key]
        close(got, want, 1e-6, f"{stage} {key}")


def test_injected_fault_crosses_the_pickle_boundary():
    """A worker's ``InjectedFault`` reaches the driver as itself. The JAX
    package's does not unpickle (its ``__init__`` takes two arguments,
    pickle passes one), so under its ``ProcessRay`` the reply kills the
    driver's reader thread and the launch never returns (``ROADMAP.md``
    C); the port's defines ``__reduce__``."""
    import pickle

    from ray_lightning_tpu.reliability.faults import \
        InjectedFault as JaxInjectedFault
    from ray_lightning_tpu_torch.reliability import InjectedFault
    with pytest.raises(TypeError):
        pickle.loads(pickle.dumps(JaxInjectedFault("train.step", 2)))
    e = pickle.loads(pickle.dumps(InjectedFault("train.step", 2)))
    assert (e.site, e.tick, str(e)) == (
        "train.step", 2, "injected fault at train.step tick 2")
