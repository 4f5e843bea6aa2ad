"""ResNet's BatchNorm state under the port's data parallelism, against the JAX package's two-device fits.

Two spawned gloo workers (``device="cpu"``, one module-scoped world)
fit ``ResNetModule(depth=10)`` narrowed to ``num_filters=8``
(``torch_world.NarrowResNet``; the JAX side a test-local subclass) from
the JAX trainer's initial variables, on the same numpy images, under
each of ``RayStrategy``, ``HorovodRayStrategy``, ``RayShardedStrategy``
and ``FSDPStrategy``, against the JAX trainer's ``num_workers=2`` fit
under the same strategy on two virtual CPU devices: per-step losses,
final params and final running statistics, each within 1e-5.

The two families keep different rules, and each is held to its own: the
JAX SPMD strategies (DDP, ZeRO, FSDP) compute batch statistics over the
global batch, which the port's ranks reach by all-reducing their
per-channel means inside the forward (with the all-reduce's backward),
while JAX's ``HorovodRayStrategy`` computes them per rank and
``pmean``\\ s ``model_state`` after the step, which the port's does by
averaging the floating buffers. The two rules end at running statistics
that differ by far more than the tolerance, which the last case shows.
Also: a 2 → 1 resume through ``reshard_state`` (FSDP2's directory
checkpoint) restores params and buffers element-identical, and the
XOR model's constant metrics round-trip through the launcher
(``tests/test_ddp.py``'s case).
"""
import functools

import numpy as np
import pytest
import torch

import jax
from ray_lightning_tpu import FSDPStrategy as JaxFSDPStrategy
from ray_lightning_tpu import HorovodRayStrategy as JaxHorovodRayStrategy
from ray_lightning_tpu import RayShardedStrategy as JaxRayShardedStrategy
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import LambdaCallback as JaxLambda
from ray_lightning_tpu.models import resnet as jax_resnet
from ray_lightning_tpu_torch import (FSDPStrategy, HorovodRayStrategy,
                                     ModelCheckpoint, RayShardedStrategy,
                                     RayStrategy, Trainer, XORDataModule,
                                     XORModel)
from ray_lightning_tpu_torch.core.checkpoint import (find_resume_candidates,
                                                     load_sharded_checkpoint)
from ray_lightning_tpu_torch.interop import flax_state_dict

import torch_world as tw

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port, pytest.mark.multiproc]

FIT = dict(max_epochs=1, limit_train_batches=4, limit_val_batches=1, seed=0)
STRATEGIES = {  # name: (port strategy, JAX strategy)
    "ddp": (RayStrategy, JaxRayStrategy),
    "horovod": (HorovodRayStrategy, JaxHorovodRayStrategy),
    "zero": (RayShardedStrategy, JaxRayShardedStrategy),
    "fsdp": (FSDPStrategy, JaxFSDPStrategy),
}
NARROW = dict(depth=10, batch_size=8, image_size=16, num_samples=32)


@pytest.fixture(scope="module")
def world():
    w = tw.World()
    yield w
    w.ray.shutdown()
    assert w.ray.live_actor_count() == 0


class _JaxNarrow(jax_resnet.ResNetModule):
    def configure_model(self):
        return jax_resnet.resnet10(self.num_classes, dtype=self.dtype,
                                   num_filters=8)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@functools.lru_cache(maxsize=None)
def jax_fit(name: str) -> dict:
    """The JAX trainer's ``num_workers=2`` fit: initial and final
    variables (numpy) and per-step losses."""
    out = {"losses": []}

    def on_start(tr, m):
        out["init"] = _np({"params": tr.train_state.params,
                           **tr.train_state.model_state})

    def on_batch_end(tr, m, outputs, batch, batch_idx):
        out["losses"].append(float(np.asarray(outputs["loss"])))

    trainer = JaxTrainer(strategy=STRATEGIES[name][1](num_workers=2),
                         callbacks=[JaxLambda(on_fit_start=on_start,
                                              on_train_batch_end=on_batch_end)],
                         **FIT)
    trainer.fit(_JaxNarrow(**NARROW))
    out["final"] = _np({"params": trainer.train_state.params,
                        **trainer.train_state.model_state})
    return out


def fit2(world, name, module, callbacks=(), **kw):
    rec = tw.LossRecorder()
    trainer = Trainer(strategy=STRATEGIES[name][0](num_workers=2,
                                                   device="cpu"),
                      callbacks=[rec, *callbacks], **{**FIT, **kw})
    world.run(trainer, "fit", module)
    return trainer, rec.losses


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_two_process_resnet_matches_jax_two_device_fit(world, name):
    ref = jax_fit(name)
    trainer, losses = fit2(world, name, tw.NarrowResNet(ref["init"]))
    assert trainer.global_step == 4
    np.testing.assert_allclose(losses, ref["losses"], atol=1e-5, rtol=0)
    got = trainer.train_state_dict["params"]
    want = flax_state_dict(ref["final"])
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w, atol=1e-5, rtol=0,
                                   err_msg=n)


def test_spmd_and_horovod_statistics_differ():
    """The global batch's statistics and the mean of per-rank ones move
    the running variance apart by far more than 1e-5, so each strategy's
    match above holds its own rule."""
    spmd = flax_state_dict(jax_fit("ddp")["final"])
    hvd = flax_state_dict(jax_fit("horovod")["final"])
    gap = max(float(np.abs(spmd[k] - hvd[k]).max()) for k in spmd
              if k.endswith("running_var"))
    assert gap > 1e-3


def test_two_to_one_reshard_resume_keeps_the_buffers(world, tmp_path):
    """FSDP2's directory checkpoint of a two-process fit, resumed in one
    process (``reshard_state`` under a world change) with nothing left to
    train: params and running statistics element-identical to the
    checkpoint's."""
    ck = str(tmp_path / "ck")
    saved, _ = fit2(world, "fsdp", tw.NarrowResNet(), limit_val_batches=0,
                    callbacks=[ModelCheckpoint(dirpath=ck,
                                               save_format="orbax")])
    host = load_sharded_checkpoint(find_resume_candidates(ck)[0])
    assert host["world"]["world_size"] == 2
    one = Trainer(strategy=RayStrategy(device="cpu"), resume="auto",
                  callbacks=[ModelCheckpoint(dirpath=ck,
                                             save_format="orbax")],
                  **{**FIT, "limit_val_batches": 0})
    one.fit(tw.NarrowResNet())
    got = one.train_state.state_dict()["params"]
    want = host["state"]["params"]
    assert set(got) == set(want)
    assert any(k.endswith("running_mean") for k in want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    for k, w in saved.train_state_dict["params"].items():
        assert torch.equal(got[k], w), k


def test_xor_metrics_roundtrip(world):
    """Exact constant-metric round trip through the launcher
    (``tests/test_ddp.py``'s ``test_metrics_roundtrip``)."""
    trainer = Trainer(strategy=RayStrategy(num_workers=2, device="cpu"),
                      max_epochs=1, limit_train_batches=4,
                      limit_val_batches=4)
    world.run(trainer, "fit", XORModel(), datamodule=XORDataModule(8))
    assert np.isclose(float(trainer.callback_metrics["avg_train_loss"]),
                      XORModel.TRAIN_CONSTANT, atol=1e-5)
    assert np.isclose(float(trainer.callback_metrics["avg_val_loss"]),
                      XORModel.VAL_CONSTANT, atol=1e-5)
