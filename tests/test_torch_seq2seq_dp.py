"""The encoder-decoder under the port's data parallelism, against the JAX package's two-device fits.

Two spawned gloo workers (``device="cpu"``, one module-scoped world)
fit ``torch_world.NarrowSeq2Seq`` (``tests/test_seq2seq.py``'s widths,
f32, the ``(src, tgt)`` tuple batch) from the JAX trainer's initial
params on the same numpy pairs, under each of ``RayStrategy``,
``HorovodRayStrategy``, ``RayShardedStrategy`` and ``FSDPStrategy``,
against the JAX trainer's ``num_workers=2`` DDP fit on two virtual CPU
devices: per-step losses within 1e-5, final params by
``test_torch_seq2seq.assert_fit_params``' AdamW rules. The JAX
package's four strategies make one update here (the model has no
batch-dependent state), so one JAX fit is the reference for all four.

A port rank holds rows ``[r·B/2, (r+1)·B/2)`` of each global batch of
both leaves (``Strategy.shard_batch``), the rows JAX's
``put_global_batch`` hands device r; the loss is a mean over equal-length
rows, so the mean over ranks of each rank's mean is the global batch's,
and seq2seq has no batch-dependent state: no strategy needs a seat of
its own for it. Also the reversal gate (``tests/test_seq2seq.py``'s
``test_reversal_task_learns``) on two workers: held-out token accuracy
above 0.5.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import LambdaCallback as JaxLambda
from ray_lightning_tpu.models import seq2seq as jax_seq2seq
from ray_lightning_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from ray_lightning_tpu_torch import (FSDPStrategy, HorovodRayStrategy,
                                     RayShardedStrategy, RayStrategy,
                                     Seq2SeqModule, Trainer)
from ray_lightning_tpu_torch.interop import flax_state_dict

import torch_world as tw
from test_torch_seq2seq import assert_fit_params

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port, pytest.mark.multiproc]

STEPS = 4
FIT = dict(max_epochs=1, limit_train_batches=STEPS, limit_val_batches=1,
           seed=0)
STRATEGIES = {"ddp": RayStrategy, "horovod": HorovodRayStrategy,
              "zero": RayShardedStrategy, "fsdp": FSDPStrategy}


@pytest.fixture(scope="module")
def world():
    w = tw.World()
    yield w
    w.ray.shutdown()
    assert w.ray.live_actor_count() == 0


@functools.lru_cache(maxsize=None)
def jax_fit() -> dict:
    """The JAX trainer's ``num_workers=2`` DDP fit: initial and final
    params (numpy) and per-step losses."""
    out = {"losses": []}

    def on_start(tr, m):
        out["init"] = jax.tree_util.tree_map(np.array,
                                             tr.train_state.params)

    def on_batch_end(tr, m, outputs, batch, batch_idx):
        out["losses"].append(float(np.asarray(outputs["loss"])))

    trainer = JaxTrainer(strategy=JaxRayStrategy(num_workers=2),
                         callbacks=[JaxLambda(on_fit_start=on_start,
                                              on_train_batch_end=on_batch_end)],
                         **FIT)
    cfg = JaxTransformerConfig(dtype=jnp.float32, **tw.S2S_NARROW)
    trainer.fit(jax_seq2seq.Seq2SeqModule(config=cfg, **tw.S2S_FIT))
    out["final"] = jax.tree_util.tree_map(np.array,
                                          trainer.train_state.params)
    return out


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_two_process_seq2seq_matches_jax_two_device_fit(world, name):
    ref = jax_fit()
    rec = tw.LossRecorder()
    trainer = Trainer(strategy=STRATEGIES[name](num_workers=2,
                                                device="cpu"),
                      callbacks=[rec], **FIT)
    world.run(trainer, "fit", tw.NarrowSeq2Seq(ref["init"]))
    assert trainer.global_step == STEPS
    np.testing.assert_allclose(rec.losses, ref["losses"], atol=1e-5,
                               rtol=0)
    got = {n: t.numpy() for n, t in
           trainer.train_state_dict["params"].items()}
    assert_fit_params(got, flax_state_dict(ref["final"]),
                      tw.S2S_FIT["lr"], STEPS)


def test_a_rank_holds_its_half_of_both_leaves():
    """The first global batch's ``(src, tgt)`` split as the strategies
    split it: rank r's rows of both leaves are rows ``[4r, 4r + 4)`` of
    the JAX module's first batch, and each target row is its source
    reversed."""
    src, tgt = next(iter(tw.NarrowSeq2Seq().train_dataloader()))
    jsrc, jtgt = next(iter(jax_seq2seq.Seq2SeqModule(
        config=JaxTransformerConfig(**tw.S2S_NARROW),
        **tw.S2S_FIT).train_dataloader()))
    strategy = RayStrategy(num_workers=2, device="cpu")
    strategy._in_world = True
    for r in range(2):
        strategy._global_rank = r
        s, t = strategy.shard_batch((src, tgt))
        np.testing.assert_array_equal(s, jsrc[4 * r:4 * r + 4])
        np.testing.assert_array_equal(t, jtgt[4 * r:4 * r + 4])
        np.testing.assert_array_equal(t, s[:, ::-1])


def test_reversal_task_learns_on_two_workers(world):
    """``tests/test_seq2seq.py``'s gate: held-out token accuracy far above
    chance (1/64) after 4 epochs of 16 batches of 32 on two workers."""
    trainer = Trainer(strategy=RayStrategy(num_workers=2, device="cpu"),
                      max_epochs=4, limit_train_batches=16,
                      limit_val_batches=4)
    world.run(trainer, "fit", Seq2SeqModule(batch_size=32, seq_len=8,
                                            num_samples=512, vocab_size=64,
                                            lr=3e-3))
    acc = float(trainer.callback_metrics["val_acc"])
    assert acc > 0.5, f"cross-attention did not learn reversal: {acc}"
