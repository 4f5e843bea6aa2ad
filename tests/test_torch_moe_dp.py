"""The MoE's routing rules under the port's data parallelism, against the JAX package's two-device fits.

Two spawned gloo workers (``device="cpu"``, one module-scoped world)
fit ``torch_world.NarrowMoe`` (one layer, expert banks (4, 128, 256),
capacity factor 0.5, adafactor) from the JAX trainer's initial params on
the same numpy tokens, under each of ``RayStrategy``,
``RayShardedStrategy``, ``FSDPStrategy`` and ``HorovodRayStrategy``,
against the JAX trainer's ``num_workers=2`` fit under the same strategy
on two virtual CPU devices: per-step losses and ``train_aux`` at 1e-4,
final params by ``test_torch_moe.assert_fit_params``'s bounds.

The two families keep different rules, and each is held to its own. The
JAX SPMD strategies route the global batch (8 rows of 16 tokens,
capacity 16 an expert): a port rank routes its 4 rows as their place in
it routes them, each expert's positions offset by the tokens rank 0 sent there.
JAX's ``HorovodRayStrategy`` routes each rank's rows under
``shard_map`` (capacity 8), and so does the port's. The capacity binds
across the rank boundary in both (asserted on the JAX routing of the
first global batch), and the two rules end at losses that differ by far
more than the tolerance, which the last case shows. Under ZeRO the
expert banks' adafactor state is split along d_ff (the JAX rule), under
FSDP2 the banks along the experts; adafactor on banks split either way
(and unevenly) equals adafactor on the whole banks.
"""
import functools

import numpy as np
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
from ray_lightning_tpu.models import moe as jax_moe
from ray_lightning_tpu_torch import (FSDPStrategy, HorovodRayStrategy,
                                     RayShardedStrategy, RayStrategy,
                                     Trainer)
from ray_lightning_tpu_torch.interop import flax_state_dict
from ray_lightning_tpu_torch.models.moe import moe_config
from ray_lightning_tpu_torch.strategies.sharding import shard_dim

import torch_world as tw
from test_torch_moe import assert_fit_params

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port, pytest.mark.multiproc]

STEPS = 4
FIT = dict(max_epochs=1, limit_train_batches=STEPS, limit_val_batches=1,
           seed=0)
STRATEGIES = {  # name: (port strategy, JAX strategy)
    "ddp": (RayStrategy, JaxRayStrategy),
    "horovod": (HorovodRayStrategy, JaxHorovodRayStrategy),
    "zero": (RayShardedStrategy, JaxRayShardedStrategy),
    "fsdp": (FSDPStrategy, JaxFSDPStrategy),
}
KEYS = ("loss", "train_aux")


@pytest.fixture(scope="module")
def world():
    w = tw.World()
    yield w
    w.ray.shutdown()
    assert w.ray.live_actor_count() == 0


def _jax_module():
    cfg = jax_moe.moe_config(dtype=jnp.float32, **tw.MOE_NARROW)
    return jax_moe.MoeModule(config=cfg, optimizer="adafactor", **tw.MOE_FIT)


@functools.lru_cache(maxsize=None)
def jax_fit(name: str) -> dict:
    """The JAX trainer's ``num_workers=2`` fit: initial and final params
    (numpy), per-step losses and ``train_aux``."""
    out = {"rows": []}

    def on_start(tr, m):
        out["init"] = jax.tree_util.tree_map(np.array,
                                             tr.train_state.params)

    def on_batch_end(tr, m, outputs, batch, batch_idx):
        out["rows"].append({k: float(np.asarray(outputs[k])) for k in KEYS})

    trainer = JaxTrainer(strategy=STRATEGIES[name][1](num_workers=2),
                         callbacks=[JaxLambda(on_fit_start=on_start,
                                              on_train_batch_end=on_batch_end)],
                         **FIT)
    trainer.fit(_jax_module())
    out["final"] = jax.tree_util.tree_map(np.array,
                                          trainer.train_state.params)
    return out


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_two_process_moe_matches_jax_two_device_fit(world, name):
    ref = jax_fit(name)
    rec = tw.StepRecorder(KEYS)
    trainer = Trainer(strategy=STRATEGIES[name][0](num_workers=2,
                                                   device="cpu"),
                      callbacks=[rec], **FIT)
    world.run(trainer, "fit", tw.NarrowMoe(ref["init"]))
    assert trainer.global_step == STEPS
    for key in KEYS:
        np.testing.assert_allclose([r[key] for r in rec.rows],
                                   [r[key] for r in ref["rows"]],
                                   atol=1e-4, rtol=0, err_msg=key)
    state = trainer.train_state_dict
    got = {n: t.numpy() for n, t in state["params"].items()}
    # adafactor's state by parameter index (its counts sit beside, under
    # string keys)
    names = list(got)
    emas = {names[i]: float(st["ema"].float().abs().max())
            for i, st in state["opt_state"]["state"].items()
            if isinstance(i, int)}
    cfg = moe_config(dtype=torch.float32, **tw.MOE_NARROW)
    assert_fit_params(got, flax_state_dict(ref["final"]), emas, cfg,
                      tw.MOE_FIT["lr"], STEPS)


def test_the_capacity_binds_across_the_rank_boundary():
    """On the first global batch of the fit, JAX's global routing drops
    tokens and keeps tokens of both halves of the batch (both ranks'
    rows), and rank 1's rows routed alone would keep other slots: the
    offset by rank 0's tokens decides which of them keep theirs."""
    module = _jax_module()
    tokens = next(iter(module.train_dataloader()))[0]
    seen = []
    real = jax_moe.route_top_k

    def spy(probs, capacity, top_k):
        seen.append((np.array(probs), capacity, top_k))
        return real(probs, capacity, top_k)

    jax_moe.route_top_k = spy
    try:
        jax_moe.MoeTransformerLM(module.cfg).apply(
            {"params": jax_fit("ddp")["init"]}, jnp.asarray(tokens))
    finally:
        jax_moe.route_top_k = real
    probs, capacity, k = seen[0]
    n = probs.shape[0]
    dispatch = np.asarray(real(jnp.asarray(probs), capacity, k)[0])
    assert dispatch.sum() < k * n                      # tokens drop
    kept = dispatch.sum((1, 2)) > 0
    assert kept[:n // 2].any() and kept[n // 2:].any()
    alone = np.asarray(real(jnp.asarray(probs[n // 2:]), capacity, k)[0])
    assert not np.array_equal(alone, dispatch[n // 2:])


# expert banks (E, d, d_ff) split as the strategies split them: FSDP2
# along the experts (evenly, and unevenly with 5), ZeRO along the
# dimension the JAX rule picks (d_ff, the largest)
BANK_CASES = (((4, 128, 256), 0), ((5, 128, 160), 0), ((4, 128, 256), 2),
              ((4, 256, 128), 1))
BANK_STEPS = 3


def test_adafactor_on_split_expert_banks_equals_the_whole_banks(world):
    """Adafactor on 3-D banks split over two ranks equals adafactor on
    the whole banks (which ``test_torch_moe.py`` holds to optax): params
    at 1e-6, the factored moments (E, d) and (E, d_ff) and the momentum
    at 1e-5; the moment that averages over the split dimension is kept
    split by the JAX rule, the other as the bank is."""
    from ray_lightning_tpu_torch.core.optim import Adafactor
    assert shard_dim(BANK_CASES[2][0], 2) == 2
    got = world.collective(tw.adafactor_on_shards, BANK_CASES, BANK_STEPS)
    params = [torch.nn.Parameter(torch.from_numpy(
        tw.adafactor_case(shape, BANK_STEPS, seed=i)[0]))
        for i, (shape, _dim) in enumerate(BANK_CASES)]
    opt = Adafactor(params, **tw.ADAFACTOR)
    for step in range(BANK_STEPS):
        for i, ((shape, _dim), p) in enumerate(zip(BANK_CASES, params)):
            p.grad = torch.from_numpy(
                tw.adafactor_case(shape, BANK_STEPS, seed=i)[1][step])
        opt.step()
    want = opt.state_dict()
    for i, p in enumerate(params):
        np.testing.assert_allclose(got["params"][i], p.detach(), atol=1e-6,
                                   rtol=0, err_msg=str(BANK_CASES[i]))
        E, d, f = p.shape
        # factored over the two last axes, the experts batched
        assert {tuple(want["state"][i][k].shape) for k in
                ("v_row", "v_col")} == {(E, d), (E, f)}
        for k in ("v_row", "v_col", "ema"):
            w, g = want["state"][i][k], got["state"]["state"][i][k]
            assert g.shape == w.shape, (i, k)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{BANK_CASES[i]} {k}")
    assert got["local_moments"] == [((2, 128), (2, 256)),
                                    ((3, 128), (3, 160)),
                                    ((4, 64), (4, 128)),
                                    ((4, 64), (4, 128))]


def test_spmd_and_horovod_routing_differ():
    """Global and per-rank routing drop different tokens, so the two
    rules' losses part by far more than 1e-4: each strategy's match
    above holds its own rule."""
    spmd = [r["loss"] for r in jax_fit("ddp")["rows"]]
    hvd = [r["loss"] for r in jax_fit("horovod")["rows"]]
    assert max(abs(a - b) for a, b in zip(spmd, hvd)) > 1e-3
