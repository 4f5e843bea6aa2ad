"""Picklable modules and callbacks for the port's multi-process tests.

A spawned worker unpickles the trainer and its module by import path, so
what it runs must live at module level in a module the worker can import
without jax: this one imports torch and the port only (the test files,
which import both packages, are never imported by a worker).
"""
import numpy as np
import torch
import torch.distributed as dist

from ray_lightning_tpu_torch import (BoringModel, GPTModule, MoeModule,
                                     ResNetModule, Seq2SeqModule,
                                     TransformerConfig, gpt2_config,
                                     moe_config, resnet10)
from ray_lightning_tpu_torch.core import Callback
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.launchers import (ExecutorBase, ProcessRay,
                                               RayLauncher)

NANO = dict(vocab_size=256, max_seq_len=32)
SGD_LR = 0.5


def nano_cfg():
    return gpt2_config("nano", attention_impl="flash", dtype=torch.float32,
                       **NANO)


class Nano(GPTModule):
    """nano GPT on the flash path, started from a flax-layout tree of
    numpy arrays (the JAX trainer's initial params) when one is given,
    trained with SGD (``opt="sgd"``), SGD with momentum (``"momentum"``:
    optimizer state that moves linearly with the gradients) or the
    module's AdamW; ``schedule`` returns ``(factory, lr schedule)``;
    ``cfg`` replaces :func:`nano_cfg`."""

    def __init__(self, init=None, opt="adamw", schedule=False, cfg=None,
                 **kw):
        super().__init__(config=cfg or nano_cfg(), **kw)
        self.init = init
        self.opt = opt
        self.schedule = schedule

    def init_variables(self, model, generator, batch):
        if self.init is None:
            return super().init_variables(model, generator, batch)
        load_flax_params(model, self.init)

    def configure_optimizers(self):
        if self.opt == "sgd":
            factory = lambda p: torch.optim.SGD(p, lr=SGD_LR)  # noqa: E731
        elif self.opt == "momentum":
            factory = lambda p: torch.optim.SGD(  # noqa: E731
                p, lr=0.1, momentum=0.9)
        else:
            factory = super().configure_optimizers()
        if self.schedule:
            return factory, lr_schedule
        return factory

    def predict_dataloader(self):
        return self.val_dataloader()

    def predict_step(self, model, batch, generator):
        return model(batch[0])


class NarrowResNet(ResNetModule):
    """``ResNetModule(depth=10)`` at ``num_filters=8`` (the JAX tests'
    narrowing: ``ResNet`` takes it, ``ResNetModule`` does not), started
    from flax variables ``{"params", "batch_stats"}`` of numpy arrays
    (the JAX trainer's initial state) when ``init`` is given."""

    def __init__(self, init=None, **kw):
        kw = {"depth": 10, "batch_size": 8, "image_size": 16,
              "num_samples": 32, **kw}
        super().__init__(**kw)
        self.init = init

    def configure_model(self):
        return resnet10(self.num_classes, dtype=self.dtype, num_filters=8,
                        device="meta")

    def init_variables(self, model, generator, batch):
        if self.init is None:
            return super().init_variables(model, generator, batch)
        load_flax_params(model, self.init)


#: the two-process MoE: one layer, banks (4, 128, 256) that adafactor
#: factors, and a capacity factor at which the global capacity binds
MOE_NARROW = dict(d_model=128, n_heads=2, d_ff=256, n_layers=1, n_experts=4,
                  vocab_size=128, max_seq_len=16, capacity_factor=0.5)
MOE_FIT = dict(batch_size=8, seq_len=16, num_samples=64, lr=3e-3)


class NarrowMoe(MoeModule):
    """``MoeModule`` at :data:`MOE_NARROW` in f32 (``optimizer`` one of
    ``make_optimizer``'s presets), started from the JAX trainer's initial
    params (a flax tree of numpy arrays) when ``init`` is given."""

    def __init__(self, init=None, optimizer="adafactor"):
        super().__init__(config=moe_config(dtype=torch.float32,
                                           **MOE_NARROW),
                         optimizer=optimizer, **MOE_FIT)
        self.init = init

    def init_variables(self, model, generator, batch):
        if self.init is None:
            return super().init_variables(model, generator, batch)
        load_flax_params(model, self.init)


#: the two-process encoder-decoder: tests/test_seq2seq.py's widths, f32
S2S_NARROW = dict(vocab_size=32, max_seq_len=8, d_model=64, n_heads=4,
                  n_layers=2, d_ff=128, causal=True)
S2S_FIT = dict(batch_size=8, seq_len=8, num_samples=64, vocab_size=32,
               lr=3e-3)


class NarrowSeq2Seq(Seq2SeqModule):
    """``Seq2SeqModule`` at :data:`S2S_NARROW` in f32 (``attention_impl``
    as given), started from the JAX trainer's initial params (a flax tree
    of numpy arrays) when ``init`` is given."""

    def __init__(self, init=None, attention_impl="dot"):
        super().__init__(config=TransformerConfig(
            dtype=torch.float32, attention_impl=attention_impl,
            **S2S_NARROW), **S2S_FIT)
        self.init = init

    def init_variables(self, model, generator, batch):
        if self.init is None:
            return super().init_variables(model, generator, batch)
        load_flax_params(model, self.init)


def lr_schedule(n):
    return 1e-2 / (1.0 + n)


class Poisoned(BoringModel):
    """BoringModel whose loss value turns NaN at its ``poison_at``-th
    training step on rank ``poison_rank`` alone (rank 0 in one process),
    its gradients left finite: only the verdict reduced over ranks makes
    the other ranks skip that update too."""

    def __init__(self, poison_at=2, poison_rank=1, **kw):
        super().__init__(**kw)
        self.poison_at = poison_at
        self.poison_rank = poison_rank
        self.steps = 0

    def training_step(self, model, batch, generator):
        loss = super().training_step(model, batch, generator)
        self.steps += 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        if self.steps == self.poison_at and rank == self.poison_rank:
            loss = loss + loss.detach() * float("nan")
        return loss


class Failing(BoringModel):
    """BoringModel whose rank ``fail_rank`` raises in its first step."""

    def __init__(self, fail_rank=1, **kw):
        super().__init__(**kw)
        self.fail_rank = fail_rank

    def training_step(self, model, batch, generator):
        if dist.get_rank() == self.fail_rank:
            raise ValueError(f"rank {self.fail_rank} failed on purpose")
        return super().training_step(model, batch, generator)


class AdamBoring(BoringModel):
    """BoringModel trained with the port's AdamW (optimizer state to
    reshard)."""

    def configure_optimizers(self):
        from ray_lightning_tpu_torch.core.optim import make_optimizer
        return make_optimizer("adamw", 1e-2)


class EventProbe(Callback):
    """The worker trainer's telemetry events at the end of its fit, as
    ``(site, payload)`` pairs, and its metrics snapshot, carried to the
    driver as this callback's state (a worker's events land on its own
    copy of the handle)."""

    def __init__(self):
        self.events, self.metrics = [], {}

    def on_fit_end(self, trainer, module):
        tel = trainer.telemetry
        if tel is not None:
            self.events = [(e.site, dict(e.payload)) for e in tel.events()]
            self.metrics = tel.metrics.snapshot()

    def state_dict(self):
        return {"events": list(self.events), "metrics": dict(self.metrics)}

    def load_state_dict(self, state):
        self.events = list(state["events"])
        self.metrics = dict(state["metrics"])


class LossRecorder(Callback):
    """Per-step losses, carried back to the driver as this callback's
    state (the worker -> driver channel for callback states)."""

    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch,
                           batch_idx):
        self.losses.append(float(outputs["loss"]))

    def state_dict(self):
        return {"losses": list(self.losses)}

    def load_state_dict(self, state):
        self.losses = list(state["losses"])


class StepRecorder(Callback):
    """Per-step values of the step's outputs named in ``keys`` (the loss
    and logged metrics, reduced over ranks), carried back to the driver
    as this callback's state."""

    def __init__(self, keys=("loss",)):
        self.keys = tuple(keys)
        self.rows = []

    def on_train_batch_end(self, trainer, module, outputs, batch,
                           batch_idx):
        self.rows.append({k: float(outputs[k]) for k in self.keys})

    def state_dict(self):
        return {"rows": list(self.rows)}

    def load_state_dict(self, state):
        self.rows = list(state["rows"])


class SaveAt(Callback):
    """``trainer.save_checkpoint(path, ...)`` after global step ``step``,
    on every rank (a collective under a process group)."""

    def __init__(self, step, path, save_format="stream", async_save=False):
        self.step = step
        self.path = path
        self.save_format = save_format
        self.async_save = async_save

    def on_train_batch_end(self, trainer, module, outputs, batch,
                           batch_idx):
        if trainer.global_step == self.step:
            trainer.save_checkpoint(self.path, save_format=self.save_format,
                                    async_save=self.async_save)


class OptStateBytes(Callback):
    """Each rank's ``opt_state_bytes``, rank by rank
    (``opt_state_bytes_rank<r>``), and the world's sum, into
    ``callback_metrics`` (rank 0's reach the driver)."""

    def on_train_end(self, trainer, module):
        from ray_lightning_tpu_torch.core.optim import opt_state_bytes
        mine = opt_state_bytes(trainer.train_state.optimizer)
        world = dist.get_world_size() if dist.is_initialized() else 1
        t = torch.zeros(world, dtype=torch.float64)
        t[trainer.global_rank] = float(mine)
        if dist.is_initialized():
            dist.all_reduce(t)
        m = trainer.callback_metrics
        m["opt_state_bytes"] = float(mine)
        m["opt_state_bytes_world"] = float(t.sum())
        for r in range(world):
            m[f"opt_state_bytes_rank{r}"] = float(t[r])


class DumpProbe(Callback):
    """``Trainer.dump_checkpoint`` under each value of ``consolidate`` at
    the end of a fit (a collective: every rank calls it), into
    ``callback_metrics``: the DTensor shards each dump's ``state`` keeps
    and their local element counts, and whether the old ``full=``
    keyword is refused with ``TypeError``."""

    def on_train_end(self, trainer, module):
        from torch.distributed.tensor import DTensor

        def leaves(tree):
            if isinstance(tree, dict):
                for v in tree.values():
                    yield from leaves(v)
            elif isinstance(tree, (list, tuple)):
                for v in tree:
                    yield from leaves(v)
            elif isinstance(tree, torch.Tensor):
                yield tree

        m = trainer.callback_metrics
        for key, consolidate in (("kept", False), ("whole", True)):
            state = trainer.dump_checkpoint(consolidate=consolidate)["state"]
            ts = list(leaves(state))
            m[f"dtensors_{key}"] = float(sum(isinstance(t, DTensor)
                                             for t in ts))
            m[f"numel_{key}"] = float(sum(
                (t.to_local() if isinstance(t, DTensor) else t).numel()
                for t in ts))
        try:
            trainer.dump_checkpoint(full=False)
        except TypeError:
            m["full_keyword_refused"] = 1.0
        else:
            m["full_keyword_refused"] = 0.0


class RankProbe(Callback):
    """Puts this rank and whether this process has a Ray Tune of its own
    into ``callback_metrics`` at the end of every train epoch (list it
    before a Tune callback, which then reports them)."""

    def on_train_epoch_end(self, trainer, module):
        import ray_lightning_tpu_torch.tune as tune_mod
        trainer.callback_metrics["rank"] = float(trainer.global_rank)
        trainer.callback_metrics["worker_has_tune"] = float(
            tune_mod.tune is not None)

    on_train_end = on_train_epoch_end


def jax_tune_found_here() -> bool:
    """Whether the JAX package's ``tune`` module finds a Tune in the
    process that runs this (it imports jax: only the Tune test's
    probe of the reference calls it)."""
    import ray_lightning_tpu.tune as jax_tune
    return jax_tune.tune is not None


RECEIVED = []


def receive(rank, i):
    """A queued item's work in the driver: record ``(rank, i)``."""
    RECEIVED.append((rank, i))


def put_many(queue, rank, n):
    """Put ``n`` items that record ``(rank, i)`` where they run."""
    import functools
    for i in range(n):
        queue.put((rank, functools.partial(receive, rank, i)))
    return n


def put_into(queue, item):
    """``queue.put((0, item))`` in whichever process runs it."""
    queue.put((0, item))
    return True


class World:
    """``size`` spawned worker processes (two by default), made on first
    use and reused by every fit of a test file (``RayLauncher(workers=)``;
    a strategy of fewer workers takes the first ones); a failed launch
    kills them, and the next fit spawns a fresh set."""

    def __init__(self, size=2):
        self.ray = ProcessRay(num_threads=1)
        self.ray.init()
        self.size = size
        self.workers = []

    def _live_workers(self):
        if not self.workers or any(w._killed for w in self.workers):
            for w in self.workers:
                if not w._killed:
                    self.ray.kill(w)
            self.workers = [self.ray.remote(ExecutorBase).remote()
                            for _ in range(self.size)]
        return self.workers

    def launcher(self, strategy, **kw):
        return RayLauncher(
            strategy, ray_module=self.ray,
            workers=self._live_workers()[:strategy.num_workers], **kw)

    def collective(self, fn, *args):
        """``fn(rank, world_size, init_method, *args)`` on both workers
        at once (``fn`` forms its own gloo group at ``init_method``);
        rank 0's result. A failure kills the pair; a rendezvous port
        taken in between (as in :meth:`run`) is retried once."""
        from ray_lightning_tpu_torch.launchers.utils import find_free_port
        from ray_lightning_tpu_torch.util import process_results
        for attempt in range(2):
            workers = self._live_workers()[:2]
            port = self.ray.get(workers[0].execute.remote(find_free_port))
            futures = [w.execute.remote(fn, r, len(workers),
                                        f"tcp://127.0.0.1:{port}", *args)
                       for r, w in enumerate(workers)]
            try:
                return process_results(futures, self.ray)[0]
            except Exception as exc:
                for w in workers:
                    self.ray.kill(w)
                if attempt or "EADDRINUSE" not in str(exc):
                    raise

    def run(self, trainer, stage, *args, **kwargs):
        """``trainer.<stage>(*args, **kwargs)`` on this world's workers.

        The launcher probes the rendezvous port on worker 0, and rank 0's
        store binds it a moment later; a world of another test file
        running beside this one (``pytest -n``) may take the port in
        between. Rank 0 then fails at once with EADDRINUSE, the failed
        launch kills the pair, and the stage runs once more, on a fresh
        pair and a fresh port. Any other failure raises."""
        for attempt in range(2):
            trainer._launcher = self.launcher(trainer.strategy)
            try:
                return getattr(trainer, stage)(*args, **kwargs)
            except Exception as exc:
                if attempt or "EADDRINUSE" not in str(exc):
                    raise


# f32 momentum: the shard-aware means are what is held, not the bf16
# momentum's rounding (which can flip when an f32 sum changes order)
ADAFACTOR = dict(lr=1e-2, weight_decay_rate=1e-3,
                 momentum_dtype=torch.float32)


def adafactor_case(shape, steps, seed=0):
    """A param and ``steps`` gradients of ``shape``, from numpy."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    grads = [rng.standard_normal(shape).astype(np.float32) * (0.1 + i)
             for i in range(steps)]
    return p, grads


def adafactor_on_shards(rank, world_size, init_method, cases, steps):
    """Adafactor steps on DTensor params, each sharded along its given
    dimension by ``torch.chunk``'s split (uneven where the world size
    does not divide it), in a gloo group of its own: rank 0 returns the
    full params and the full optimizer state, and every rank its local
    ``(v_row, v_col)`` shapes."""
    import datetime

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from ray_lightning_tpu_torch.core.optim import Adafactor
    from ray_lightning_tpu_torch.strategies.sharding import full_state
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", (world_size,))

        def shard(full, dim):
            local = torch.chunk(full, world_size, dim=dim)[rank]
            return DTensor.from_local(local.contiguous(), mesh, [Shard(dim)],
                                      run_check=False, shape=full.shape,
                                      stride=full.stride())

        data = [adafactor_case(shape, steps, seed=i)
                for i, (shape, _dim) in enumerate(cases)]
        params = [torch.nn.Parameter(shard(torch.from_numpy(p), dim))
                  for (p, _g), (_s, dim) in zip(data, cases)]
        opt = Adafactor(params, **ADAFACTOR)
        for step in range(steps):
            for p, (_p, grads), (_s, dim) in zip(params, data, cases):
                p.grad = shard(torch.from_numpy(grads[step]), dim)
            opt.step()
        state = full_state(opt.state_dict())
        full = [p.full_tensor().detach() for p in params]
        locals_ = [tuple(tuple(opt.state[p][k].to_local().shape)
                         if hasattr(opt.state[p][k], "to_local")
                         else tuple(opt.state[p][k].shape)
                         for k in ("v_row", "v_col")) for p in params]
        return {"params": full, "state": state, "local_moments": locals_}
    finally:
        dist.destroy_process_group()


def host(tree):
    """A state dict's tensors as numpy arrays, by name."""
    return {k: np.asarray(v.detach().cpu()) for k, v in tree.items()}


class TwoArgError(Exception):
    """An exception whose ``__init__`` pickle cannot call (it passes only
    the message): it pickles in the worker but does not unpickle."""

    def __init__(self, what, why):
        super().__init__(f"{what}: {why}")


def raise_two_arg_error():
    raise TwoArgError("worker", "failed")
