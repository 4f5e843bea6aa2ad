"""Strategy base class (counterpart of ``ray_lightning_tpu/strategies/base.py``).

A strategy owns the resource spec, the launcher choice, the rank model
and the training step. ``num_workers`` means what it means in the JAX
package, the number of data-parallel ranks with one device each; how it
is carried out differs. The JAX package drives N chips from one process
(a ``dp`` mesh). PyTorch on GPUs runs one process per device, the
reference's own design (``ray_lightning/ray_ddp.py:171-213``), so
:meth:`Strategy.configure_launcher` returns

- the in-process ``LocalLauncher`` for ``num_workers == 1`` with
  ``use_ray`` unset or False (no process group: the one-process path);
- a ``RayLauncher`` over ``ray`` when a Ray runtime is attached
  (``ray.is_initialized()``, unless ``use_ray=False``);
- a ``RayLauncher`` over the subprocess backend ``ProcessRay`` (spawned
  OS processes on this host, no Ray needed) for ``num_workers > 1``
  without a Ray runtime or with ``use_ray=False``;
- ``RuntimeError`` for ``use_ray=True`` without a Ray runtime.

Devices: ``device=None`` means one card per worker, with NCCL
(``cpu:gloo,cuda:nccl``: gloo carries the CPU-side object exchange);
``device="cpu"`` CPU workers with gloo, which is how the tests run. A
worker's card is found in the worker (:meth:`worker_setup`), so a driver
with no card can launch card workers -- the counterpart of the JAX
package's ``DelayedTPUAccelerator``; a worker that finds no card raises.
Only the local launcher resolves the device at construction (and raises
there without a card). ``use_gpu=True`` and ``resources_per_worker=
{"GPU": 1}`` are accepted and mean ``device=None``; another GPU count
per worker, or ``use_tpu=True``, raises ``ValueError``.

Under a process group the step keeps the JAX step's semantics
(:meth:`make_train_step`): each rank trains on its rows of the global
batch (:meth:`shard_batch`), the gradients are the global batch's mean
(averaged over ranks before anything reads them), float logs are
averaged over ranks, and the non-finite guard's verdict is one flag
reduced over ranks, so every rank keeps or skips together. Subclasses
say how gradients are averaged and state is held: :meth:`wrap_model`,
:meth:`make_optimizer`, :meth:`sync_gradients`, :meth:`sync_buffers`,
:meth:`state_dict` and :meth:`load_state_dict`.

A module's buffers are its state (the JAX trainer's ``model_state``,
e.g. BatchNorm's running statistics, ``models/resnet.py``): the forward
moves them in place, and the step keeps the JAX rules for them. Under
the SPMD strategies (DDP, ZeRO, FSDP2: ``global_batch_stats``) a
module's batch statistics are the global batch's (:meth:`bind_batch_stats`),
so every rank moves its buffers alike; :class:`HorovodRayStrategy`
computes them on the rank's rows and averages the floating buffers over
ranks after every step (:meth:`sync_buffers`), as its JAX twin
``pmean``\\ s ``model_state``.

``gang=`` (a :class:`~ray_lightning_tpu_torch.reliability.gang.GangConfig`)
and ``standby=`` (a :class:`~ray_lightning_tpu_torch.reliability.elastic.
StandbyPool`) are handed to the ``RayLauncher`` this strategy makes: gang
supervision and warm standbys, as in the JAX package (the in-process
local launcher has no gang to supervise). :meth:`set_world_size` is the
elastic restart's seat.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_lightning_tpu_torch.core.optim import (clip_by_global_norm_,
                                                global_norm, local_tensor)
from ray_lightning_tpu_torch.core.train_state import TrainState
from ray_lightning_tpu_torch.data.loader import tree_leaves, tree_map
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.launchers.local import LocalLauncher
from ray_lightning_tpu_torch.reliability.guard import tree_all_finite

# how long a rank waits in the rendezvous and in a collective for its
# peers before it raises instead of hanging
PROCESS_GROUP_TIMEOUT_S = 300


def _shape(x) -> tuple:
    """A batch leaf's shape (a tensor's, an array's, () for a scalar)."""
    shape = getattr(x, "shape", None)
    return tuple(np.shape(x) if shape is None else shape)


def worker_resources(num_cpus_per_worker: int, use_gpu: bool,
                     use_tpu: Optional[bool],
                     resources_per_worker: Optional[Dict], device
                     ) -> Tuple[Any, bool, Dict, Optional[torch.device]]:
    """A worker's resources as the arguments ask for them: ``(CPUs, a
    card or not, other Ray resources, the device spec)``.
    ``resources_per_worker`` entries override the dedicated arguments
    (the reference's ``ray_ddp.py:85-112``): ``CPU`` beats
    ``num_cpus_per_worker``, ``GPU`` (which must be 1) beats
    ``use_gpu``. ``device=None`` means a card; ``use_tpu=True``, a TPU
    entry, a GPU count other than 1, or a card asked for beside a CPU
    ``device`` raise ``ValueError``."""
    if use_tpu:
        raise ValueError(
            "use_tpu=True: the port trains on NVIDIA GPUs (one per "
            "worker, device=None) or on the CPU (device='cpu'); it "
            "has no TPU")
    resources = dict(resources_per_worker or {})
    if resources.pop("TPU", None):
        raise ValueError("resources_per_worker={'TPU': ...}: the port "
                         "has no TPU; use {'GPU': 1}")
    num_cpus = resources.pop("CPU", num_cpus_per_worker)
    gpus = resources.pop("GPU", None)
    if gpus is not None and gpus != 1:
        raise ValueError(
            f"resources_per_worker={{'GPU': {gpus}}}: each worker owns "
            "exactly one card (one process per device)")
    spec = None if device is None else torch.device(device)
    if (use_gpu or gpus) and spec is not None and spec.type != "cuda":
        raise ValueError(
            f"use_gpu / resources_per_worker={{'GPU': 1}} ask for card "
            f"workers, but device={device!r}")
    return num_cpus, spec is None or spec.type == "cuda", resources, spec


class Strategy:
    strategy_name = "base"
    # batch statistics over the global batch (the SPMD strategies), not
    # each rank's rows (bind_batch_stats)
    global_batch_stats = True

    def __init__(self,
                 num_workers: int = 1,
                 num_cpus_per_worker: int = 1,
                 use_gpu: bool = False,
                 use_tpu: Optional[bool] = None,
                 init_hook: Optional[Callable] = None,
                 resources_per_worker: Optional[Dict] = None,
                 worker_runtime_env: Optional[Dict] = None,
                 use_ray: Optional[bool] = None,
                 allow_colocated_workers: bool = False,
                 gang: Optional[Any] = None,
                 standby: Optional[Any] = None,
                 device=None,
                 **kwargs: Any):
        """``resources_per_worker`` entries override the dedicated
        arguments (:func:`worker_resources`): ``CPU`` beats
        ``num_cpus_per_worker`` (also each worker's torch thread count
        under the subprocess backend), ``GPU`` (which must be 1) beats
        ``use_gpu``; the other entries are extra Ray resources.
        ``allow_colocated_workers`` is accepted and has no effect: a card
        has one owner however workers share nodes. See the module
        docstring for ``device``."""
        # GangConfig (reliability.gang): worker heartbeats and the
        # driver's watchdog on the RayLauncher; None = disarmed
        self.gang = gang
        # StandbyPool (reliability.elastic): warm workers promoted into
        # rank slots on a restart; caller-owned
        self.standby = standby
        self.num_workers = int(num_workers)
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        (self.num_cpus_per_worker, self.use_gpu,
         self.additional_resources_per_worker, self._device_spec) = \
            worker_resources(num_cpus_per_worker, use_gpu, use_tpu,
                             resources_per_worker, device)
        self.num_gpus_per_worker = 1 if self.use_gpu else 0
        self.worker_runtime_env = dict(worker_runtime_env or {})
        self.init_hook = init_hook
        self.use_ray = use_ray
        self.allow_colocated_workers = allow_colocated_workers
        self.extra_kwargs = kwargs
        self.device: Optional[torch.device] = None
        if self.num_workers == 1 and not use_ray:
            # the local launcher trains in this process
            self.device = resolve_device(device)
        # rank model
        self._global_rank = 0
        self._local_rank = 0
        self._node_rank = 0
        self._is_remote = False
        self._device_index: Optional[int] = None
        self.global_to_local: Optional[list] = None
        # the process group (set up by worker_setup); the launcher of an
        # armed gang shortens the rendezvous' and collectives' timeout
        self.collective_timeout_s: float = PROCESS_GROUP_TIMEOUT_S
        self._in_world = False
        self._owns_group = False
        self._ckpt_group = None

    # ------------------------------------------------------------------ #
    # launcher and worker set-up
    # ------------------------------------------------------------------ #
    def configure_launcher(self):
        """The launcher for this spec (see the module docstring)."""
        from ray_lightning_tpu_torch.launchers import ray_launcher as rl
        ray = None if self.use_ray is False else rl._import_ray()
        if ray is not None and ray.is_initialized():
            return rl.RayLauncher(self, ray_module=ray, gang=self.gang,
                                  standby=self.standby)
        if self.use_ray is True:
            raise RuntimeError(
                "use_ray=True but no Ray runtime is attached: install ray "
                "and call ray.init() (or connect via ray.init('ray://...')) "
                "before fit, or drop use_ray to train without Ray.")
        if self.num_workers == 1:
            return LocalLauncher(self)
        from ray_lightning_tpu_torch.launchers.process_backend import \
            ProcessRay
        return rl.RayLauncher(self, ray_module=ProcessRay(
            num_threads=int(self.num_cpus_per_worker)), gang=self.gang,
            standby=self.standby)

    def worker_setup(self, process_idx: int,
                     num_processes: Optional[int] = None,
                     coordinator_address: Optional[str] = None) -> None:
        """This worker's ranks, device and process group.

        The seat of the reference's ``_worker_setup`` (``ray_ddp.py:
        171-213``): ``init_process_group(backend, init_method="env://")``
        against the ``host:port`` the launcher probed on worker 0 (NCCL on
        the card, gloo on the CPU), then a check that the group's rank is
        the one the launcher assigned. Called without arguments (a worker
        joining by hand), it falls back to the ``MASTER_ADDR`` /
        ``MASTER_PORT`` / ``WORLD_SIZE`` the launcher broadcasts; without
        a coordinator it forms no group.
        """
        if coordinator_address is None and num_processes is None:
            addr = os.environ.get("MASTER_ADDR")
            port = os.environ.get("MASTER_PORT")
            if addr and port:
                coordinator_address = f"{addr}:{port}"
            num_processes = int(os.environ.get("WORLD_SIZE", "1"))
        num_processes = 1 if num_processes is None else int(num_processes)
        self.set_world_ranks(process_idx)
        self.device = self._worker_device()
        if coordinator_address is None:
            return
        host, port = coordinator_address.rsplit(":", 1)
        os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] = host, port
        if not dist.is_initialized():
            backend = ("cpu:gloo,cuda:nccl" if self.device.type == "cuda"
                       else "gloo")
            dist.init_process_group(
                backend, init_method="env://", world_size=num_processes,
                rank=process_idx,
                timeout=datetime.timedelta(
                    seconds=self.collective_timeout_s))
            self._owns_group = True
        if dist.get_rank() != process_idx or \
                dist.get_world_size() != num_processes:
            raise RuntimeError(
                f"the launcher assigned rank {process_idx} of "
                f"{num_processes}, but the process group has rank "
                f"{dist.get_rank()} of {dist.get_world_size()}: batch "
                "shards would be misrouted")
        self._in_world = True

    def _worker_device(self) -> torch.device:
        """The worker's device: the CPU for ``device="cpu"``, else its
        card -- the launcher's index into the node's visible cards (or
        the local rank), or the explicit ``cuda:N``. Raises when the
        worker sees no card."""
        spec = self._device_spec
        if spec is not None and spec.type == "cpu":
            return torch.device("cpu")
        self.accelerator.on_train_start()    # raises without a card
        if spec is not None and spec.index is not None:
            index = spec.index
        elif self._device_index is not None:
            index = self._device_index
        else:
            index = self._local_rank
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"worker rank {self._global_rank} wants cuda:{index}, but "
                f"only {torch.cuda.device_count()} card(s) are visible "
                f"(CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        torch.cuda.set_device(index)
        return torch.device("cuda", index)

    def teardown(self) -> None:
        """Destroy the process group this strategy made."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False
        self._in_world = False
        self._ckpt_group = None

    # ------------------------------------------------------------------ #
    # rank model (the reference's ray_ddp.py:138-334)
    # ------------------------------------------------------------------ #
    def set_remote(self, remote: bool) -> None:
        self._is_remote = remote

    def set_global_to_local(self, global_to_local: list) -> None:
        """The driver-computed global -> (local, node) rank map."""
        self.global_to_local = global_to_local

    def set_device_index(self, index: Optional[int]) -> None:
        """This worker's ``cuda:`` index, from the launcher's union of the
        node's visible cards (None: use the local rank)."""
        self._device_index = index

    def set_world_ranks(self, process_idx: int = 0) -> None:
        self._global_rank = process_idx
        if self.global_to_local is not None and \
                process_idx < len(self.global_to_local):
            self._local_rank, self._node_rank = \
                self.global_to_local[process_idx]
        else:
            self._local_rank, self._node_rank = 0, process_idx

    def set_world_size(self, num_workers: int) -> None:
        """Adopt a world size chosen at restart time -- the elastic
        recovery seat (``GangSupervisor(elastic=True)``; the JAX
        package's ``Strategy.set_world_size``).

        The driver-computed rank map describes a world that no longer
        exists and is dropped (the next launch computes it at the new
        size); the next restore re-shards the newest checkpoint onto the
        new world (``core/checkpoint.py:reshard_state``). Resized to one
        worker without Ray, the strategy trains in-process again, on
        the device it was given."""
        n = int(num_workers)
        if n < 1:
            raise ValueError(f"world size must be >= 1, got {n}")
        if n == self.num_workers:
            return
        self.num_workers = n
        self.global_to_local = None
        self.set_world_ranks(min(self._global_rank, n - 1))
        if n == 1 and not self.use_ray and self.device is None:
            self.device = resolve_device(self._device_spec)

    @property
    def world_size(self) -> int:
        """Number of data-parallel ranks."""
        return self.num_workers

    @property
    def global_rank(self) -> int:
        return self._global_rank

    @property
    def local_rank(self) -> int:
        return self._local_rank

    @property
    def node_rank(self) -> int:
        return self._node_rank

    @property
    def is_remote(self) -> bool:
        return self._is_remote

    @property
    def in_world(self) -> bool:
        """True inside a worker whose process group is up."""
        return self._in_world

    @property
    def root_device(self) -> torch.device:
        if self.device is None:
            raise RuntimeError(
                f"{type(self).__name__}(num_workers={self.num_workers}) "
                "finds its device in each worker (worker_setup), not on "
                "the driver")
        return self.device

    @property
    def accelerator_name(self) -> str:
        """``"_gpu"`` (the delayed check) for card workers, else
        ``"cpu"`` (the reference's ``ray_ddp.py:122-123``)."""
        return "_gpu" if self.use_gpu else "cpu"

    @property
    def accelerator(self):
        from ray_lightning_tpu_torch.accelerators import resolve_accelerator
        return resolve_accelerator(self.accelerator_name)

    @property
    def distributed_sampler_kwargs(self) -> Dict[str, int]:
        """How a rank-sharded loader would slice (``ray_ddp.py:325-334``);
        the trainer's own loaders yield global batches and
        :meth:`shard_batch` takes this rank's rows."""
        return dict(num_replicas=self.num_workers, rank=self.global_rank)

    # ------------------------------------------------------------------ #
    # collectives (no-ops outside a process group)
    # ------------------------------------------------------------------ #
    def barrier(self) -> None:
        if self._in_world:
            dist.barrier(group=self.checkpoint_group())

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """``obj`` from rank ``src`` on every rank (over gloo)."""
        if not self._in_world:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src,
                                   group=self.checkpoint_group())
        return box[0]

    def checkpoint_group(self):
        """A gloo group over the world, made on first use: checkpoint
        writes (``torch.distributed.checkpoint``, also from its async
        thread), barriers and object broadcasts run on it, apart from the
        step's collectives. None outside a process group."""
        if not self._in_world:
            return None
        if self._ckpt_group is None:
            self._ckpt_group = dist.new_group(backend="gloo")
        return self._ckpt_group

    def any_rank(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any rank."""
        if not self._in_world:
            return bool(flag)
        t = torch.tensor([1.0 if flag else 0.0], device=self.root_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def reduce_logs(self, logs: Dict[str, Any]) -> Dict[str, Any]:
        """Every floating tensor log averaged over ranks, in one
        collective (an f32 sum divided by the world size, each value back
        in its dtype); other values pass through."""
        if not self._in_world:
            return logs
        keys = [k for k, v in logs.items()
                if isinstance(v, torch.Tensor) and v.is_floating_point()]
        if not keys:
            return logs
        flat = torch.cat([logs[k].detach().float().reshape(-1).to(
            self.root_device) for k in keys])
        dist.all_reduce(flat)
        flat /= self.world_size
        out, offset = dict(logs), 0
        for k in keys:
            v = logs[k]
            out[k] = flat[offset:offset + v.numel()].reshape(v.shape).to(
                v.dtype)
            offset += v.numel()
        return out

    def shard_batch(self, batch: Any) -> Any:
        """This rank's rows ``[r·B/N, (r+1)·B/N)`` of every leaf of a
        global batch of B rows (what the JAX package's
        ``put_global_batch`` hands process r). Equal rows per rank are
        what makes the mean over ranks of each rank's mean loss the
        global batch's mean for batches of equal-length rows (the LM
        batches); leaves that disagree in rows, or B not divisible by N,
        raise."""
        n = self.world_size if self._in_world else 1
        if n == 1:
            return batch
        rows = {_shape(x)[0] for x in tree_leaves(batch) if _shape(x)}
        if len(rows) > 1:
            raise ValueError(
                f"batch leaves disagree in rows ({sorted(rows)}): a global "
                f"batch must split into {n} equal shards")
        if rows and next(iter(rows)) % n:
            raise ValueError(
                f"a global batch of {next(iter(rows))} rows does not split "
                f"into {n} equal shards (one per worker): make the batch "
                f"size a multiple of num_workers")
        r = self.global_rank

        def take(x):
            if not _shape(x):
                return x
            k = _shape(x)[0] // n
            return x[r * k:(r + 1) * k]

        return tree_map(take, batch)

    def gather_outputs(self, out: Any) -> Any:
        """Every tensor leaf of this rank's output concatenated with the
        other ranks' along dim 0, in rank order (predict's global
        batch); other leaves are this rank's."""
        if not self._in_world:
            return out

        def gather(t):
            if not isinstance(t, torch.Tensor) or t.ndim == 0:
                return t
            t = t.to(self.root_device).contiguous()
            parts = [torch.empty_like(t) for _ in range(self.world_size)]
            dist.all_gather(parts, t)
            return torch.cat(parts)

        return tree_map(gather, out)

    # ------------------------------------------------------------------ #
    # model, optimizer and state (overridden by the wrapping strategies)
    # ------------------------------------------------------------------ #
    def wrap_model(self, model: torch.nn.Module) -> torch.nn.Module:
        """The module the training step calls (a wrapper that averages
        gradients, or the model itself)."""
        return model

    def unwrap(self, model: torch.nn.Module) -> torch.nn.Module:
        """The user's module inside :meth:`wrap_model`'s wrapper."""
        return model

    def make_optimizer(self, factory: Callable, model: torch.nn.Module
                       ) -> torch.optim.Optimizer:
        return factory(model.parameters())

    def sync_gradients(self, params: List[torch.Tensor]) -> None:
        """Average the gradients over ranks after ``backward``, where no
        wrapper did it during backward."""

    def sync_buffers(self, buffers: List[torch.Tensor]) -> None:
        """Make the model's floating buffers agree over ranks after a
        step, where the step's statistics did not already (per-rank
        statistics)."""

    def bind_batch_stats(self, model: torch.nn.Module) -> None:
        """Tell every module that computes batch statistics (one with a
        ``sync_stats`` attribute: the port's ``BatchNorm`` and the MoE's
        router, ``models/moe.py:MoeMlp``) whether they are the global
        batch's: true inside a process group under a strategy with
        ``global_batch_stats``, where ``BatchNorm`` averages its
        per-channel means over ranks and ``MoeMlp`` routes its rows as
        their place in the global batch routes them, each with
        autograd-aware collectives, as the JAX strategies' one-program
        step computes them over the sharded batch."""
        synced = self.in_world and self.global_batch_stats
        for m in model.modules():
            if hasattr(m, "sync_stats"):
                m.sync_stats = synced

    def step_generator(self, generator: torch.Generator) -> torch.Generator:
        """The generator a step hands ``training_step``."""
        return generator

    def state_dict(self, state: TrainState, full: bool = True
                   ) -> Optional[Dict[str, Any]]:
        """The train state's checkpoint dict under the bare module's
        names, the one-process layout. Collective under a process group
        where the state is sharded; ``full=False`` may keep shards (the
        directory format writes them)."""
        return state.state_dict()

    def load_state_dict(self, state: TrainState,
                        sd: Dict[str, Any]) -> None:
        """Copy a checkpoint's ``state`` (one-process layout, full
        tensors) into the live, possibly wrapped or sharded, state."""
        state.load_state_dict(sd)

    # ------------------------------------------------------------------ #
    # steps
    # ------------------------------------------------------------------ #
    def make_train_step(self, loss_fn: Callable, *,
                        log_grad_norm: bool = False,
                        gradient_clip_val: Optional[float] = None,
                        accumulate_grad_batches: int = 1,
                        lr_schedule: Optional[Callable] = None,
                        guard_nonfinite: bool = False
                        ) -> Callable[[TrainState, Any],
                                      Tuple[TrainState, Dict[str, Any]]]:
        """The training step: ``state, logs = step(state, batch)``.

        ``loss_fn(model, batch, generator) -> (loss, logs)``. The step runs
        forward and loss, ``backward`` (gradients averaged over ranks by
        then: the wrapper's hooks or :meth:`sync_gradients`), logs the
        batch's global gradient norm (``log_grad_norm``), then follows
        optax's ``MultiSteps(chain(clip_by_global_norm, tx), k)``: the
        averaged gradients of k batches are averaged again (running mean,
        as optax's ``use_grad_mean``) and the optimizer steps on every
        k-th batch, after clipping the mean with optax's rule.
        ``lr_schedule(n)`` sets the learning rate of the n-th update.
        Returns ``{"loss": ..., **logs}`` as device tensors, floats
        averaged over ranks.

        The forward moves the model's buffers (BatchNorm's running
        statistics) on every batch, inside an accumulation too, as JAX's
        ``model_state`` moves on every mini-batch; :meth:`sync_buffers`
        then makes them agree over ranks.

        ``guard_nonfinite`` (the trainer's ``nonfinite_action`` seat)
        tests the loss and every gradient element (this rank's shard) for
        NaN/Inf, reduces the verdict over ranks into one host flag, and
        on a bad step leaves params, optimizer state, the accumulation
        and the floating buffers (copied before the forward) as they
        were on every rank (what the JAX step's device-side select
        keeps), reporting ``logs["nonfinite"] = 1.0`` as a host tensor.
        ``state.step`` still advances: the batch was attempted.
        """
        k = int(accumulate_grad_batches)
        if k < 1:
            raise ValueError(f"accumulate_grad_batches must be >= 1, got {k}")

        def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
            model, opt = state.model, state.optimizer
            params = [p for g in opt.param_groups for p in g["params"]]
            model.train()
            for p in params:
                p.grad = None
            buffers = [b for b in model.buffers() if b.is_floating_point()]
            kept = ([b.detach().clone() for b in buffers]
                    if guard_nonfinite else None)
            loss, logs = loss_fn(model, batch,
                                 self.step_generator(state.generator))
            loss.backward()
            self.sync_gradients(params)
            self.sync_buffers(buffers)
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if log_grad_norm:
                logs = {**logs, "grad_norm": global_norm(grads).detach()}
            state.step += 1
            logs = self.reduce_logs({"loss": loss.detach(), **logs})
            if guard_nonfinite:
                bad = self.any_rank(not bool(tree_all_finite(
                    [loss.detach(), [local_tensor(g) for g in grads]])))
                logs["nonfinite"] = torch.tensor(float(bad))
                if bad:
                    for p in params:
                        p.grad = None
                    with torch.no_grad():
                        for b, old in zip(buffers, kept):
                            b.copy_(old)
                    return state, logs
            if k > 1:
                if state.acc is None:
                    state.acc = [torch.zeros_like(g) for g in grads]
                with torch.no_grad():
                    for a, g in zip(state.acc, grads):
                        a.add_((g - a) / (state.mini_step + 1))
                grads = state.acc
            state.mini_step += 1
            if state.mini_step == k:
                if gradient_clip_val:
                    clip_by_global_norm_(grads, gradient_clip_val)
                for p, g in zip(params, grads):
                    p.grad = g
                if lr_schedule is not None:
                    for group in opt.param_groups:
                        group["lr"] = float(lr_schedule(state.updates))
                opt.step()
                state.updates += 1
                state.mini_step = 0
                state.acc = None
            for p in params:
                p.grad = None
            return state, logs

        return step

    def make_eval_step(self, eval_fn: Callable) -> Callable:
        """The evaluation step: ``logs = eval_step(state, batch,
        generator)``, without gradients, its float logs averaged over
        ranks."""

        def step(state: TrainState, batch, generator) -> Dict[str, Any]:
            model = self.unwrap(state.model)
            model.eval()
            with torch.no_grad():
                return self.reduce_logs(eval_fn(model, batch, generator))

        return step

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(num_workers={self.num_workers}, "
                f"device={self._device_spec})")
