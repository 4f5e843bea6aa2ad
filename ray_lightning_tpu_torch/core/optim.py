"""Optimizer factories (counterpart of ``ray_lightning_tpu/core/optim.py``).

:func:`make_optimizer` returns a factory -- a callable from parameters to
a ``torch.optim.Optimizer`` -- as the JAX version returns an optax
transform that exists before it sees the params. Three presets, by
memory profile:

- ``"adamw"`` -- ``torch.optim.AdamW`` with one parameter group, which is
  ``optax.adamw``: decay on every parameter (optax's mask is None, so
  biases and LayerNorm scales decay too), decoupled and scaled by the
  learning rate, bias correction on both moments, and ``eps`` added
  outside the square root (1e-8; ``eps_root`` 0). Full f32 state.
- ``"adamw_bf16m"`` (or any ``moment_dtype=`` on the adam branch) --
  :class:`AdamW` below, ``optax.adamw(mu_dtype=...)`` step for step: the
  first moment is kept in bf16 at rest, the update is formed from its
  f32 value before the rounding, exactly where optax rounds.
- ``"adafactor"`` (or ``factored=True``) -- :class:`Adafactor` below,
  the JAX preset's ``optax.adafactor``: factored second moment (for a
  param whose two largest dimensions are both >= 128; a full one
  otherwise), update clipping at block RMS 1.0, the learning rate, bf16
  momentum ``b1`` without debiasing, weight decay scaled by the learning
  rate, no parameter-scale multiply, and the ``1 - step**-0.8`` decay.
  ``torch.optim.Adafactor`` is a different algorithm and is not used.

Both hand-written optimizers keep optax's state tree -- its counts as
int32 scalars, Adafactor's one-element placeholders included -- so
:func:`opt_state_bytes` equals ``ray_lightning_tpu.core.optim
.opt_state_bytes`` for them. ``torch.optim.AdamW`` keeps a step count per
tensor where optax keeps one.

:func:`clip_by_global_norm_` is optax's ``clip_by_global_norm``: keep the
gradients when their global norm is below ``max_norm``, else scale them
by ``max_norm / norm``. (``torch.nn.utils.clip_grad_norm_`` differs: it
always scales, by ``max_norm / (norm + 1e-6)`` clamped at 1.)
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

OPTIMIZER_NAMES = ("adamw", "adamw_bf16m", "adafactor")


def _dtype(d: Optional[Union[str, torch.dtype]]) -> Optional[torch.dtype]:
    """``torch.bfloat16`` or its name (``"bfloat16"``), as optax takes
    ``jnp.bfloat16`` or ``"bfloat16"``."""
    if d is None or isinstance(d, torch.dtype):
        return d
    dtype = getattr(torch, str(d), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown moment_dtype {d!r}")
    return dtype


def make_optimizer(name: str = "adamw",
                   learning_rate: float = 3e-4,
                   *,
                   weight_decay: float = 0.0,
                   b1: float = 0.9,
                   b2: Optional[float] = None,
                   moment_dtype=None,
                   factored: Optional[bool] = None
                   ) -> Callable[[Iterable[torch.nn.Parameter]],
                                 torch.optim.Optimizer]:
    """An optimizer factory by name (see the module docstring).

    ``b2=None`` means the preset's default (0.999 on the adam branch). An
    explicit ``b2`` is ignored on the adafactor branch, with a warning:
    its second-moment decay is the step schedule ``1 - step**-0.8``.
    ``moment_dtype`` sets the first moment's dtype (adam branch) or the
    momentum's (adafactor branch, default bf16). A callable
    ``learning_rate`` raises ``NotImplementedError``: return ``(factory,
    schedule)`` from ``configure_optimizers`` instead, and the trainer
    sets each update's learning rate from the schedule."""
    if name not in OPTIMIZER_NAMES:
        raise ValueError(
            f"unknown optimizer {name!r}; expected one of "
            f"{OPTIMIZER_NAMES}")
    if callable(learning_rate):
        raise NotImplementedError(
            "a schedule as learning_rate is not taken by the factory: "
            "return (factory, schedule) from configure_optimizers, and the "
            "trainer sets each update's learning rate from the schedule")
    moment_dtype = _dtype(moment_dtype)
    if name == "adafactor" or factored:
        if b2 is not None:
            warnings.warn(
                f"b2={b2} is ignored by the factored (adafactor) branch: "
                "its second-moment decay is the built-in step schedule "
                "1 - step**-0.8, not an adam beta",
                stacklevel=2)
        return lambda params: Adafactor(
            params, lr=learning_rate, momentum=b1,
            momentum_dtype=moment_dtype or torch.bfloat16,
            factored=True if factored is None else factored,
            # optax.adafactor applies weight_decay_rate after the lr
            # scaling; scaled here so the same weight_decay means the
            # same per-step shrinkage as adamw (the JAX preset's rule)
            weight_decay_rate=(weight_decay * learning_rate)
            if weight_decay else None)
    betas = (b1, 0.999 if b2 is None else b2)
    if name == "adamw_bf16m" and moment_dtype is None:
        moment_dtype = torch.bfloat16
    if moment_dtype is None:
        return lambda params: torch.optim.AdamW(
            params, lr=learning_rate, betas=betas, eps=1e-8,
            weight_decay=weight_decay)
    return lambda params: AdamW(params, lr=learning_rate, betas=betas,
                                weight_decay=weight_decay,
                                moment_dtype=moment_dtype)


def _dtype_name(d) -> str:
    """A dtype as the name a param group keeps (``"bfloat16"``): plain
    strings load under ``torch.load(weights_only=True)``."""
    return str(_dtype(d)).replace("torch.", "")


def _f32(x) -> float:
    """``x`` rounded to f32, as a Python float (exact in a kernel's f32
    arithmetic)."""
    return float(np.float32(x))


class _OptaxLike(torch.optim.Optimizer):
    """What the two optax-math optimizers share: their counts live in
    ``self.state`` under string keys as int32 scalars (optax's count
    leaves), and their low-precision state keeps its dtype through
    ``load_state_dict``, which would otherwise cast every floating state
    tensor to its param's dtype."""

    _LOW_PRECISION: tuple = ()
    _COUNTS: tuple = ("count",)

    def _counts(self) -> int:
        """The update about to be taken, 1-based; advances every count."""
        n = 0
        for key in self._COUNTS:
            if key not in self.state:
                self.state[key] = torch.zeros((), dtype=torch.int32)
            n = int(self.state[key]) + 1
            self.state[key] = torch.tensor(n, dtype=torch.int32)
        return n

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            dtype = self._state_dtype(group)
            for p in group["params"]:
                st = self.state.get(p)
                for key in self._LOW_PRECISION:
                    if st and key in st:
                        st[key] = st[key].to(dtype)
        for key in self._COUNTS:
            if key in self.state:
                self.state[key] = self.state[key].to("cpu", torch.int32)

    @staticmethod
    def _state_dtype(group) -> torch.dtype:
        return _dtype(group["moment_dtype"])


class AdamW(_OptaxLike):
    """``optax.adamw(lr, b1, b2, eps=1e-8, mu_dtype=moment_dtype,
    weight_decay=...)``, one update at a time in optax's order and
    rounding points: ``mu = (1-b1)·g + b1·mu`` (the second product in
    ``moment_dtype``, as JAX computes a Python scalar times a bf16
    array), bias corrections in f32, ``mu_hat / (sqrt(nu_hat) + eps)``,
    plus ``weight_decay·p``, times ``-lr``, added to ``p``; ``mu`` is
    stored rounded to ``moment_dtype``."""

    _LOW_PRECISION = ("mu",)

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 moment_dtype=torch.bfloat16):
        super().__init__(params, dict(
            lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            moment_dtype=_dtype_name(moment_dtype)))

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        n = self._counts()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            bc1 = _f32(np.float32(1) - np.float32(b1) ** np.float32(n))
            bc2 = _f32(np.float32(1) - np.float32(b2) ** np.float32(n))
            mdtype = self._state_dtype(group)
            b1_m = torch.tensor(b1, dtype=mdtype)  # rounded as JAX does
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, dtype=mdtype)
                    st["nu"] = torch.zeros_like(p)
                mu = g * (1 - b1) + (st["mu"] * b1_m).to(g.dtype)
                nu = g * g * (1 - b2) + st["nu"] * b2
                u = (mu / bc1) / ((nu / bc2).sqrt() + group["eps"])
                u = u + p * group["weight_decay"]
                p.add_(u * -group["lr"])
                st["mu"] = mu.to(mdtype)
                st["nu"] = nu
        return loss


def _factored_dims(shape, factored: bool, min_dim: int = 128):
    """optax's ``_factored_dims``: the two largest axes, when the second
    largest has at least ``min_dim`` elements; else None."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_OptaxLike):
    """The JAX preset's ``optax.adafactor(learning_rate=lr,
    momentum=momentum, dtype_momentum=momentum_dtype, factored=factored,
    multiply_by_parameter_scale=False, clipping_threshold=1.0,
    weight_decay_rate=...)``, one update at a time in optax's order:
    factored (or full) RMS scaling with decay ``1 - n**-0.8``, clipping
    by block RMS, times ``lr``, momentum in ``momentum_dtype`` without
    debiasing, plus ``weight_decay_rate·p``, negated, added to ``p``."""

    _LOW_PRECISION = ("ema",)
    _COUNTS = ("count", "ema_count")   # scale_by_factored_rms's, ema's

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.9,
                 momentum_dtype=torch.bfloat16, factored: bool = True,
                 weight_decay_rate: Optional[float] = None,
                 clipping_threshold: float = 1.0, eps: float = 1e-30,
                 min_dim_size_to_factor: int = 128):
        super().__init__(params, dict(
            lr=lr, momentum=momentum, factored=bool(factored),
            moment_dtype=_dtype_name(momentum_dtype),
            weight_decay_rate=weight_decay_rate,
            clipping_threshold=clipping_threshold, eps=eps,
            min_dim_size_to_factor=min_dim_size_to_factor))

    def _init(self, p, group) -> Dict[str, torch.Tensor]:
        dims = _factored_dims(tuple(p.shape), group["factored"],
                              group["min_dim_size_to_factor"])
        one = torch.zeros(1, dtype=p.dtype, device=p.device)
        st = {"v_row": one, "v_col": one.clone(), "v": one.clone()}
        if dims is None:
            st["v"] = torch.zeros_like(p)
        else:
            d1, d0 = dims
            shape = list(p.shape)
            st["v_row"] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
            st["v_col"] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
        st["ema"] = torch.zeros_like(p, dtype=self._state_dtype(group))
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        n = self._counts()
        decay = _f32(np.float32(1) - np.float32(n) ** np.float32(-0.8))
        for group in self.param_groups:
            mdtype = self._state_dtype(group)
            b1 = group["momentum"]
            b1_m = torch.tensor(b1, dtype=mdtype)
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st.update(self._init(p, group))
                dims = _factored_dims(tuple(p.shape), group["factored"],
                                      group["min_dim_size_to_factor"])
                g2 = g * g + group["eps"]
                if dims is not None:
                    d1, d0 = dims
                    v_row = (st["v_row"] * decay
                             + g2.mean(dim=d0) * (1 - decay))
                    v_col = (st["v_col"] * decay
                             + g2.mean(dim=d1) * (1 - decay))
                    r1 = d1 - 1 if d1 > d0 else d1
                    row = (v_row / v_row.mean(dim=r1, keepdim=True)) \
                        .pow(-0.5)
                    u = (g * row.unsqueeze(d0)) * v_col.pow(-0.5) \
                        .unsqueeze(d1)
                    st["v_row"], st["v_col"] = v_row, v_col
                else:
                    v = st["v"] * decay + g2 * (1 - decay)
                    u = g * v.pow(-0.5)
                    st["v"] = v
                rms = u.square().mean().sqrt()
                u = u / torch.clamp(rms / group["clipping_threshold"],
                                    min=1.0)
                u = u * group["lr"]
                ema = u * (1 - b1) + (st["ema"] * b1_m).to(u.dtype)
                st["ema"] = ema.to(mdtype)
                u = ema
                if group["weight_decay_rate"] is not None:
                    u = u + p * group["weight_decay_rate"]
                p.add_(u * -1)
        return loss


def opt_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Total bytes of the optimizer state this process holds (the memory
    claims' measure, as the JAX package's ``opt_state_bytes``): under
    ZeRO its local optimizer's, under FSDP each tensor's local shard."""
    try:
        from torch.distributed.optim import ZeroRedundancyOptimizer
    except ImportError:  # a torch built without distributed support
        ZeroRedundancyOptimizer = ()
    if isinstance(optimizer, ZeroRedundancyOptimizer):
        optimizer = optimizer.optim
    total = 0
    for value in optimizer.state.values():
        for t in (value.values() if isinstance(value, dict) else [value]):
            if isinstance(t, torch.Tensor):
                t = local_tensor(t)
                total += t.numel() * t.element_size()
    return total


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
        return DTensor
    except ImportError:  # a torch built without distributed support
        return ()


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: writing it writes the DTensor);
    any other tensor itself."""
    return t.to_local() if isinstance(t, _dtensor_type()) else t


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, in f32 (optax's
    ``global_norm``); a device scalar. Sharded DTensors (FSDP's
    gradients) add their local shards' squares, summed over the mesh in
    one collective."""
    DTensor = _dtensor_type()
    if not any(isinstance(t, DTensor) for t in tensors):
        return torch.sqrt(sum(torch.sum(t.float() * t.float())
                              for t in tensors))
    plain, shards, mesh = [], [], None
    for t in tensors:
        if isinstance(t, DTensor) and all(p.is_shard() for p in t.placements):
            shards.append(t.to_local())
            mesh = t.device_mesh
        else:
            plain.append(t.full_tensor() if isinstance(t, DTensor) else t)
    part = sum(torch.sum(t.float() * t.float()) for t in shards)
    import torch.distributed as dist
    dist.all_reduce(part, group=mesh.get_group())
    return torch.sqrt(part + sum((torch.sum(t.float() * t.float())
                                  for t in plain), torch.zeros_like(part)))


@torch.no_grad()
def clip_by_global_norm_(tensors: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Clip ``tensors`` in place with optax's rule; returns the norm."""
    norm = global_norm(tensors)
    keep = norm < max_norm
    for t in tensors:
        t = local_tensor(t)
        t.copy_(torch.where(keep, t, t / norm.to(t.dtype) * max_norm))
    return norm
