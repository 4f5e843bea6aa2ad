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

**The JAX model's leaves.** optax updates the leaves of the JAX param
tree, and the JAX LM stacks each block parameter of every layer into
one leaf (``nn.scan``); its fused qkv kernel is ``(L, d, 3, H, D)``
where the port holds twelve ``(3HD, d)`` weights. For Adafactor that
matters twice: whether a second moment is factored is decided on the
leaf's shape, and the update is clipped by the leaf's block RMS.
``make_optimizer(..., leaves=)`` takes the leaves over the params the
factory receives (:func:`~ray_lightning_tpu_torch.models.transformer
.jax_leaves`, which ``GPTModule`` passes) and makes one parameter group
per leaf, holding its shape (``"leaf_shape"``): the group's tensors are
factored as the leaf is and clipped by their joint RMS. Without
``leaves`` every tensor is a leaf of its own.

Both hand-written optimizers keep optax's state tree -- its counts as
int32 scalars, Adafactor's one-element placeholders (one set for each
leaf, on its first tensor; the others hold empty ones) included -- so
:func:`opt_state_bytes` equals ``ray_lightning_tpu.core.optim
.opt_state_bytes`` for them on the same leaves.
``torch.optim.AdamW`` keeps a step count per tensor where optax keeps
one. On params sharded over ranks (DTensors: FSDP2's, or ZeRO's shards
of the full params) both update this rank's local part; see
:class:`Adafactor` for its means.

:func:`clip_by_global_norm_` is optax's ``clip_by_global_norm``: keep the
gradients when their global norm is below ``max_norm``, else scale them
by ``max_norm / norm``. (``torch.nn.utils.clip_grad_norm_`` differs: it
always scales, by ``max_norm / (norm + 1e-6)`` clamped at 1.)
"""
from __future__ import annotations

import warnings
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple, Union)

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
                   factored: Optional[bool] = None,
                   leaves: Optional[Sequence[Tuple[Sequence[int],
                                                   Sequence[int]]]] = None
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
    sets each update's learning rate from the schedule.

    ``leaves``: ``(leaf shape, positions)`` pairs, the JAX model's param
    leaves over the params the factory will receive (see the module
    docstring). The factored branch makes a parameter group of each; the
    adam branch, whose update is element by element, keeps one group."""
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
            leaf_groups(params, leaves), lr=learning_rate, momentum=b1,
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


def leaf_groups(params: Iterable[torch.nn.Parameter],
                leaves: Optional[Sequence[Tuple[Sequence[int],
                                                Sequence[int]]]]):
    """``params`` as one parameter group per leaf of ``leaves``
    (``{"params": [...], "leaf_shape": shape}``); ``params`` themselves
    when ``leaves`` is None. Every param must be in exactly one leaf."""
    params = list(params)
    if leaves is None:
        return params
    positions = sorted(i for _shape, idx in leaves for i in idx)
    if positions != list(range(len(params))):
        raise ValueError(
            f"leaves must cover each of the {len(params)} params exactly "
            f"once, got positions {positions}")
    return [{"params": [params[i] for i in idx],
             "leaf_shape": tuple(int(n) for n in shape)}
            for shape, idx in leaves]


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
                g = local_tensor(p.grad)
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, dtype=mdtype)
                    st["nu"] = torch.zeros_like(p)
                mu = g * (1 - b1) + (local_tensor(st["mu"]) * b1_m).to(
                    g.dtype)
                nu = g * g * (1 - b2) + local_tensor(st["nu"]) * b2
                u = (mu / bc1) / ((nu / bc2).sqrt() + group["eps"])
                u = u + local_tensor(p) * group["weight_decay"]
                local_tensor(p).add_(u * -group["lr"])
                _put(st, "mu", mu.to(mdtype))
                _put(st, "nu", nu)
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
    debiasing, plus ``weight_decay_rate·p``, negated, added to ``p``.

    A parameter group with a ``"leaf_shape"`` holds the tensors of one
    leaf of the JAX param tree (:func:`leaf_groups`): whether their
    second moments are factored is optax's decision on that shape, and
    their update is clipped by its RMS over all of them. Where the leaf
    is factored each tensor is factored over its own two dimensions (a
    layer of a stacked matrix; the leaf must factor over the layer's
    dimensions, not the stacking one). A group without one makes each
    of its tensors a leaf of its own shape: the layout of
    ``Adafactor(params)`` and of ``make_optimizer`` without ``leaves``,
    kept as one group so that those callers' saved states still load.

    On a param sharded over ranks (a DTensor: FSDP2's, or ZeRO's shard
    of a full param) each rank updates its own part. Which dimensions
    are factored is decided on the full shape. The three means that
    span a sharded dimension -- the second moment's row or column mean,
    the row normalisation, and the update's RMS for the clipping -- sum
    the local parts over the group and divide by the full extent; the
    others stay local. A factored moment that lost the sharded dimension
    is whole on every rank after its mean; it is stored split by the JAX
    package's rule (:func:`~ray_lightning_tpu_torch.strategies.sharding
    .shard_dim`) and gathered again for the update."""

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
            min_dim_size_to_factor=min_dim_size_to_factor,
            leaf_shape=None))
        for group in self.param_groups:
            for p in group["params"]:
                self._dims(p, group)   # a leaf the port cannot factor raises

    @staticmethod
    def _dims(p, group):
        """The two dimensions of ``p`` its second moment is factored
        over (optax's ``(d1, d0)``), or None: optax's decision on the
        leaf's shape, ``p``'s own where the group names none."""
        shape = tuple(p.shape)
        leaf = group["leaf_shape"]
        leaf = shape if leaf is None else tuple(leaf)
        dims = _factored_dims(leaf, group["factored"],
                              group["min_dim_size_to_factor"])
        if dims is None or leaf == shape:
            return dims
        layers = int(np.prod(leaf)) // (leaf[dims[0]] * leaf[dims[1]])
        if p.dim() != 2 or sorted(shape) != sorted(
                (leaf[dims[0]], leaf[dims[1]])) \
                or layers != len(group["params"]):
            raise ValueError(
                f"a tensor of shape {shape} in a leaf of shape "
                f"{leaf} factored over its dimensions {dims}: the port "
                "factors a leaf's tensors as 2-D matrices, one a layer")
        return _factored_dims(shape, True, 0)

    def _init(self, p, group, first: bool) -> Dict[str, torch.Tensor]:
        """A tensor's zero state; the one-element placeholders of the
        unused moments sit on a leaf's ``first`` tensor (empty on the
        others), as optax keeps one per leaf."""
        dims = self._dims(p, group)
        one = torch.zeros(int(first), dtype=p.dtype, device=p.device)
        st = {"v_row": one, "v_col": one.clone(), "v": one.clone()}
        if dims is None:
            st["v"] = torch.zeros_like(p)
        else:
            d1, d0 = dims
            split = _split_of(p)
            st["v_row"] = _zero_moment(p, split, d0)
            st["v_col"] = _zero_moment(p, split, d1)
        st["ema"] = torch.zeros_like(p, dtype=self._state_dtype(group))
        return st

    @staticmethod
    def _layout(groups) -> List[Tuple[int, Optional[Tuple[int, ...]]]]:
        return [(len(g["params"]), None if g.get("leaf_shape") is None
                 else tuple(int(n) for n in g["leaf_shape"]))
                for g in groups]

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """As :class:`_OptaxLike`'s, for a state saved on the same
        leaves (else ``ValueError``: a state laid out per tensor does not
        load into a leaf-grouped optimizer, nor the other way); the
        factored moments of a sharded param, which a checkpoint holds
        whole, keep this rank's part."""
        saved = self._layout(state_dict["param_groups"])
        if saved != self._layout(self.param_groups):
            raise ValueError(
                "this adafactor state was saved on other parameter leaves "
                f"({len(saved)} groups: {saved[:3]}...) than this "
                f"optimizer's ({len(self.param_groups)} groups): an "
                "adafactor state saved before the port's adafactor "
                "followed the JAX model's leaves (it factored the fused "
                "qkv weight and clipped each layer alone) does not load "
                "into it; resume from a checkpoint of this layout or "
                "start the optimizer afresh")
        state_dict = {**state_dict, "param_groups": [
            {**g, "leaf_shape": g.get("leaf_shape")}
            for g in state_dict["param_groups"]]}
        super().load_state_dict(state_dict)
        from ray_lightning_tpu_torch.strategies.sharding import (is_dtensor,
                                                                 shard_like)
        for group in self.param_groups:
            for p in group["params"]:
                st, split, dims = self.state.get(p), _split_of(p), \
                    self._dims(p, group)
                if not st or split is None or dims is None:
                    continue
                d1, d0 = dims
                for key, reduced in (("v_row", d0), ("v_col", d1)):
                    like = _zero_moment(p, split, reduced)
                    if is_dtensor(like) and not is_dtensor(st[key]):
                        st[key] = shard_like(st[key], like)

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        n = self._counts()
        decay = _f32(np.float32(1) - np.float32(n) ** np.float32(-0.8))
        for group in self.param_groups:
            params = group["params"]
            leaves = ([params] if group["leaf_shape"] is not None
                      else [[p] for p in params])
            for leaf in leaves:
                scaled = []
                for i, p in enumerate(leaf):
                    if p.grad is None:
                        continue
                    st = self.state[p]
                    if not st:
                        st.update(self._init(p, group, i == 0))
                    scaled.append((p, st, self._scaled(p, st, group, decay)))
                if scaled:
                    rms = _block_rms([(p, u) for p, _st, u in scaled])
                    for p, st, u in scaled:
                        self._apply(p, st, u, rms, group)
        return loss

    def _scaled(self, p, st, group, decay: float) -> torch.Tensor:
        """The gradient scaled by the (factored) second moment, which is
        updated in ``st``: optax's ``scale_by_factored_rms``."""
        g = local_tensor(p.grad)
        split = _split_of(p)
        cut = None if split is None else split.dim
        dims = self._dims(p, group)
        g2 = g * g + group["eps"]
        if dims is None:
            v = local_tensor(st["v"]) * decay + g2 * (1 - decay)
            _put(st, "v", v)
            return g * v.pow(-0.5)
        d1, d0 = dims
        v_row = _moment(st, "v_row", _mean(g2, d0, cut, split, p.shape[d0]),
                        p, split, d0, decay)
        v_col = _moment(st, "v_col", _mean(g2, d1, cut, split, p.shape[d1]),
                        p, split, d1, decay)
        r1 = d1 - 1 if d1 > d0 else d1
        # v_row is this rank's slice along d1 only when the param is split
        # along d1
        row_cut = r1 if cut == d1 else None
        row = (v_row / _mean(v_row, r1, row_cut, split, p.shape[d1],
                             keepdim=True)).pow(-0.5)
        return (g * row.unsqueeze(d0)) * v_col.pow(-0.5).unsqueeze(d1)

    def _apply(self, p, st, u, rms, group) -> None:
        """Clip ``u`` by the block RMS ``rms``, scale by the learning
        rate, fold into the momentum, decay and step ``p``."""
        u = u / torch.clamp(rms / group["clipping_threshold"], min=1.0)
        u = u * group["lr"]
        mdtype = self._state_dtype(group)
        b1 = group["momentum"]
        b1_m = torch.tensor(b1, dtype=mdtype)
        ema = u * (1 - b1) + (local_tensor(st["ema"]) * b1_m).to(u.dtype)
        _put(st, "ema", ema.to(mdtype))
        u = ema
        if group["weight_decay_rate"] is not None:
            u = u + local_tensor(p) * group["weight_decay_rate"]
        local_tensor(p).add_(u * -1)


def _block_rms(items) -> torch.Tensor:
    """The RMS of the updates ``u`` of ``(param, u)`` pairs that form one
    leaf, over the full tensors: the local squares summed, added over
    the group where the params are split (one collective), divided by
    the full element count."""
    total = sum(u.square().sum() for _p, u in items)
    split = _split_of(items[0][0])
    if split is not None:
        split.all_reduce(total)
    return (total / sum(p.numel() for p, _u in items)).sqrt()


# ----------------------------------------------------------------------
# the presets on a shard: a param that is a DTensor sharded over ranks
# ----------------------------------------------------------------------
class _Split:
    """Where a sharded param's local tensor sits in the full one: split
    along ``dim`` over the ``world`` ranks of ``mesh`` (``torch.chunk``'s
    split: even under ZeRO, possibly uneven under FSDP2)."""

    def __init__(self, p):
        (placement,) = p.placements
        self.mesh = p.device_mesh
        self.world = self.mesh.size()
        self.rank = self.mesh.get_local_rank()
        self.dim = placement.dim

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        dist.all_reduce(t, group=self.mesh.get_group())
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's equal part ``t`` joined along ``dim``, in rank
        order."""
        import torch.distributed as dist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.mesh.get_group())
        return torch.cat(parts, dim=dim)


def _split_of(p) -> Optional[_Split]:
    """The split of a param sharded over more than one rank; None for a
    whole (plain, replicated, or one-rank) param."""
    if not isinstance(p, _dtensor_type()) or p.device_mesh.size() == 1:
        return None
    (placement,) = p.placements
    return _Split(p) if placement.is_shard() else None


def _put(st: Dict[str, Any], key: str, value: torch.Tensor) -> None:
    """Store a state tensor: into a DTensor's local part, in place, or
    as the new value."""
    if isinstance(st[key], _dtensor_type()):
        st[key].to_local().copy_(value)
    else:
        st[key] = value


def _mean(x: torch.Tensor, dim: int, cut: Optional[int],
          split: Optional[_Split], extent: int,
          keepdim: bool = False) -> torch.Tensor:
    """The full tensor's mean over ``dim``, of which ``x`` is this
    rank's part split along ``cut``: a local mean unless ``dim`` is
    ``cut``, then the local sums added over the group and divided by the
    full extent ``extent``."""
    if cut is None or dim != cut:
        return x.mean(dim=dim, keepdim=keepdim)
    total = split.all_reduce(x.sum(dim=dim, keepdim=keepdim))
    return total / extent


def _moment_layout(p, split: Optional[_Split], reduced: int):
    """How the factored moment that averages ``p`` over ``reduced`` is
    kept: ``None`` whole (an unsplit param); ``("slice", q)`` this
    rank's slice along its dimension ``q``, as the param is split (the
    mean was local); ``("rule", k)`` whole after its mean, stored split
    along ``k`` by the JAX rule (``k`` None: whole)."""
    if split is None:
        return None
    if reduced == split.dim:
        from ray_lightning_tpu_torch.strategies.sharding import shard_dim
        shape = tuple(p.shape)
        return ("rule", shard_dim(shape[:reduced] + shape[reduced + 1:],
                                  split.world))
    return ("slice", split.dim - (split.dim > reduced))


def _zero_moment(p, split: Optional[_Split], reduced: int):
    """A zero factored moment of ``p`` over ``reduced``, laid out by
    :func:`_moment_layout` (a DTensor where it is split)."""
    shape = list(p.shape)
    full = shape[:reduced] + shape[reduced + 1:]
    local_p = local_tensor(p)
    layout = _moment_layout(p, split, reduced)
    if layout is None or layout[1] is None:
        return local_p.new_zeros(full)
    kind, k = layout
    local = list(full)
    local[k] = (full[k] // split.world if kind == "rule"
                else local_p.shape[split.dim])
    from torch.distributed.tensor import DTensor, Shard
    return DTensor.from_local(
        local_p.new_zeros(local), split.mesh, [Shard(k)], run_check=False,
        shape=torch.Size(full),
        stride=torch.empty(full, device="meta").stride())


def _moment(st, key: str, mean: torch.Tensor, p, split: Optional[_Split],
            reduced: int, decay: float) -> torch.Tensor:
    """``decay·old + (1 - decay)·mean`` for a factored moment, stored in
    its layout; returns it as the update uses it (whole, or this rank's
    slice where the mean was local)."""
    layout = _moment_layout(p, split, reduced)
    if layout is None or layout[0] == "slice" or layout[1] is None:
        new = local_tensor(st[key]) * decay + mean * (1 - decay)
        _put(st, key, new)
        return new
    k = layout[1]
    n = mean.shape[k] // split.world
    part = (local_tensor(st[key]) * decay
            + mean.narrow(k, split.rank * n, n) * (1 - decay))
    _put(st, key, part)
    return split.all_gather(part, k)


def opt_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Total bytes of the optimizer state this process holds (the memory
    claims' measure, as the JAX package's ``opt_state_bytes``): under
    ZeRO and FSDP each tensor's local part."""
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
