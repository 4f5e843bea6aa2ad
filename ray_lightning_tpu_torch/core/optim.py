"""Optimizer factories (counterpart of ``ray_lightning_tpu/core/optim.py``).

:func:`make_optimizer` returns a factory -- a callable from parameters to
a ``torch.optim.Optimizer`` -- as the JAX version returns an optax
transform that exists before it sees the params.

``"adamw"`` is ``torch.optim.AdamW`` with one parameter group, which is
``optax.adamw``: decay on every parameter (optax's mask is None, so
biases and LayerNorm scales decay too), decoupled and scaled by the
learning rate, bias correction on both moments, and ``eps`` added outside
the square root (1e-8; ``eps_root`` 0). ``tests/test_torch_train.py``
holds the two to 1e-6 over a fixed gradient sequence.

:func:`clip_by_global_norm_` is optax's ``clip_by_global_norm``: keep the
gradients when their global norm is below ``max_norm``, else scale them
by ``max_norm / norm``. (``torch.nn.utils.clip_grad_norm_`` differs: it
always scales, by ``max_norm / (norm + 1e-6)`` clamped at 1.)
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch

OPTIMIZER_NAMES = ("adamw", "adamw_bf16m", "adafactor")


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
    """An optimizer factory by name. ``b2=None`` means 0.999.

    Only ``"adamw"`` is ported: the memory presets ``"adamw_bf16m"`` and
    ``"adafactor"``, ``moment_dtype=`` and ``factored=`` raise
    ``NotImplementedError``, as does a callable ``learning_rate`` (return
    ``(factory, schedule)`` from ``configure_optimizers`` instead)."""
    if name not in OPTIMIZER_NAMES:
        raise ValueError(
            f"unknown optimizer {name!r}; expected one of "
            f"{OPTIMIZER_NAMES}")
    if name != "adamw" or moment_dtype is not None or factored:
        raise NotImplementedError(
            f"optimizer {name!r} (moment_dtype={moment_dtype}, "
            f"factored={factored}) is not ported yet: only full-precision "
            "'adamw' is (ROADMAP.md T2)")
    if callable(learning_rate):
        raise NotImplementedError(
            "a schedule as learning_rate is not taken by the factory: "
            "return (factory, schedule) from configure_optimizers, and the "
            "trainer sets each update's learning rate from the schedule")
    betas = (b1, 0.999 if b2 is None else b2)

    def factory(params) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=learning_rate, betas=betas,
                                 eps=1e-8, weight_decay=weight_decay)

    return factory


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, in f32 (optax's
    ``global_norm``); a device scalar."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(tensors: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Clip ``tensors`` in place with optax's rule; returns the norm."""
    norm = global_norm(tensors)
    keep = norm < max_norm
    for t in tensors:
        t.copy_(torch.where(keep, t, t / norm.to(t.dtype) * max_norm))
    return norm
