"""Non-finite loss/gradient guard helpers (counterpart of ``ray_lightning_tpu/reliability/guard.py``).

The guard lives in two places: the strategy's step computes one device
flag from :func:`tree_all_finite` over the loss and every gradient and,
when it is set, leaves params and optimizer state untouched; the Trainer
reads the flag once per step and applies its ``nonfinite_action``
(``raise`` / ``skip_batch`` / ``restore_last_ckpt``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ray_lightning_tpu_torch.data.loader import tree_leaves, tree_map


class NonFiniteError(RuntimeError):
    """A training step produced a NaN/Inf loss or gradient and the
    trainer's ``nonfinite_action`` is ``"raise"`` (or recovery was
    impossible, e.g. ``restore_last_ckpt`` with no checkpoint yet)."""


def tree_all_finite(tree: Any) -> torch.Tensor:
    """A 0-d bool tensor on the leaves' device: every element of every
    floating tensor leaf is finite. Exact (per-element ``isfinite``, not
    a norm probe, which can overflow on large finite gradients)."""
    leaves = [t for t in tree_leaves(tree)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in leaves]).all()


def poison_nan(batch: Any) -> Any:
    """NaN-fill every float leaf of a host batch (``mode="nan"`` faults).

    Int-only batches (e.g. token ids) have nothing to poison -- that is a
    misconfigured fault plan, not a silent no-op."""
    found = []

    def _p(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                found.append(True)
                return torch.full_like(x, float("nan"))
            return x
        a = np.asarray(x)
        if np.issubdtype(a.dtype, np.floating):
            found.append(True)
            return np.full_like(a, np.nan)
        return x

    out = tree_map(_p, batch)
    if not found:
        raise ValueError(
            "nan fault injected but the batch has no float leaves to "
            "poison; use mode='raise' for integer-only pipelines")
    return out
