"""Batched multi-LoRA: a resident adapter bank per projection (counterpart of ``ray_lightning_tpu/models/lora.py``).

S-LoRA / Punica-style serving: many fine-tunes share ONE base model,
one KV arena and one engine. Each targeted projection (a
:class:`~ray_lightning_tpu_torch.models.transformer.Dense`) keeps a
resident bank of ``num_adapters`` low-rank pairs, in the JAX package's
layout and the parameter dtype --

    ``lora_A`` (num_adapters, in_features, rank)
    ``lora_B`` (num_adapters, rank, out_features)

-- and every batch row gathers its OWN pair by a per-row ``adapter_ids``
(B,) and adds ``scale * (x @ A @ B)`` to the base projection. The bank's
shape is fixed, so adapter churn (hot load, unload, eviction,
:mod:`ray_lightning_tpu_torch.serve.adapters`) is a write into a slot,
and rows bound to different adapters batch in one dispatch.

The rules are the JAX package's:

- **The delta rides OUTSIDE the base matmul** (:func:`lora_delta`): the
  base projection runs as it always does -- the fused dequant-matmul
  kernel (K5) on quantized weights included -- and the low-rank delta
  is a separate f32 contraction in plain PyTorch, added after the base
  (bias included). The reference computes it outside any Pallas kernel
  too, so no kernel changes.
- **Row −1 is the null adapter**: its delta is masked to exactly 0.0,
  so a null row's output is the base projection, and an engine's
  unadapted rows give the tokens of an engine with no bank.
- ``adapter_ids=None`` (the training path) selects bank slot 0 for every
  row: a ``num_adapters=1`` model trains its one adapter as classic LoRA.

The bank helpers at the bottom work on a port model in place: zero-bank
grafting onto a loaded (possibly weight-quantized) model, per-slot
install / extract / zero, and exact byte accounting. Their **adapter
trees** are the JAX package's: nested dicts of ``{"lora_A": (in, r),
"lora_B": (r, out)}`` under the flax paths (``stack/block_<i>/attn/qkv``,
``.../mlp/up``, ...), so one published adapter loads into either
package. ``qkv``'s output axis is flattened in the flax order (3, H,
head_dim), which is also the port's row order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["LORA_TARGETS", "LoraConfig", "as_lora_config", "lora_delta",
           "install_lora_bank", "install_adapter", "extract_adapter",
           "zero_adapter", "adapter_bytes"]

#: projection names a LoRA config may target -- the four per-block
#: matmuls of the transformer family (attention qkv/out, MLP up/down)
LORA_TARGETS = ("qkv", "out", "up", "down")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Static LoRA arming for a :class:`TransformerConfig` (hashable).

    ``num_adapters`` is the RESIDENT bank size (serving: the
    ``max_resident_adapters`` ceiling; training: 1). ``alpha`` defaults
    to ``rank`` -- scale 1.0 -- and the classic ``alpha/rank`` scaling
    is available for adapters trained elsewhere.
    """
    rank: int
    num_adapters: int = 1
    targets: Tuple[str, ...] = LORA_TARGETS
    alpha: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "targets", tuple(self.targets))
        if self.rank < 1:
            raise ValueError(f"lora rank must be >= 1, got {self.rank}")
        if self.num_adapters < 1:
            raise ValueError(
                f"num_adapters must be >= 1, got {self.num_adapters}")
        if not self.targets:
            raise ValueError("lora targets must be a non-empty tuple")
        bad = [t for t in self.targets if t not in LORA_TARGETS]
        if bad:
            raise ValueError(
                f"unknown lora targets {bad}; known: {LORA_TARGETS}")
        if self.alpha is not None and self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")

    @property
    def scale(self) -> float:
        return (self.alpha if self.alpha is not None else
                float(self.rank)) / float(self.rank)


def as_lora_config(value) -> Optional[LoraConfig]:
    """The port's :class:`LoraConfig` for ``value``: None, a port config,
    or any object with the JAX ``LoraConfig``'s fields (``rank``,
    ``num_adapters``, ``targets``, ``alpha``), read by name so the JAX
    class is never imported."""
    if value is None or isinstance(value, LoraConfig):
        return value
    if not all(hasattr(value, f) for f in ("rank", "num_adapters",
                                           "targets", "alpha")):
        raise ValueError(
            f"lora must be a LoraConfig or None, got "
            f"{type(value).__name__}")
    return LoraConfig(rank=int(value.rank),
                      num_adapters=int(value.num_adapters),
                      targets=tuple(value.targets), alpha=value.alpha)


def lora_delta(x: torch.Tensor, base: torch.Tensor, lora_A: torch.Tensor,
               lora_B: torch.Tensor, adapter_ids: Optional[torch.Tensor],
               scale: float) -> torch.Tensor:
    """``base`` plus each row's low-rank delta (JAX ``_lora_delta``):
    row ``b`` gathers bank slot ``adapter_ids[b]`` (clamped into the
    bank; None = slot 0 for every row), contracts ``x`` through ``A``
    then ``B`` in f32, scales, masks rows whose id is −1 to exactly 0.0,
    and adds the result cast to ``base``'s dtype. ``x`` (B, ..., in),
    ``base`` (B, ..., out)."""
    B = x.shape[0]
    if adapter_ids is None:
        ids = torch.zeros((B,), dtype=torch.long, device=x.device)
    else:
        ids = adapter_ids.to(device=x.device, dtype=torch.long)
    g = ids.clamp(0, lora_A.shape[0] - 1)
    a_g = lora_A[g].float()                     # (B, in, r)
    b_g = lora_B[g].float()                     # (B, r, out)
    h = torch.einsum("b...d,bdr->b...r", x.float(), a_g)
    delta = torch.einsum("b...r,brn->b...n", h, b_g)
    delta = delta.reshape(base.shape) * scale
    mask = (ids >= 0).reshape((-1,) + (1,) * (base.dim() - 1))
    return base + torch.where(mask, delta, 0.0).to(base.dtype)


# ------------------------------------------------------- bank helpers
#
# A bank lives on each targeted Dense as the parameters ``lora_A`` and
# ``lora_B``. The engine arms a bank by GRAFTING zeros onto an already
# loaded (and possibly weight-quantized) model, so the base weights are
# bitwise the unadapted engine's.

def _targets(model, targets=LORA_TARGETS) -> Iterator[Tuple[Tuple[str, ...],
                                                            Any]]:
    """``(flax path, Dense)`` for every projection of ``model`` named in
    ``targets``, in layer order: ``stack.blocks.<i>.attn.qkv`` is the
    flax ``("stack", "block_<i>", "attn", "qkv")``."""
    from ray_lightning_tpu_torch.models.transformer import Dense
    for name, mod in model.named_modules():
        parts = name.split(".")
        if (isinstance(mod, Dense) and parts[-1] in targets
                and parts[:2] == ["stack", "blocks"]):
            yield ("stack", f"block_{parts[2]}") + tuple(parts[3:]), mod


def _banks(model):
    found = [(path, mod) for path, mod in _targets(model)
             if mod.lora_A is not None]
    if not found:
        raise ValueError("the model holds no lora banks -- build it with "
                         "cfg.lora set, or graft them with "
                         "install_lora_bank")
    return found


def install_lora_bank(model, lora: LoraConfig,
                      dtype: torch.dtype = torch.float32):
    """Graft ZERO adapter banks (``lora.num_adapters`` slots of rank
    ``lora.rank``, in ``dtype``) onto every projection of ``model``
    ``lora.targets`` names, in place, replacing any bank it held, and
    record ``lora`` in ``model.cfg``. Shapes come from each projection's
    features, so grafting composes with weight quantization in either
    order. Returns the model."""
    lora = as_lora_config(lora)
    found = list(_targets(model, lora.targets))
    if not found:
        raise ValueError(
            f"install_lora_bank found no projection named any of "
            f"{lora.targets} -- wrong model or targets?")
    for _, mod in found:
        mod.arm_lora(lora, dtype)
    model.cfg = dataclasses.replace(model.cfg, lora=lora)
    return model


def extract_adapter(model, index: int = 0) -> Dict[str, Any]:
    """Slice bank slot ``index`` out of every bank of ``model`` into an
    adapter tree (nested dicts under the flax paths holding ``lora_A``
    (in, r) / ``lora_B`` (r, out) tensors, copies on the bank's device):
    the publishable single-adapter artifact -- train a ``num_adapters=1``
    model, extract slot 0, hot-load it by name."""
    out: Dict[str, Any] = {}
    for path, mod in _banks(model):
        n = mod.lora_A.shape[0]
        if not 0 <= index < n:
            raise ValueError(
                f"adapter index {index} out of range for bank of {n} at "
                f"{'/'.join(path)}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = {"lora_A": mod.lora_A[index].detach().clone(),
                          "lora_B": mod.lora_B[index].detach().clone()}
    return out


def _adapter_entries(adapter, path=()):
    if not isinstance(adapter, dict):
        return
    if "lora_A" in adapter and "lora_B" in adapter:
        yield path, adapter
        return
    for key, val in adapter.items():
        yield from _adapter_entries(val, path + (key,))


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def install_adapter(model, adapter, index: int):
    """Write ``adapter`` (an adapter tree: from :func:`extract_adapter`,
    from the JAX package's ``extract_adapter``, or anything whose leaves
    ``np.array`` reads) into bank slot ``index`` of every bank of
    ``model``, in place. Structure and shapes are checked first, and a
    mismatch names its path; nothing is written unless everything
    fits. Returns the model."""
    entries = {path: pair for path, pair in _adapter_entries(adapter)}
    if not entries:
        raise ValueError("adapter tree holds no lora_A/lora_B pairs")
    writes = []
    for path, mod in _banks(model):
        n, d_in, r = mod.lora_A.shape
        where = "/".join(path)
        if not 0 <= index < n:
            raise ValueError(
                f"adapter index {index} out of range for bank of {n} at "
                f"{where}")
        pair = entries.get(path)
        if pair is None:
            raise ValueError(
                f"adapter tree is missing an entry for bank at {where}")
        a, b = _as_tensor(pair["lora_A"]), _as_tensor(pair["lora_B"])
        want_a, want_b = (d_in, r), (r, mod.lora_B.shape[2])
        if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
            raise ValueError(
                f"adapter shape mismatch at {where}: got "
                f"A{tuple(a.shape)}/B{tuple(b.shape)}, bank wants "
                f"A{want_a}/B{want_b} (rank/dims must match the "
                f"engine's lora_rank and base model)")
        writes.append((path, mod, a, b))
    extra = set(entries) - {w[0] for w in writes}
    if extra:
        raise ValueError(
            "adapter tree has entries with no matching bank: "
            + ", ".join("/".join(p) for p in sorted(extra)))
    with torch.no_grad():
        for _, mod, a, b in writes:
            mod.lora_A[index].copy_(a.to(mod.lora_A.dtype))
            mod.lora_B[index].copy_(b.to(mod.lora_B.dtype))
    return model


def zero_adapter(model, index: int):
    """Zero bank slot ``index`` everywhere, in place: an unloaded slot is
    indistinguishable from the null adapter. Returns the model."""
    with torch.no_grad():
        for _, mod in _banks(model):
            mod.lora_A[index].zero_()
            mod.lora_B[index].zero_()
    return model


def adapter_bytes(model) -> int:
    """Exact bytes ONE resident adapter occupies across every bank of
    ``model`` (total bank bytes / num_adapters): the registry's
    accounting unit."""
    total, slots = 0, None
    for _, mod in _banks(model):
        slots = mod.lora_A.shape[0]
        total += sum(t.numel() * t.element_size()
                     for t in (mod.lora_A, mod.lora_B))
    return total // slots
