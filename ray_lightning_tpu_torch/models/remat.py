"""Rematerialization of the port's blocks (JAX ``maybe_remat``, ``_remat_policy``).

``TransformerConfig(remat=True)`` runs each block's training forward
under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
autograd keeps the block's input and what the policy saves, and backward
replays the forward for the rest. The JAX package's five policies
(``ray_lightning_tpu/models/transformer.py:820-848``) map onto
``torch.utils.checkpoint.create_selective_checkpoint_contexts``, which
decides per ATen op whether its output is kept:

========================================== =================================
``remat_policy``                           kept (beside the block input)
========================================== =================================
``None``                                   nothing (plain checkpoint)
``"dots"``                                 every matmul output: ``mm``,
                                           ``addmm``, ``bmm``, ``baddbmm``
``"dots_with_no_batch_dims"``              the weight products only:
                                           ``mm``, ``addmm``
``"dots_with_no_batch_dims_save_attn"``    those, plus the ``attn_out`` seat
``"dots_with_no_batch_dims_save_attn_mlp"`` those, plus ``attn_out`` and
                                           ``mlp_act``
========================================== =================================

``Dense`` (``F.linear`` on a (B, T, d) input) reaches ATen as ``addmm``
or ``mm`` on the flattened rows; the einsums of ``dot_product_attention``
as ``bmm``. The flash kernels are launched through ``ctypes`` inside an
``autograd.Function`` and are not ATen ops, so no policy can keep their
output: every policy replays K2 in backward. The named seats are
therefore ops of their own: :func:`checkpoint_name` is JAX's
``checkpoint_name``, an identity that, inside a rematerialized block,
runs the custom op ``ray_lightning_tpu_torch::checkpoint_name`` (a copy)
that the ``save_attn`` policies keep by its name argument.

:func:`count_saved` measures what autograd keeps for backward: the
tensors packed outside checkpointed regions (through
``saved_tensors_hooks``), each region's tensor inputs, and the outputs its
policy keeps, counted once per storage and leaving parameters out.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["POLICIES", "SEATS", "checkpoint_name", "checkpoint_block",
           "count_saved", "SavedBytes"]

#: the named seats, where the JAX package puts its ``checkpoint_name``s
SEATS = ("attn_out", "mlp_act")


@torch.library.custom_op("ray_lightning_tpu_torch::checkpoint_name",
                         mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_named.register_fake
def _named_fake(x, name):
    return torch.empty_like(x)


def _named_backward(ctx, grad):
    return grad, None


_named.register_autograd(_named_backward)
_NAMED = torch.ops.ray_lightning_tpu_torch.checkpoint_name.default

_aten = torch.ops.aten
_WEIGHT_DOTS = frozenset({_aten.mm.default, _aten.addmm.default})
_DOTS = _WEIGHT_DOTS | {_aten.bmm.default, _aten.baddbmm.default}

#: policy name -> (ATen ops whose outputs are kept, seat names kept)
POLICIES: Dict[Optional[str], Tuple[frozenset, Tuple[str, ...]]] = {
    None: (frozenset(), ()),
    "dots": (_DOTS, ()),
    "dots_with_no_batch_dims": (_WEIGHT_DOTS, ()),
    "dots_with_no_batch_dims_save_attn": (_WEIGHT_DOTS, ("attn_out",)),
    "dots_with_no_batch_dims_save_attn_mlp": (_WEIGHT_DOTS, SEATS),
}


def checkpoint_name(x: torch.Tensor, name: str, seat: bool) -> torch.Tensor:
    """``x`` under the seat ``name``: the identity, or (``seat``: inside a
    rematerialized block) a copy through the named op a policy can
    keep."""
    return _named(x, name) if seat else x


class _Policy:
    """The selective-checkpoint policy of one ``remat_policy``."""

    def __init__(self, name: Optional[str]):
        self.ops, self.names = POLICIES[name]

    def saves(self, func, args) -> bool:
        return func in self.ops or (func is _NAMED and args[1] in self.names)

    def __call__(self, ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if self.saves(func, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)


class SavedBytes:
    """Bytes autograd keeps for backward, counted once per storage."""

    def __init__(self):
        self._storages: Dict[Tuple[str, int], int] = {}

    def add(self, t) -> None:
        if not isinstance(t, torch.Tensor) or (t.is_leaf and t.requires_grad):
            return                  # a parameter: not an activation
        s = t.untyped_storage()
        key = (str(t.device), s.data_ptr())
        self._storages[key] = max(self._storages.get(key, 0), s.nbytes())

    @property
    def bytes(self) -> int:
        return sum(self._storages.values())

    def _pack(self, t):
        self.add(t)
        return t


_counter: Optional[SavedBytes] = None


@contextlib.contextmanager
def count_saved():
    """Count what autograd keeps for backward from the forwards run
    inside: ``with count_saved() as c: loss = ...``, then ``c.bytes``."""
    global _counter
    counter, prev = SavedBytes(), _counter
    _counter = counter
    try:
        with torch.autograd.graph.saved_tensors_hooks(counter._pack,
                                                      lambda t: t):
            yield counter
    finally:
        _counter = prev


class _CountKept(TorchDispatchMode):
    """Below the caching mode of a selective checkpoint: counts the
    outputs its policy keeps."""

    def __init__(self, policy: _Policy, counter: SavedBytes):
        super().__init__()
        self.policy, self.counter = policy, counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.policy.saves(func, args):
            for t in tree_leaves(out):
                self.counter.add(t)
        return out


def _contexts(policy: _Policy):
    forward, recompute = create_selective_checkpoint_contexts(policy)
    counter = _counter
    if counter is None:
        return forward, recompute

    @contextlib.contextmanager
    def counted():
        with _CountKept(policy, counter), forward:
            yield

    return counted(), recompute


def checkpoint_block(fn, x: torch.Tensor, *args, policy: Optional[str]):
    """``fn(x, *args)`` rematerialized under ``policy``: its masks come
    from integer seeds among ``args``, so no generator state is saved or
    restored (``preserve_rng_state=False``). Every tensor input is kept
    for the replay (a decoder block's memory and mask beside ``x``)."""
    if _counter is not None:
        for t in (x, *args):
            _counter.add(t)
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(_contexts, _Policy(policy))
    return checkpoint(fn, x, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)
