"""The split rule and the state layouts the sharded strategies share (the rule copied from ``ray_lightning_tpu/parallel/sharding.py``).

The JAX package shards every array of a ZeRO or FSDP state along its
largest dimension that the data-parallel size divides, and replicates an
array that no dimension splits (:func:`largest_divisible_dim`,
:func:`shard_dim`). ``RayShardedStrategy`` applies that rule to the
optimizer state here; FSDP2 shards its params along dimension 0, unevenly
where the world size does not divide it (``torch.chunk``'s split).

Both keep their sharded state as DTensors on the 1-D mesh of the group,
and both save and load through the same two functions:
:func:`full_state` all-gathers every DTensor of a state dict (the
one-process layout, loadable at any world size), and
:func:`load_sharded_state` lays a full state out as the live one before
the one-process load copies it in.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch


def largest_divisible_dim(shape: Tuple[int, ...], size: int) -> Optional[int]:
    """The largest dimension of ``shape`` that ``size`` divides (the
    first of equals), or None."""
    best, best_size = None, 0
    for i, d in enumerate(shape):
        if d % size == 0 and d >= size and d > best_size:
            best, best_size = i, d
    return best


def shard_dim(shape: Tuple[int, ...], size: int) -> Optional[int]:
    """The dimension the JAX rule splits an array of ``shape`` along over
    ``size`` ranks; None means replicated (one rank, a scalar, or no
    dimension that ``size`` divides)."""
    if size <= 1 or not shape:
        return None
    return largest_divisible_dim(tuple(shape), size)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def full_state(tree: Any) -> Any:
    """Every DTensor in a nest all-gathered into a plain tensor (a
    collective: every rank walks the same nest in the same order)."""
    if isinstance(tree, dict):
        return {k: full_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_state(v) for v in tree)
    return tree.full_tensor() if is_dtensor(tree) else tree


def shard_like(full: torch.Tensor, like) -> Any:
    """``full`` as a DTensor laid out as ``like`` (replicated, or sharded
    on one dimension of a 1-D mesh): this rank's part of ``torch.chunk``'s
    split, as DTensor shards are, cut from this rank's own copy without
    communication."""
    from torch.distributed.tensor import DTensor
    (placement,) = like.placements
    mesh = like.device_mesh
    full = full.to(like.device, like.dtype)
    if placement.is_replicate():
        local = full
    else:
        chunks = torch.chunk(full, mesh.size(), dim=placement.dim)
        rank = mesh.get_local_rank()
        local = chunks[rank] if rank < len(chunks) \
            else full.narrow(placement.dim, 0, 0)
    return DTensor.from_local(local.contiguous(), mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def load_sharded_state(state, sd: Dict[str, Any]) -> Dict[str, Any]:
    """A full (one-process layout) state dict laid out as the live,
    sharded one: every tensor shaped as the live param or optimizer
    param it belongs to keeps this rank's part (a DTensor where the live
    one is); the rest pass through (an optimizer lays out its own other
    state, e.g. adafactor's factored moments, in its ``load_state_dict``).
    ``state.optimizer.optim``, where it exists, is the optimizer that
    updates other tensors (ZeRO's inner one, on shards of the full
    params); the state's indices follow its parameter groups."""
    sd = full_state(sd)
    live = state.model.state_dict()
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    inner = getattr(state.optimizer, "optim", state.optimizer)
    opt_params = [p for g in inner.param_groups for p in g["params"]]

    def like(t, p):
        return shard_like(t, p) if is_dtensor(p) else t

    opt = sd["opt_state"]
    return {**sd,
            "params": {k: like(v, live[k]) if k in live else v
                       for k, v in sd["params"].items()},
            "opt_state": {**opt, "state": {
                i: {k: like(v, opt_params[i])
                    if isinstance(v, torch.Tensor)
                    and v.shape == opt_params[i].shape else v
                    for k, v in st.items()} if isinstance(i, int) else st
                for i, st in opt["state"].items()}},
            "acc": None if sd.get("acc") is None else [
                like(a, p) for a, p in zip(sd["acc"], params, strict=True)]}
