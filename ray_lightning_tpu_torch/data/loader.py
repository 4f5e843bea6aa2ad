"""Host-side data pipeline (counterpart of ``ray_lightning_tpu/data/loader.py``).

The same global-batch loader as the JAX package, with tuples, lists and
dicts of numpy arrays in place of ``jax.tree_util`` pytrees: one logical
batch per step, the same per-epoch shuffle (``default_rng(seed + epoch)``)
and ``drop_last=True`` by default. Batches stay numpy; the trainer moves
them to the device. :func:`fast_forward` skips the batches a mid-epoch
checkpoint had already trained on, so a resumed epoch draws exactly the
batches the uninterrupted run drew after them.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Iterator, List

import numpy as np


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tuple/list/dict nest, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf of a tuple/list/dict nest."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


class ArrayDataset:
    """A nest of same-leading-dim numpy arrays acting as a dataset."""

    def __init__(self, *arrays: Any):
        if len(arrays) == 1:
            self.tree = arrays[0]
        else:
            self.tree = tuple(arrays)
        leaves = tree_leaves(self.tree)
        if not leaves:
            raise ValueError("ArrayDataset needs at least one array")
        self._len = leaves[0].shape[0]
        for leaf in leaves:
            if leaf.shape[0] != self._len:
                raise ValueError("All arrays must share the leading dim")

    def __len__(self) -> int:
        return self._len

    def take(self, idx: np.ndarray) -> Any:
        return tree_map(lambda a: a[idx], self.tree)


class DataLoader:
    """Minimal global-batch loader over an :class:`ArrayDataset`.

    ``shuffle`` reshuffles each epoch with a per-epoch derived seed
    (deterministic given ``seed``). ``drop_last=True`` keeps every batch
    the same shape.
    """

    def __init__(self,
                 dataset: Any,
                 batch_size: int = 1,
                 shuffle: bool = False,
                 seed: int = 0,
                 drop_last: bool = True):
        if not isinstance(dataset, ArrayDataset):
            dataset = ArrayDataset(dataset)
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) / self.batch_size
        return math.floor(n) if self.drop_last else math.ceil(n)

    def __iter__(self) -> Iterator[Any]:
        """This epoch's batches; a finished pass advances the epoch."""
        return self.iter_from(0)

    def iter_from(self, start: int) -> Iterator[Any]:
        """This epoch's batches from the ``start``-th on (the earlier ones
        are not gathered); a finished pass advances the epoch."""
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        for s in range(start * self.batch_size, stop, self.batch_size):
            yield self.dataset.take(order[s:s + self.batch_size])
        self._epoch += 1


def fast_forward(loader: Any, skip: int) -> Any:
    """``loader``'s batches after its first ``skip`` (the resume
    fast-forward): a :class:`DataLoader` starts at batch ``skip`` of its
    epoch's order; any other iterable is advanced past them."""
    if skip <= 0:
        return loader
    if isinstance(loader, DataLoader):
        return loader.iter_from(skip)
    return itertools.islice(iter(loader), skip, None)
