"""Synthetic datasets (copied from ``ray_lightning_tpu/data/synthetic.py``).

numpy only, as in the JAX package, so both frameworks train on the same
batches: the learnable MNIST stand-in (the reference's quality gate,
accuracy >= 0.5 after 20 batches, holds on it), NHWC image blobs and the
LM's Markov token stream.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_mnist(num_samples: int = 4096,
                    num_classes: int = 10,
                    image_size: int = 28,
                    noise: float = 0.35,
                    seed: int = 0,
                    proto_seed: int = 1234) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional gaussian blobs rendered as flat 28×28 images.

    ``proto_seed`` fixes the class prototypes so train/val/test/predict
    splits (different ``seed``) sample the *same* underlying task.
    """
    rng = np.random.default_rng(seed)
    dim = image_size * image_size
    proto_rng = np.random.default_rng(proto_seed)
    prototypes = proto_rng.standard_normal(
        (num_classes, dim)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=num_samples)
    x = prototypes[labels] + noise * rng.standard_normal(
        (num_samples, dim)).astype(np.float32)
    return x.astype(np.float32), labels.astype(np.int32)


def synthetic_images(num_samples: int = 1024,
                     num_classes: int = 10,
                     image_size: int = 32,
                     channels: int = 3,
                     noise: float = 0.5,
                     seed: int = 0,
                     proto_seed: int = 1234) -> Tuple[np.ndarray, np.ndarray]:
    """NHWC image blobs (CIFAR-shaped by default)."""
    rng = np.random.default_rng(seed)
    shape = (image_size, image_size, channels)
    proto_rng = np.random.default_rng(proto_seed)
    prototypes = proto_rng.standard_normal(
        (num_classes,) + shape).astype(np.float32)
    labels = rng.integers(0, num_classes, size=num_samples)
    x = prototypes[labels] + noise * rng.standard_normal(
        (num_samples,) + shape).astype(np.float32)
    return x.astype(np.float32), labels.astype(np.int32)


def synthetic_tokens(num_samples: int = 512,
                     seq_len: int = 128,
                     vocab_size: int = 1024,
                     seed: int = 0,
                     table_seed: int = 1234) -> np.ndarray:
    """Markov-ish token streams for LM training (next-token predictable).

    ``table_seed`` fixes the transition table so different ``seed`` splits
    sample the same language.
    """
    rng = np.random.default_rng(seed)
    # a sparse deterministic transition table makes next-token learnable
    table = np.random.default_rng(table_seed).integers(
        0, vocab_size, size=vocab_size)
    toks = np.empty((num_samples, seq_len), dtype=np.int32)
    toks[:, 0] = rng.integers(0, vocab_size, size=num_samples)
    for t in range(1, seq_len):
        follow = table[toks[:, t - 1]]
        rand = rng.integers(0, vocab_size, size=num_samples)
        use_table = rng.random(num_samples) < 0.8
        toks[:, t] = np.where(use_table, follow, rand)
    return toks
