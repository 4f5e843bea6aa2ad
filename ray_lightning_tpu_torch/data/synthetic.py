"""Synthetic token streams (copied from ``ray_lightning_tpu/data/synthetic.py``).

numpy only, as in the JAX package, so both frameworks train on the same
tokens. Only the LM stream is copied; the image generators come with the
models that use them.
"""
from __future__ import annotations

import numpy as np


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
