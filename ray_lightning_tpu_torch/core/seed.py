"""Deterministic-seed plumbing (copied from ``ray_lightning_tpu/core/seed.py``).

``seed_everything`` seeds Python's and numpy's generators and records the
seed in ``TPU_PL_GLOBAL_SEED`` for workers; ``reset_seed`` re-applies it
inside a worker. Model randomness does not flow through here: the trainer
hands explicit ``torch.Generator``\\ s, seeded from ``Trainer(seed=)``, to
the module (the counterpart of the JAX package's PRNG keys). torch's
global generator is never seeded or drawn from.
"""
from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

GLOBAL_SEED_ENV = "TPU_PL_GLOBAL_SEED"


def seed_everything(seed: Optional[int] = None) -> int:
    """Seed python/numpy RNGs and record the seed for worker forwarding."""
    if seed is None:
        env = os.environ.get(GLOBAL_SEED_ENV)
        seed = int(env) if env is not None else random.randint(0, 2**31 - 1)
    seed = int(seed)
    os.environ[GLOBAL_SEED_ENV] = str(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    return seed


def reset_seed() -> Optional[int]:
    """Re-apply the driver's seed inside a worker."""
    env = os.environ.get(GLOBAL_SEED_ENV)
    if env is None:
        return None
    return seed_everything(int(env))
