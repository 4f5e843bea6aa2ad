"""Dropout masks of the port: one function draws every keep mask.

The JAX package draws its masks with ``jax.random.bernoulli`` from keys
that flax splits per module (the attention weights in
``ops/attention.py``, the MLP output through ``nn.Dropout``). The port
cannot reproduce JAX's counter-based stream, so it owns its own: every
site calls :func:`dropout_keep` with a plain integer seed, derived by
:func:`site_seed` from the step's seed, the layer and the site. A model
with two stacks numbers their layers apart (the encoder-decoder's
decoder blocks follow its encoder's), so no two sites share a seed.

The mask comes from a ``torch.Generator`` made on the tensor's device
from that integer inside the call. Nothing is read from torch's global
generators, and nothing carries state between calls: the same integer
gives the same mask. That is what makes remat correct --
``torch.utils.checkpoint`` replays a block's forward in backward, and
the replay calls :func:`dropout_keep` with the same integers, so it
redraws the masks the forward drew (``preserve_rng_state`` restores only
the global generators, which no site uses).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["ATTENTION", "MLP", "CROSS", "site_seed", "dropout_keep",
           "apply_dropout"]

#: the dropout sites of a block, as the JAX package places them: the
#: attention weights after the softmax, the MLP output after ``down``,
#: and a decoder block's cross-attention weights (``models/seq2seq.py``)
ATTENTION, MLP, CROSS = 0, 1, 2


def site_seed(seed: int, layer: int, site: int) -> int:
    """A 63-bit seed for one site of one layer from the step's seed."""
    state = np.random.SeedSequence([int(seed), int(layer), int(site)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def dropout_keep(seed: int, shape: Sequence[int], rate: float,
                 device) -> torch.Tensor:
    """The keep mask (bool, ``shape``) of dropout at ``rate``: each element
    kept with probability ``1 - rate`` (``jax.random.bernoulli(key,
    1 - rate, shape)``), drawn from a generator seeded with ``seed`` on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(tuple(shape), generator=gen, device=device) < 1.0 - rate


def apply_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)`` in x's dtype (flax
    ``nn.Dropout``; the attention weights' rule in ``ops/attention.py``)."""
    keep = dropout_keep(seed, x.shape, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)
