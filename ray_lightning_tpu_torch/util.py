"""State streams (counterpart of ``ray_lightning_tpu/util.py``, the state stream only).

The reference's own form (``ray_lightning/util.py:73-92``, quoted in the
JAX ``util.py:45-62``) is ``torch.save`` into an ``io.BytesIO`` and
``torch.load`` back with ``map_location``. The port's one caller, the
trainer's stream checkpoint, writes the same stream straight to its
file, so a 1.5 GB state is never held twice in host memory. Loading
takes ``weights_only=True``: a stream holds tensors, containers and
plain Python values, never code.
"""
from __future__ import annotations

from typing import IO, Any, Optional, Union

import torch


def save_state_stream(state: Any, f: IO[bytes]) -> None:
    """Write a nest of tensors and plain values to a binary file."""
    torch.save(state, f)


def load_state_stream(f: IO[bytes],
                      map_location: Optional[Union[str, torch.device]] = None
                      ) -> Any:
    """Inverse of :func:`save_state_stream`; tensors land on
    ``map_location`` (default: where they were saved from)."""
    return torch.load(f, map_location=map_location, weights_only=True)
