"""State streams and result plumbing (counterpart of ``ray_lightning_tpu/util.py``).

The reference's own form (``ray_lightning/util.py:73-92``, quoted in the
JAX ``util.py:45-62``) is ``torch.save`` into an ``io.BytesIO`` and
``torch.load`` back with ``map_location``: :func:`to_state_stream` and
:func:`load_state_stream`, which is how rank 0 hands the final train
state to the driver. The trainer's stream checkpoint writes the same
stream straight to its file (:func:`save_state_stream`), so a 1.5 GB
state is never held twice in host memory. Loading takes
``weights_only=True``: a stream holds tensors, containers and plain
Python values, never code.

Also the ``Unavailable`` sentinel for optional dependencies, the metric
conversions for the worker -> driver boundary, and
:func:`process_results`, the driver's wait on the workers' futures,
which runs what they put into the session queue.
"""
from __future__ import annotations

import io
from typing import IO, Any, Dict, List, Optional, Union

import numpy as np
import torch

#: seconds the driver waits on the workers' futures between checks
POLL_INTERVAL_S = 0.05


class Unavailable:
    """Sentinel for an optional dependency that is not installed: using
    it (instantiation or any attribute) raises."""

    def __init__(self, *args, **kwargs):
        raise RuntimeError(
            "This class is not usable because an optional dependency "
            "(e.g. `ray`) is not installed.")

    def __getattr__(self, name):
        raise RuntimeError(
            "This object is a placeholder for an unavailable optional "
            "dependency.")


def save_state_stream(state: Any, f: IO[bytes]) -> None:
    """Write a nest of tensors and plain values to a binary file."""
    torch.save(state, f)


def to_state_stream(state: Any) -> bytes:
    """A nest of tensors and plain values as bytes (``torch.save`` into
    an ``io.BytesIO``): the final state rank 0 returns to the driver,
    with no shared file system assumed."""
    buf = io.BytesIO()
    torch.save(state, buf)
    return buf.getvalue()


def load_state_stream(f: Union[bytes, bytearray, memoryview, IO[bytes]],
                      map_location: Optional[Union[str, torch.device]] = None
                      ) -> Any:
    """Inverse of :func:`to_state_stream` (bytes) and
    :func:`save_state_stream` (a binary file); tensors land on
    ``map_location`` (default: where they were saved from)."""
    if isinstance(f, (bytes, bytearray, memoryview)):
        f = io.BytesIO(f)
    return torch.load(f, map_location=map_location, weights_only=True)


def tensor_metrics_to_numpy(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Metric values for the worker -> driver boundary: a tensor leaves as
    a Python number (0-d) or a numpy array, never as a device tensor."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            arr = v.detach().cpu().numpy()
            out[k] = arr.item() if arr.ndim == 0 else arr
        elif isinstance(v, np.ndarray) and v.ndim == 0:
            out[k] = v.item()
        else:
            out[k] = v
    return out


def numpy_metrics_to_device(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Driver-side inverse of :func:`tensor_metrics_to_numpy`: metrics
    stay Python numbers on the driver, which may have no card."""
    return dict(metrics)


def process_results(futures: List[Any], ray_module: Any,
                    queue: Optional[Any] = None) -> List[Any]:
    """Wait on the workers' futures through ``ray_module``'s ``wait``
    and return their results in order (the reference's
    ``util.py:57-70``), running in this process what the workers put
    into the session ``queue`` between waits and once more after every
    future resolved, so an item put at a fit's end is not lost. A worker
    that fails raises here at once: its peers may be blocked in a
    collective with it and would never finish. An item that raises
    fails the wait with its error."""
    unfinished = list(futures)
    while unfinished:
        _drain_queue(queue)
        ready, unfinished = ray_module.wait(unfinished,
                                            timeout=POLL_INTERVAL_S)
        for ref in ready:
            ray_module.get(ref)
    _drain_queue(queue)
    return ray_module.get(futures)


def _drain_queue(queue: Optional[Any]) -> None:
    """Run every callable waiting in the session queue, in order (the
    reference's ``_handle_queue``, ``util.py:49-54``): items are
    ``(rank, item)``; anything but a callable is ignored."""
    if queue is None:
        return
    while not queue.empty():
        _rank, item = queue.get()
        if callable(item):
            item()
