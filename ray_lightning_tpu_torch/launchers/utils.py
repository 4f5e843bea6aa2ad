"""Launcher-shared plumbing (copied from ``ray_lightning_tpu/launchers/utils.py``).

- :class:`WorkerOutput` -- the record rank 0 returns to the driver
  (the reference's ``_RayOutput``).
- :func:`find_free_port` -- probed on the worker that will host the
  rendezvous store (rank 0), not on the driver.
- :func:`get_node_ip` -- this host's address for the rendezvous.
- :func:`set_executable_cls` / :func:`get_executable_cls` -- the test
  seam for injecting fake executors.
- :func:`visible_gpu_ids` -- the cards this process may use, by
  ``CUDA_VISIBLE_DEVICES`` id: what the launcher hands out and unions.
"""
from __future__ import annotations

import os
import socket
from typing import Any, Dict, List, NamedTuple, Optional

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"


class WorkerOutput(NamedTuple):
    """What rank 0 returns to the driver after a launched stage: best
    checkpoint path, the final state as a byte stream (None in-process),
    trainer progress counters, and metrics as plain Python numbers."""
    best_model_path: Optional[str]
    state_stream: Optional[bytes]
    trainer_state: Dict[str, Any]
    callback_metrics: Dict[str, Any]
    logged_metrics: Dict[str, Any]
    results: Any = None
    callback_states: Optional[Dict[str, Any]] = None


#: probes :func:`find_free_port` makes before it gives up
PORT_PROBES = 8


def find_free_port() -> int:
    """A free TCP port for the rendezvous store, confirmed re-bindable.

    Each attempt asks the OS for a port, then binds it again on a second
    socket without ``SO_REUSEADDR`` (the bind the store will make) and
    retries the probe on any ``OSError``; exhaustion raises
    ``RuntimeError`` chaining the last bind error. Another process can
    still take the port between this probe and the store's bind: rank
    0's bind then fails at once with EADDRINUSE, and the launch fails
    (the driver kills the world) instead of hanging.
    """
    last: Optional[Exception] = None
    for _ in range(PORT_PROBES):
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("", 0))
                port = s.getsockname()[1]
            with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s2:
                s2.bind(("", port))
            return port
        except OSError as exc:
            last = exc
    raise RuntimeError(
        f"no bindable rendezvous port after {PORT_PROBES} probe "
        "attempt(s); the host's ephemeral range may be exhausted") from last


def get_node_ip() -> str:
    """This host's rendezvous address without Ray: every worker of the
    subprocess backend runs on this host, so the loopback address. (Under
    Ray the executor asks ``ray.util.get_node_ip_address()``.)"""
    return "127.0.0.1"


def visible_gpu_ids() -> List[Any]:
    """The cards this process may use, as ``CUDA_VISIBLE_DEVICES`` names
    them (ints where they are ints, else the strings, e.g. UUIDs): the
    variable's entries when it is set (none when it is empty), else every
    card torch counts. Counting does not initialise CUDA."""
    env = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
    if env is not None:
        ids = [s.strip() for s in env.split(",") if s.strip()]
        return [int(s) if s.isdigit() else s for s in ids]
    import torch
    return list(range(torch.cuda.device_count()))


_executable_cls: Optional[type] = None


def set_executable_cls(cls: Optional[type]) -> None:
    """Install a custom executor class (test seam)."""
    global _executable_cls
    _executable_cls = cls


def get_executable_cls() -> Optional[type]:
    return _executable_cls
