"""Accelerators and the delayed-CUDA shim (counterpart of ``ray_lightning_tpu/accelerators.py``).

The reference's ``_GPUAccelerator`` (``ray_lightning/accelerators/
delayed_gpu_accelerator.py:22-50``) exists so that a driver with no card
(a laptop, a CPU head node, a Ray client) can build a GPU trainer: the
card is asserted inside the worker, not at construction. Here
:class:`DelayedCUDAAccelerator` (``"_gpu"``) reports itself available on
the driver and checks for a card in :meth:`on_train_start`, which the
strategy calls in the worker (``Strategy.worker_setup``). Strategies pick
one by name as the reference does: ``"_gpu"`` for card workers, ``"cpu"``
for ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, Type

import torch


class Accelerator:
    name = "base"

    @staticmethod
    def is_available() -> bool:
        raise NotImplementedError

    def setup_environment(self, root_device=None) -> None:
        """Driver-side setup. Default: assert availability."""
        if not self.is_available():
            raise RuntimeError(
                f"{type(self).__name__}: no {self.name} device available")

    def on_train_start(self) -> None:
        """Worker-side gate, called once the worker's device is set up."""


class CPUAccelerator(Accelerator):
    name = "cpu"

    @staticmethod
    def is_available() -> bool:
        return True


class CUDAAccelerator(Accelerator):
    """Strict CUDA accelerator: a card must be visible now."""
    name = "gpu"

    @staticmethod
    def is_available() -> bool:
        return torch.cuda.is_available()


class DelayedCUDAAccelerator(CUDAAccelerator):
    """CUDA accelerator whose availability check waits for the worker:
    available on any driver, and :meth:`on_train_start` raises in a worker
    that finds no card -- it never falls back to the CPU."""
    name = "_gpu"

    @staticmethod
    def is_available() -> bool:
        return True

    def setup_environment(self, root_device=None) -> None:
        # deliberately no device touch on the driver
        return None

    def on_train_start(self) -> None:
        if not CUDAAccelerator.is_available():
            raise RuntimeError(
                "no CUDA device is visible in this worker process "
                "(CUDA_VISIBLE_DEVICES is empty or the node has no card); "
                "a card worker does not fall back to the CPU -- pass "
                "device='cpu' to train on CPU workers")


ACCELERATOR_REGISTRY: Dict[str, Type[Accelerator]] = {}


def register_accelerator(cls: Type[Accelerator]) -> None:
    ACCELERATOR_REGISTRY[cls.name] = cls


register_accelerator(CPUAccelerator)
register_accelerator(CUDAAccelerator)
register_accelerator(DelayedCUDAAccelerator)


def resolve_accelerator(name: str) -> Accelerator:
    if name not in ACCELERATOR_REGISTRY:
        raise KeyError(
            f"Unknown accelerator {name!r}; registered: "
            f"{sorted(ACCELERATOR_REGISTRY)}")
    return ACCELERATOR_REGISTRY[name]()
