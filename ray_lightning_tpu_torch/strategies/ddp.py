"""The data-parallel strategy (counterpart of ``ray_lightning_tpu/strategies/ddp.py``).

``RayStrategy(num_workers=1)`` trains in this process on one device
(``device=None`` = the card). More workers raise ``NotImplementedError``
until the data-parallel item lands (``ROADMAP.md`` T6).
"""
from __future__ import annotations

from ray_lightning_tpu_torch.strategies.base import Strategy


class RayStrategy(Strategy):
    """Drop-in data-parallel strategy, one worker in this slice."""
    strategy_name = "ddp_ray"


# the name that says what it does
DataParallelStrategy = RayStrategy
