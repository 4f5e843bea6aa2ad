from ray_lightning_tpu_torch.strategies.base import Strategy
from ray_lightning_tpu_torch.strategies.ddp import (DataParallelStrategy,
                                                    RayStrategy)

__all__ = ["Strategy", "RayStrategy", "DataParallelStrategy"]
