from ray_lightning_tpu_torch.strategies.allreduce import (AllReduceStrategy,
                                                          HorovodRayStrategy)
from ray_lightning_tpu_torch.strategies.base import Strategy
from ray_lightning_tpu_torch.strategies.ddp import (DataParallelStrategy,
                                                    RayStrategy)
from ray_lightning_tpu_torch.strategies.fsdp import FSDPStrategy
from ray_lightning_tpu_torch.strategies.sharded import (RayShardedStrategy,
                                                        ZeroOneStrategy)

__all__ = ["Strategy", "RayStrategy", "DataParallelStrategy",
           "HorovodRayStrategy", "AllReduceStrategy", "RayShardedStrategy",
           "ZeroOneStrategy", "FSDPStrategy"]
