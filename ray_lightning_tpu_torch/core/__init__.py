from ray_lightning_tpu_torch.core.callbacks import (Callback,
                                                    EpochStatsCallback,
                                                    LambdaCallback)
from ray_lightning_tpu_torch.core.module import TpuDataModule, TpuModule
from ray_lightning_tpu_torch.core.optim import (clip_by_global_norm_,
                                                global_norm, make_optimizer)
from ray_lightning_tpu_torch.core.seed import reset_seed, seed_everything
from ray_lightning_tpu_torch.core.train_state import TrainState
from ray_lightning_tpu_torch.core.trainer import Trainer

__all__ = ["Callback", "EpochStatsCallback", "LambdaCallback",
           "TpuDataModule", "TpuModule", "clip_by_global_norm_",
           "global_norm", "make_optimizer", "reset_seed", "seed_everything",
           "TrainState", "Trainer"]
