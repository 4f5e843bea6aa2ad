from ray_lightning_tpu_torch.core.callbacks import (Callback,
                                                    EarlyStopping,
                                                    EMAWeightAveraging,
                                                    EpochStatsCallback,
                                                    LambdaCallback,
                                                    LearningRateMonitor,
                                                    ModelCheckpoint)
from ray_lightning_tpu_torch.core.loggers import (CSVLogger,
                                                  TorchProfilerCallback)
from ray_lightning_tpu_torch.core.module import TpuDataModule, TpuModule
from ray_lightning_tpu_torch.core.optim import (clip_by_global_norm_,
                                                global_norm, make_optimizer,
                                                opt_state_bytes)
from ray_lightning_tpu_torch.core.profiler import (PassThroughProfiler,
                                                   SimpleProfiler)
from ray_lightning_tpu_torch.core.seed import reset_seed, seed_everything
from ray_lightning_tpu_torch.core.train_state import TrainState
from ray_lightning_tpu_torch.core.trainer import Trainer

__all__ = ["Callback", "EarlyStopping", "EMAWeightAveraging",
           "EpochStatsCallback", "LambdaCallback", "LearningRateMonitor",
           "ModelCheckpoint", "CSVLogger", "TorchProfilerCallback",
           "TpuDataModule", "TpuModule", "clip_by_global_norm_",
           "global_norm", "make_optimizer", "opt_state_bytes",
           "PassThroughProfiler", "SimpleProfiler", "reset_seed",
           "seed_everything", "TrainState", "Trainer"]
