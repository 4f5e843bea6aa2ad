from ray_lightning_tpu_torch.launchers.local import LocalLauncher
from ray_lightning_tpu_torch.launchers.process_backend import ProcessRay
from ray_lightning_tpu_torch.launchers.ray_launcher import (ExecutorBase,
                                                            RayLauncher)
from ray_lightning_tpu_torch.launchers.utils import WorkerOutput

__all__ = ["LocalLauncher", "ProcessRay", "ExecutorBase", "RayLauncher",
           "WorkerOutput"]
