from ray_lightning_tpu_torch.launchers.local import LocalLauncher
from ray_lightning_tpu_torch.launchers.utils import WorkerOutput

__all__ = ["LocalLauncher", "WorkerOutput"]
