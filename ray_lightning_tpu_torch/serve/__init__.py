from ray_lightning_tpu_torch.serve.client import ServeClient
from ray_lightning_tpu_torch.serve.engine import KVSlotPool, ServeEngine
from ray_lightning_tpu_torch.serve.pages import PagePool, SlotPoolFull
from ray_lightning_tpu_torch.serve.request import Completion, Request
from ray_lightning_tpu_torch.serve.scheduler import (FifoScheduler,
                                                     QueueFull,
                                                     SchedulerConfig)

__all__ = ["ServeClient", "ServeEngine", "KVSlotPool", "PagePool", "SlotPoolFull",
           "Completion", "Request", "FifoScheduler", "QueueFull",
           "SchedulerConfig"]
