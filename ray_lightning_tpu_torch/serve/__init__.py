from ray_lightning_tpu_torch.serve.adapters import (AdapterBankFull,
                                                    AdapterRegistry,
                                                    UnknownAdapter)
from ray_lightning_tpu_torch.serve.client import ServeClient
from ray_lightning_tpu_torch.serve.engine import (KVSlotPool, PendingDispatch,
                                                  ServeEngine)
from ray_lightning_tpu_torch.serve.pages import PagePool, SlotPoolFull
from ray_lightning_tpu_torch.serve.request import (Completion, DEFAULT_TENANT,
                                                   Request)
from ray_lightning_tpu_torch.serve.scheduler import (FifoScheduler,
                                                     QueueFull,
                                                     SchedulerConfig)
from ray_lightning_tpu_torch.serve.tenancy import (ClassQueueFull,
                                                   TenantClass,
                                                   TenantScheduler)

__all__ = ["ServeClient", "ServeEngine", "KVSlotPool", "PendingDispatch",
           "PagePool", "SlotPoolFull", "Completion", "Request",
           "DEFAULT_TENANT", "FifoScheduler", "QueueFull", "SchedulerConfig",
           "AdapterBankFull", "AdapterRegistry", "UnknownAdapter",
           "ClassQueueFull", "TenantClass", "TenantScheduler"]
