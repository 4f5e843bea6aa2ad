from ray_lightning_tpu_torch.serve.adapters import (AdapterBankFull,
                                                    AdapterRegistry,
                                                    UnknownAdapter)
from ray_lightning_tpu_torch.serve.client import ServeClient
from ray_lightning_tpu_torch.serve.engine import (KVSlotPool, PendingDispatch,
                                                  ServeEngine)
from ray_lightning_tpu_torch.serve.journal import (Journal, JournalCorrupt,
                                                   JournalState,
                                                   read_journal)
from ray_lightning_tpu_torch.serve.pages import (PagePool, PrefixCache,
                                                 SlotPoolFull)
from ray_lightning_tpu_torch.serve.request import (Completion, DEFAULT_TENANT,
                                                   FINISH_EOS, FINISH_FAILED,
                                                   FINISH_LENGTH,
                                                   FINISH_REJECTED,
                                                   FINISH_TIMEOUT, Request)
from ray_lightning_tpu_torch.serve.scheduler import (FifoScheduler,
                                                     QueueFull,
                                                     SchedulerConfig)
from ray_lightning_tpu_torch.serve.spec import SpecDecoder
from ray_lightning_tpu_torch.serve.tenancy import (ClassQueueFull,
                                                   TenantClass,
                                                   TenantScheduler)

__all__ = ["ServeClient", "ServeEngine", "KVSlotPool", "PendingDispatch",
           "PagePool", "PrefixCache", "SlotPoolFull", "SpecDecoder",
           "Completion", "Request", "DEFAULT_TENANT", "FifoScheduler",
           "QueueFull", "SchedulerConfig", "AdapterBankFull",
           "AdapterRegistry", "UnknownAdapter", "ClassQueueFull",
           "TenantClass", "TenantScheduler", "Journal", "JournalCorrupt",
           "JournalState", "read_journal", "FINISH_EOS", "FINISH_FAILED",
           "FINISH_LENGTH", "FINISH_REJECTED", "FINISH_TIMEOUT"]
