from ray_lightning_tpu_torch.data.loader import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.data.multiproc import (DevicePrefetcher,
                                                    MultiprocessDataLoader)
from ray_lightning_tpu_torch.data.synthetic import synthetic_tokens

__all__ = ["ArrayDataset", "DataLoader", "DevicePrefetcher",
           "MultiprocessDataLoader", "synthetic_tokens"]
