from ray_lightning_tpu_torch.ops.attention import (causal_mask,
                                                  dot_product_attention)
from ray_lightning_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["causal_mask", "dot_product_attention", "flash_attention"]
