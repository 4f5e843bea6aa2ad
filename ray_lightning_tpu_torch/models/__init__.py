from ray_lightning_tpu_torch.models.generate import (decode_step_paged,
                                                    row_seed,
                                                    sample_logits_rows)
from ray_lightning_tpu_torch.models.gpt import (GPT2_SIZES, GPTModule,
                                               gpt2_config)
from ray_lightning_tpu_torch.models.transformer import (DenseKV, PagedKV,
                                                        TransformerConfig,
                                                        TransformerLM,
                                                        latch_eos,
                                                        new_arena,
                                                        new_cache)

__all__ = [
    "decode_step_paged", "row_seed", "sample_logits_rows", "GPT2_SIZES",
    "GPTModule", "gpt2_config", "DenseKV", "PagedKV", "TransformerConfig",
    "TransformerLM", "latch_eos", "new_arena", "new_cache",
]
