from ray_lightning_tpu_torch.models.bert import (BertClassifier, BertModule,
                                                 bert_config)
from ray_lightning_tpu_torch.models.boring import (BoringModel,
                                                   XORDataModule, XORModel)
from ray_lightning_tpu_torch.models.generate import (decode_step,
                                                    decode_step_paged,
                                                    generate,
                                                    generate_full_scan,
                                                    prefill, row_seed,
                                                    sample_logits,
                                                    sample_logits_rows,
                                                    verify_step,
                                                    verify_step_paged)
from ray_lightning_tpu_torch.models.lora import LoraConfig
from ray_lightning_tpu_torch.models.gpt import (GPT2_SIZES, GPTModule,
                                               count_params, gpt2_config)
from ray_lightning_tpu_torch.models.moe import (MoeConfig, MoeModule,
                                                MoeTransformerLM,
                                                expert_parallel_rule,
                                                moe_config)
from ray_lightning_tpu_torch.models.mnist import (LightningMNISTClassifier,
                                                  MNISTClassifier, MNISTNet)
from ray_lightning_tpu_torch.models.quant import (QTensor, dequantize_params,
                                                  is_quantized, param_bytes,
                                                  quantize_params)
from ray_lightning_tpu_torch.models.resnet import (BottleneckBlock, ResNet,
                                                   ResNetBlock, ResNetModule,
                                                   resnet10, resnet18,
                                                   resnet50)
from ray_lightning_tpu_torch.models.seq2seq import (Seq2SeqModule,
                                                    Seq2SeqTransformer)
from ray_lightning_tpu_torch.models.transformer import (DenseKV, PagedKV,
                                                        TransformerConfig,
                                                        TransformerEncoder,
                                                        TransformerLM,
                                                        latch_eos,
                                                        new_arena,
                                                        new_cache)
from ray_lightning_tpu_torch.models.vit import (ViTClassifier, ViTModule,
                                                vit_config)

__all__ = [
    "BoringModel",
    "decode_step", "decode_step_paged", "generate", "generate_full_scan",
    "prefill", "row_seed", "sample_logits", "sample_logits_rows",
    "verify_step", "verify_step_paged", "GPT2_SIZES",
    "GPTModule", "gpt2_config", "DenseKV", "PagedKV", "TransformerConfig",
    "TransformerLM", "latch_eos", "new_arena", "new_cache", "QTensor",
    "dequantize_params", "is_quantized", "param_bytes", "quantize_params",
    "LoraConfig", "BertClassifier", "BertModule", "bert_config",
    "LightningMNISTClassifier", "MNISTClassifier", "MNISTNet",
    "TransformerEncoder", "ViTClassifier", "ViTModule", "vit_config",
    "XORModel", "XORDataModule", "count_params", "ResNet", "ResNetBlock",
    "BottleneckBlock", "ResNetModule", "resnet10", "resnet18", "resnet50",
    "MoeConfig", "MoeModule", "MoeTransformerLM", "moe_config",
    "expert_parallel_rule", "Seq2SeqModule", "Seq2SeqTransformer",
]
