"""ray_lightning_tpu_torch: the PyTorch/CUDA port of ray_lightning_tpu.

The JAX package (``ray_lightning_tpu/``) is the reference; this package
grows beside it, slice by slice, until it does everything the JAX package
does. Slice 1 is page-native continuous-batching serving of GPT-style
LMs: ``ServeClient`` -> ``submit`` -> ``run_until_idle``, with the decode
read side in a hand-written CUDA paged-attention kernel
(``csrc/paged_attention.cu``). Slice 2 is training on one device:
``Trainer(strategy=RayStrategy(num_workers=1)).fit(GPTModule(...))``,
with ``attention_impl="flash"`` running hand-written CUDA flash-attention
kernels forward and backward (``csrc/flash_attention.cu``). Slice 3 is
weight-quantized serving (``csrc/quantized_matmul.cu``). Slice 7 finishes
the one-process Trainer: crash-safe checkpoints in two formats and
``resume="auto"``/``ckpt_path=``, ``ModelCheckpoint``, ``EarlyStopping``,
``EMAWeightAveraging``, ``LearningRateMonitor``, ``CSVLogger``, the
profilers, the non-finite guard, ``predict()`` and the memory-efficient
optimizer presets. Slice 8 is data parallelism with one process per
device: ``RayStrategy``, ``HorovodRayStrategy``, ``RayShardedStrategy``
and ``FSDPStrategy`` with ``num_workers > 1``, each worker a spawned
process (``launchers/process_backend.py``, or a Ray actor when a Ray
runtime is attached) in a ``torch.distributed`` process group -- NCCL
between cards, gloo between CPU workers. Slice 9 finishes it: Ray Tune
reporting (``tune.py``: ``TuneReportCallback``,
``TuneReportCheckpointCallback``, ``get_tune_resources``) through a
session queue that crosses to the worker processes, the command line
(``cli.py``: ``TpuLightningCLI``, ``python -m
ray_lightning_tpu_torch.cli``), ZeRO by the JAX package's split of the
optimizer state, and the memory presets under ZeRO and FSDP2. Slice 15
is serving reliability and observability: ``obs/`` (``Telemetry``),
``ServeClient(retry_policy=, journal=, telemetry=, clock_epoch=)``,
crash replay through every serving route, ``ServeSupervisor`` and
``ServeClient.restore``. Slice 16 is the training half: the Trainer's
``telemetry=``, ``FitSupervisor``, gang supervision, warm standbys and
the in-memory checkpoint tier. Slice 17 is the multiprocess loader
(``data/multiproc.py``: ``MultiprocessDataLoader`` over the native
shared-memory ring, ``DevicePrefetcher``) and the in-process replica
fleet (``serve/fleet.py``: ``ReplicaFleet`` with its router, failover,
standbys, autoscaler and containment; ``obs/tracing.py``). Slice 18 is
the process replica fleet (``serve/process_fleet.py``:
``ReplicaFleet(backend="process")``, one ``ServeReplicaWorker`` process
per replica from ``launchers/serve_worker.py``, with kill -9 and
sticky-CUDA-error failover and driver-death survival). Slice 20 is the
encoder family and MNIST: ``TransformerEncoder`` with segments and
padding masks, ``BertModule`` and ``ViTModule`` fine-tuning through the
Trainer (the flash kernels at their bidirectional shapes),
``LightningMNISTClassifier`` and the determinism check
(``testing/determinism.py``). Slice 21 is ResNet with BatchNorm state
(``models/resnet.py``: ``ResNetModule`` at depths 10, 18 and 50): a
module's buffers are its state through every strategy and checkpoint
tier, with ``XORModel`` and ``count_params``. Slice 22 is the
Mixture-of-Experts LM (``models/moe.py``: ``MoeModule``,
``MoeTransformerLM``): top-k capacity routing with the JAX package's
drops, over the global batch under the SPMD strategies and each rank's
rows under ``HorovodRayStrategy``, and the Switch aux loss in the
training loss. Slice 23 is the encoder-decoder (``models/seq2seq.py``:
``Seq2SeqModule``, ``Seq2SeqTransformer``): cross-attention over a
padded source, the decoder's remat seats and dropout sites, and the
scanned encoder's weights through the converter.

Ground rules of the port:

- **The JAX package stays as it is.** No file of it is edited, moved or
  removed; it is the reference every module here is held against.
- **No JAX in the port.** This package imports ``torch`` and ``numpy``,
  never ``jax``, ``flax``, ``optax`` or anything under
  ``ray_lightning_tpu`` -- not even its framework-neutral modules
  (``serve/request.py`` and ``serve/scheduler.py`` are copied here).
  Only the parity tests (``tests/test_torch_*.py``) import both.
- **The card by default.** Entry points take ``device=None``, which
  means ``"cuda"``; without a CUDA device they raise ``RuntimeError``
  instead of quietly running on the CPU. CPU callers (the tests) pass
  ``device="cpu"``.
- **PyTorch idiom inside.** ``nn.Module``\\ s and plain functions on
  tensors, an explicit device, explicit seeds. Eager PyTorch; CUDA
  graphs are a later slice.
- **The JAX package's structure and names** at the module level, so
  every module has a findable counterpart: ``models/transformer.py``,
  ``models/generate.py``, ``serve/engine.py`` and so on.

Kernels are compiled from ``csrc/`` with ``nvcc`` at first use into
``_build/`` (listed in ``.gitignore``); see :mod:`._build`.
"""
from ray_lightning_tpu_torch.core import (Callback, CSVLogger,
                                          EarlyStopping, EMAWeightAveraging,
                                          LearningRateMonitor,
                                          ModelCheckpoint, SimpleProfiler,
                                          TpuDataModule, TpuModule, Trainer,
                                          make_optimizer)
from ray_lightning_tpu_torch.data import (DevicePrefetcher,
                                          MultiprocessDataLoader,
                                          synthetic_images, synthetic_mnist)
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.interop import (load_flax_params,
                                             load_flax_quantized)
from ray_lightning_tpu_torch.models import (BertClassifier, BertModule,
                                            BoringModel, GPTModule,
                                            LightningMNISTClassifier,
                                            MNISTClassifier, MNISTNet,
                                            MoeConfig, MoeModule,
                                            MoeTransformerLM,
                                            ResNetModule, Seq2SeqModule,
                                            Seq2SeqTransformer,
                                            TransformerConfig,
                                            TransformerEncoder, TransformerLM,
                                            ViTClassifier, ViTModule,
                                            XORDataModule, XORModel,
                                            bert_config, count_params,
                                            expert_parallel_rule,
                                            gpt2_config, moe_config,
                                            resnet10, resnet18, resnet50,
                                            vit_config)
from ray_lightning_tpu_torch.obs import StepStatsCallback, Telemetry
from ray_lightning_tpu_torch.reliability import (FaultPlan, FitSupervisor,
                                                 GangConfig, GangSupervisor,
                                                 NonFiniteError,
                                                 RetriesExhausted,
                                                 RetryPolicy,
                                                 ServeSupervisor)
from ray_lightning_tpu_torch.serve import (FleetConfig, ReplicaFleet,
                                           RouterConfig, ServeClient,
                                           ServeEngine)
from ray_lightning_tpu_torch.testing import (assert_deterministic,
                                             fit_fingerprint)
from ray_lightning_tpu_torch.strategies import (FSDPStrategy,
                                                HorovodRayStrategy,
                                                RayShardedStrategy,
                                                RayStrategy)

__all__ = ["Callback", "CSVLogger", "EarlyStopping", "EMAWeightAveraging",
           "LearningRateMonitor", "ModelCheckpoint", "SimpleProfiler",
           "TpuDataModule", "TpuModule", "Trainer", "make_optimizer",
           "resolve_device", "load_flax_params", "load_flax_quantized",
           "BoringModel", "GPTModule", "TransformerConfig", "TransformerLM",
           "gpt2_config", "FaultPlan", "NonFiniteError", "RetriesExhausted",
           "RetryPolicy", "ServeSupervisor", "FitSupervisor", "GangConfig",
           "GangSupervisor", "StepStatsCallback", "Telemetry",
           "ServeClient", "ServeEngine", "ReplicaFleet", "FleetConfig",
           "RouterConfig", "MultiprocessDataLoader", "DevicePrefetcher",
           "RayStrategy", "HorovodRayStrategy", "RayShardedStrategy",
           "FSDPStrategy", "BertClassifier", "BertModule", "bert_config",
           "LightningMNISTClassifier", "MNISTClassifier", "MNISTNet",
           "TransformerEncoder", "ViTClassifier", "ViTModule", "vit_config",
           "synthetic_images", "synthetic_mnist", "assert_deterministic",
           "fit_fingerprint", "ResNetModule", "resnet10", "resnet18",
           "resnet50", "XORModel", "XORDataModule", "count_params",
           "MoeConfig", "MoeModule", "MoeTransformerLM", "moe_config",
           "expert_parallel_rule", "Seq2SeqModule", "Seq2SeqTransformer"]
