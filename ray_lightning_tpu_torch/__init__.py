"""ray_lightning_tpu_torch: the PyTorch/CUDA port of ray_lightning_tpu.

The JAX package (``ray_lightning_tpu/``) is the reference; this package
grows beside it, slice by slice, until it does everything the JAX package
does. Slice 1 is page-native continuous-batching serving of GPT-style
LMs: ``ServeClient`` -> ``submit`` -> ``run_until_idle``, with the decode
read side in a hand-written CUDA paged-attention kernel
(``csrc/paged_attention.cu``). Slice 2 is training on one device:
``Trainer(strategy=RayStrategy(num_workers=1)).fit(GPTModule(...))``,
with ``attention_impl="flash"`` running hand-written CUDA flash-attention
kernels forward and backward (``csrc/flash_attention.cu``).

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
from ray_lightning_tpu_torch.core import (Callback, TpuDataModule,
                                          TpuModule, Trainer, make_optimizer)
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import (GPTModule, TransformerConfig,
                                            TransformerLM, gpt2_config)
from ray_lightning_tpu_torch.serve import ServeClient, ServeEngine
from ray_lightning_tpu_torch.strategies import RayStrategy

__all__ = ["Callback", "TpuDataModule", "TpuModule", "Trainer",
           "make_optimizer", "resolve_device", "load_flax_params",
           "GPTModule", "TransformerConfig", "TransformerLM", "gpt2_config",
           "ServeClient", "ServeEngine", "RayStrategy"]
