"""The ResNet family (counterpart of ``ray_lightning_tpu/models/resnet.py``).

The BASELINE configurations: ResNet-18 on CIFAR-10 under data
parallelism, ResNet-50 under population-based training. The model takes
the JAX package's NHWC numpy batches and permutes them to NCHW inside;
the permuted view of an NHWC tensor is already channels-last in memory,
which is the layout cuDNN's convolutions prefer on the card.

BatchNorm's running statistics are the module's state: flax keeps them in
the mutable ``batch_stats`` collection, which the JAX trainer carries as
``TrainState.model_state`` through a step's third return value. Here
they are the buffers ``running_mean`` and ``running_var`` of the port's
own :class:`BatchNorm`, moved in place by the forward in training mode;
the trainer's state dict, checkpoints and strategies carry them with the
parameters (``core/train_state.py``). :class:`BatchNorm` follows flax's
``BatchNorm`` rather than ``nn.BatchNorm2d``:

- batch statistics over N, H and W in at least f32, the variance as
  E[x²] − E[x]² clipped at 0 (flax's ``use_fast_variance``);
- the *biased* variance into the running variance (``nn.BatchNorm2d``
  puts the unbiased one there), ``ra = 0.9·ra + 0.1·batch``, epsilon
  1e-5, and no ``num_batches_tracked`` (flax keeps no counter);
- the normalisation in f32, ``(x − mean)·(rsqrt(var + eps)·scale) +
  bias``, cast back to the input's dtype;
- running averages whenever the module is not in training mode;
- under the SPMD data-parallel strategies (``sync_stats``, set by
  ``Strategy.bind_batch_stats``) the statistics are the global batch's:
  each rank's means are averaged over ranks with an autograd-aware
  all-reduce, as the JAX strategies' one-program step computes them.

Convolutions pad as XLA's ``"SAME"`` does: the low side takes
``total // 2``, so a 3×3/2 convolution over an even size pads (0, 1),
the 7×7/2 stem on 224² pads (2, 3) and the 3×3/2 max-pool pads (0, 1)
with −inf. ``nn.Conv2d(padding=1)`` gives the same output size over
shifted windows.

``dtype=torch.bfloat16`` is JAX's ``dtype=jnp.bfloat16``: convolutions
take bf16 inputs and weights (cast from the f32 params) and return bf16,
the normalisation computes in f32 and returns bf16, the head is f32 on
the bf16 pooled features. Params and running statistics stay f32. On the
card an f32 model's convolutions follow ``torch.backends.cudnn.
allow_tf32``, which PyTorch leaves on: cuDNN then multiplies in TF32
(10 mantissa bits). ``chip_smoke.py`` and the card tests turn it off and
hold the f32 path against the CPU at f32 bounds.

Initialisation follows flax's rules, drawn from one generator in module
order: convolution kernels LeCun-normal over fan-in kh·kw·C_in with no
bias, BatchNorm scale 1 and bias 0 (scale 0 on the last norm of every
block), running mean 0 and variance 1, and the head as flax's ``Dense``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.data.loader import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.data.synthetic import synthetic_images
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.bert import classification_metrics
from ray_lightning_tpu_torch.models.boring import Linear

#: flax's ``lecun_normal`` truncates at 2 sigma and rescales by the
#: truncated distribution's std
_TRUNC_STD = .87962566103423978


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial dimension under XLA's
    ``"SAME"``: the output has ``ceil(size / stride)`` positions and the
    low side takes half the total, rounded down."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    (hl, hh), (wl, wh) = (same_padding(x.shape[2], kernel, stride),
                          same_padding(x.shape[3], kernel, stride))
    if hl == hh == wl == wh == 0:
        return x
    return F.pad(x, (wl, wh, hl, hh), value=value)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME")`` on NCHW: a
    square kernel, its weight in torch's (D, C, kh, kw) layout, computed
    in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel, kernel, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """LeCun-normal over fan-in kh·kw·C_in, truncated at 2 sigma."""
        d, c, kh, kw = self.weight.shape
        std = math.sqrt(1.0 / (c * kh * kw)) / _TRUNC_STD
        w = torch.empty(self.weight.shape)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        with torch.no_grad():
            self.weight.copy_(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        (hl, hh), (wl, wh) = (
            same_padding(x.shape[2], self.kernel, self.stride),
            same_padding(x.shape[3], self.kernel, self.stride))
        if hl == hh and wl == wh:
            return F.conv2d(x, w, stride=self.stride, padding=(hl, wl))
        return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the
    channels of NCHW input (see the module docstring). ``scale_init``
    is the initial scale (0 on a block's last norm)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, scale_init: float = 1.0,
                 device=None):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale_init = scale_init
        # statistics over every rank's rows (the SPMD strategies)
        self.sync_stats = False
        self.weight = nn.Parameter(torch.empty(num_features, device=device))
        self.bias = nn.Parameter(torch.empty(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.empty(num_features, device=device))
        self.register_buffer("running_var",
                             torch.empty(num_features, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Scale ``scale_init``, bias 0, running mean 0, variance 1 (no
        draws)."""
        del generator
        with torch.no_grad():
            self.weight.fill_(self.scale_init)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def _batch_stats(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        xf = x.float()
        mu = xf.mean((0, 2, 3))
        mu2 = (xf * xf).mean((0, 2, 3))
        if self.sync_stats:
            import torch.distributed as dist
            from torch.distributed.nn.functional import all_reduce
            both = all_reduce(torch.stack([mu, mu2])) / dist.get_world_size()
            mu, mu2 = both[0], both[1]
        return mu, torch.clamp(mu2 - mu * mu, min=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = self._batch_stats(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (x.float() - mean.reshape(shape)) * mul.reshape(shape)
        return (y + self.bias.reshape(shape)).to(x.dtype)


class ResNetBlock(nn.Module):
    """Two 3×3 convolutions (the first with the stride), a projection
    (``conv_proj``, ``norm_proj``) where the shape changes."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(in_channels, filters, 3, stride, **kw)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, **kw)
        self.BatchNorm_1 = BatchNorm(filters, scale_init=0.0, device=device)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or in_channels != filters:
            self.conv_proj = Conv(in_channels, filters, 1, stride, **kw)
            self.norm_proj = BatchNorm(filters, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1×1, 3×3 (with the stride), 1×1 to ``4·filters``, and a
    projection where the shape changes."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        out = filters * 4
        self.Conv_0 = Conv(in_channels, filters, 1, **kw)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, stride, **kw)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.Conv_2 = Conv(filters, out, 1, **kw)
        self.BatchNorm_2 = BatchNorm(out, scale_init=0.0, device=device)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or in_channels != out:
            self.conv_proj = Conv(in_channels, out, 1, stride, **kw)
            self.norm_proj = BatchNorm(out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """The stem (``small_images=True``: a 3×3 convolution and no
    max-pool, CIFAR's; ``False``: 7×7/2 and a 3×3/2 max-pool), the
    stages of ``block_cls`` (the first block of every stage after the
    first strides 2), global average pooling and an f32 head. The blocks
    sit in one ``nn.ModuleList`` (``blocks.i`` is flax's
    ``ResNetBlock_i`` / ``BottleneckBlock_i``), so FSDP2 shards each
    block as a unit. Takes NHWC images. ``device=None`` builds on the
    card."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 10, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32,
                 small_images: bool = True, in_channels: int = 3,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.stage_sizes = list(stage_sizes)
        self.dtype = dtype
        self.small_images = small_images
        kw = dict(dtype=dtype, device="meta")
        # built on "meta" (no draws), then placed and drawn from one
        # generator
        self.conv_init = Conv(in_channels, num_filters,
                              3 if small_images else 7,
                              1 if small_images else 2, **kw)
        self.bn_init = BatchNorm(num_filters, device="meta")
        blocks, channels = [], num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                blocks.append(block_cls(channels, filters,
                                        2 if i > 0 and j == 0 else 1, **kw))
                channels = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.Dense_0 = Linear(channels, num_classes, device="meta")
        if dev.type != "meta":
            self.to_empty(device=dev)
            self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Every parameter and running statistic as flax initialises
        them, the draws from ``generator`` (None = a fresh one seeded 0)
        in module order. The buffers are set here too: ``to_empty``
        leaves them uninitialised."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (Conv, BatchNorm, Linear)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_init(x.permute(0, 3, 1, 2))
        x = F.relu(self.bn_init(x))
        if not self.small_images:
            x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x)
        return self.Dense_0(x.mean((2, 3)).float())


def resnet10(num_classes: int = 10, **kw) -> ResNet:
    """One block a stage: resnet18's stem, BatchNorm and residual
    topology at half its depth (the tests' tier)."""
    return ResNet([1, 1, 1, 1], ResNetBlock, num_classes=num_classes, **kw)


def resnet18(num_classes: int = 10, **kw) -> ResNet:
    return ResNet([2, 2, 2, 2], ResNetBlock, num_classes=num_classes, **kw)


def resnet50(num_classes: int = 10, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes=num_classes,
                  **kw)


class ResNetModule(TpuModule):
    """CIFAR-10-style classification of the synthetic images, the
    running statistics moved by every training step. SGD with Nesterov
    momentum (``torch.optim.SGD(momentum=m, nesterov=True)`` computes
    optax's ``sgd(lr, momentum=m, nesterov=True)`` update).
    ``config`` overrides ``batch_size``, ``lr`` and ``momentum`` (what
    Tune's trials pass)."""

    def __init__(self,
                 depth: int = 18,
                 num_classes: int = 10,
                 batch_size: int = 32,
                 image_size: int = 32,
                 num_samples: int = 512,
                 lr: float = 0.1,
                 momentum: float = 0.9,
                 dtype: torch.dtype = torch.float32,
                 config: Optional[dict] = None):
        super().__init__()
        config = config or {}
        self.depth = depth
        self.num_classes = num_classes
        self.batch_size = int(config.get("batch_size", batch_size))
        self.image_size = image_size
        self.num_samples = num_samples
        self.lr = config.get("lr", lr)
        self.momentum = config.get("momentum", momentum)
        self.dtype = dtype

    def configure_model(self):
        factory = {10: resnet10, 18: resnet18, 50: resnet50}[self.depth]
        # built on "meta": the trainer places and initialises it
        return factory(self.num_classes, dtype=self.dtype, device="meta")

    def configure_optimizers(self):
        lr, momentum = self.lr, self.momentum
        return lambda params: torch.optim.SGD(params, lr=lr,
                                              momentum=momentum,
                                              nesterov=True)

    def _loader(self, seed: int, shuffle: bool = False):
        x, y = synthetic_images(self.num_samples, self.num_classes,
                                self.image_size, seed=seed)
        return DataLoader(ArrayDataset((x, y)), batch_size=self.batch_size,
                          shuffle=shuffle)

    def train_dataloader(self):
        return self._loader(0, shuffle=True)

    def val_dataloader(self):
        return self._loader(1)

    def test_dataloader(self):
        return self._loader(2)

    def training_step(self, model, batch, generator):
        x, y = batch
        loss, acc = classification_metrics(model(x), y)
        self.log("train_acc", acc)
        return loss

    def validation_step(self, model, batch, generator):
        x, y = batch
        loss, acc = classification_metrics(model(x), y)
        return {"val_loss": loss, "val_acc": acc}

    def test_step(self, model, batch, generator):
        x, y = batch
        return {"acc": classification_metrics(model(x), y)[1]}
