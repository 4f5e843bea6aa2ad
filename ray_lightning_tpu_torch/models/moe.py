"""Mixture-of-Experts LM (counterpart of ``ray_lightning_tpu/models/moe.py``).

The GShard/Switch dense dispatch of the JAX package: routing builds
static-shape 0/1 ``dispatch`` and gate-weighted ``combine`` tensors
(N, E, C) (:func:`route_top_k`), the experts run as one batched product
over a leading experts dimension, and a token an expert has no room for
is dropped for that slot (combine weight 0: the residual carries it
through unchanged). Each expert takes at most ``capacity = ceil(k · N ·
capacity_factor / E)`` tokens of a forward's N, computed in the JAX
package's float arithmetic (:func:`expert_capacity`). The Switch
auxiliary loss ``E · Σ_e f_e · P_e / k`` reaches the training loss
through :class:`MoeModule` (``ce + aux_loss_weight · aux``).

**The products reach ATen as the remat policies expect**
(:mod:`.remat`): the dispatch ``nec,nd->ecd`` and the combine
``ecd,nec->nd`` contract over tokens or slots with no batch dimension,
which JAX's ``dots_with_no_batch_dims`` keeps, so they are ``mm``\\ s on
flattened views; the two expert products have the experts as a batch
dimension and are ``bmm``\\ s, kept only by ``"dots"``. The router is an
f32 ``addmm``. No named seat: JAX's ``MoeMlp`` names none.

**Routing across ranks.** Which tokens an expert drops depends on every
token of the batch the routing sees. The JAX SPMD strategies (DDP, ZeRO,
FSDP) jit the step over the global batch, whose rows rank ``r`` holds
as ``[r·B/W, (r+1)·B/W)`` (``Strategy.shard_batch``), while the JAX
``HorovodRayStrategy`` routes each rank's rows under ``shard_map``.
``Strategy.bind_batch_stats`` sets :attr:`MoeMlp.sync_stats` for the
former, and a rank then routes its rows as their place in the global
batch routes them: the capacity from the global N, each expert's
positions offset by the tokens the ranks before it sent there (one
all-gather of the per-expert counts a slot), the earlier slots' claims
summed over ranks, and the aux loss's fractions and mean probabilities
as global means, the latter through an autograd-aware all-reduce so the
router's gradient is the global one.

At decode (a ``cache`` of :class:`DenseKV`) the capacity is per call,
N = B·T of that call, as in JAX: a cached decode matches a full
recompute only where no expert overflows in either
(``tests/test_moe.py``'s setting, ``capacity_factor`` 16).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.core.optim import make_optimizer
from ray_lightning_tpu_torch.data.loader import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models import remat as _remat
from ray_lightning_tpu_torch.models.transformer import (
    DenseKV, Dense, Embed, LayerNorm, MultiHeadAttention, TransformerConfig,
    check_dropout_seed, check_seq_len, init_params)
from ray_lightning_tpu_torch.ops import dropout as _dropout


@dataclasses.dataclass(frozen=True)
class MoeConfig(TransformerConfig):
    n_experts: int = 8
    expert_top_k: int = 1
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


def expert_parallel_rule(path, leaf):
    """The JAX package's ``MeshStrategy(param_rule=...)`` rule that shards
    the experts dimension over an ``ep`` mesh axis: not ported yet."""
    raise NotImplementedError(
        "expert_parallel_rule (experts sharded over an 'ep' mesh axis) is "
        "not ported yet (ROADMAP.md A, item 9: multi-axis meshes)")


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots per expert for ``n_tokens`` routed tokens, in the JAX
    package's arithmetic: ``max(1, int(np.ceil(k * N * cf / E)))``."""
    return max(1, int(np.ceil(top_k * n_tokens * capacity_factor
                              / n_experts)))


#: ``exchange(counts) -> (before, total)``: this rank's per-expert claims
#: of one slot (E,) int32 -> the claims of the ranks before it and of
#: every rank
Exchange = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def route_top_k(probs: torch.Tensor, capacity: int, top_k: int,
                exchange: Optional[Exchange] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape top-k routing of ``probs`` (N, E) f32: ``(dispatch,
    combine)``, both (N, E, C) f32, equal to the JAX package's.

    For each of the k slots: the argmax over the experts not yet taken
    (the first index on ties, as ``jnp.argmax``), the token's position
    in its expert by the cumsum over tokens plus the slots claimed by
    earlier slots, kept while the position is below ``capacity``;
    ``combine`` carries the gate read from the unmasked ``probs``.
    ``exchange`` (None: these N tokens are the whole batch) places them
    after the tokens of the ranks before this one, as they sit in the
    global batch."""
    N, E = probs.shape
    dispatch = probs.new_zeros((N, E, capacity))
    combine = probs.new_zeros((N, E, capacity))
    claimed = torch.zeros(E, dtype=torch.int32, device=probs.device)
    remaining = probs
    for _ in range(top_k):
        onehot = F.one_hot(torch.argmax(remaining, dim=-1), E).to(probs.dtype)
        gate = torch.sum(probs * onehot, dim=-1)                  # (N,)
        counts = onehot.sum(0).to(torch.int32)
        before, total = ((torch.zeros_like(counts), counts)
                         if exchange is None else exchange(counts))
        pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot       # 0-based
        pos = pos + (claimed + before)[None, :].to(probs.dtype) * onehot
        keep = (pos < capacity).to(probs.dtype) * onehot
        pos_idx = pos.to(torch.int32).clamp(0, capacity - 1).long()
        slot = torch.zeros_like(dispatch).scatter_(
            2, pos_idx[:, :, None], keep[:, :, None])            # (N, E, C)
        dispatch = dispatch + slot
        combine = combine + slot * gate[:, None, None]
        claimed = claimed + total
        remaining = remaining * (1.0 - onehot)
    return dispatch, combine


def _rank_exchange(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:data:`Exchange` over the default process group: every rank's
    counts, all-gathered in rank order."""
    import torch.distributed as dist
    parts = [torch.empty_like(counts) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, counts.contiguous())
    every = torch.stack(parts)
    return every[:dist.get_rank()].sum(0, dtype=torch.int32), \
        every.sum(0, dtype=torch.int32)


class MoeMlp(nn.Module):
    """The top-k routed expert FFN bank (flax ``MoeMlp``): a ``router``
    Dense with bias computed in f32, and the banks ``experts_up`` (E, d,
    d_ff), ``experts_up_bias`` (E, 1, d_ff), ``experts_down`` (E, d_ff,
    d), ``experts_down_bias`` (E, 1, d) in flax's layout. ``forward(x)``
    returns ``(out, aux)``; ``last_dispatched`` keeps the last forward's
    dispatched slots (a host int, for the dropped share)."""

    def __init__(self, cfg: MoeConfig, device):
        super().__init__()
        self.cfg = cfg
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        # the router computes in f32 whatever the compute dtype
        self.router = Dense(d, E, dataclasses.replace(
            cfg, dtype=torch.float32), device)

        def bank(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype,
                                            device=device))

        self.experts_up = bank(E, d, f)
        self.experts_up_bias = bank(E, 1, f)
        self.experts_down = bank(E, f, d)
        self.experts_down_bias = bank(E, 1, d)
        # routing over every rank's rows (the SPMD strategies), set by
        # Strategy.bind_batch_stats
        self.sync_stats = False
        self.last_dispatched: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, T, d = x.shape
        N, E, k = B * T, cfg.n_experts, cfg.expert_top_k
        world, exchange = 1, None
        if self.sync_stats:
            import torch.distributed as dist
            world, exchange = dist.get_world_size(), _rank_exchange
        capacity = expert_capacity(N * world, E, k, cfg.capacity_factor)
        tokens = x.reshape(N, d)
        probs = torch.softmax(self.router(tokens.float()), dim=-1)  # f32
        dispatch, combine = route_top_k(probs, capacity, k, exchange)
        # Switch aux loss: E * sum_e (fraction routed to e) * (mean prob e)
        routed = dispatch.sum(2)                                  # (N, E)
        if exchange is None:
            frac, mean_probs = routed.mean(0), probs.mean(0)
        else:
            import torch.distributed as dist
            from torch.distributed.nn.functional import all_reduce
            routed = routed.sum(0)
            dist.all_reduce(routed)
            frac = routed / (N * world)
            mean_probs = all_reduce(probs.sum(0)) / (N * world)
        aux = E * torch.sum(frac * mean_probs) / k
        self.last_dispatched = dispatch.detach().sum()

        dt = cfg.dtype
        expert_in = torch.mm(dispatch.to(dt).reshape(N, E * capacity).t(),
                             tokens.to(dt)).view(E, capacity, d)
        h = torch.bmm(expert_in, self.experts_up.to(dt)) \
            + self.experts_up_bias.to(dt)
        # flax nn.gelu is the tanh approximation
        h = F.gelu(h, approximate="tanh")
        expert_out = torch.bmm(h, self.experts_down.to(dt)) \
            + self.experts_down_bias.to(dt)                       # (E, C, d)
        out = torch.mm(combine.to(dt).reshape(N, E * capacity),
                       expert_out.reshape(E * capacity, d))       # (N, d)
        return out.view(B, T, d), aux


class MoeTransformerBlock(nn.Module):
    """Pre-LN attention (the port's ``MultiHeadAttention``, with its
    ``attn_out`` seat and attention dropout), then the routed experts
    with no MLP dropout. Returns ``(x, aux)``; rematerialized under
    ``cfg.remat`` with the five policies."""

    def __init__(self, cfg: MoeConfig, device, layer: int = 0):
        super().__init__()
        self.cfg = cfg
        self.layer = layer
        self.ln1 = LayerNorm(cfg.d_model, cfg, device)
        self.attn = MultiHeadAttention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, cfg, device)
        self.moe = MoeMlp(cfg, device)

    def forward(self, x, kv_positions=None, kv: Optional[DenseKV] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        if self.cfg.remat and kv is None and torch.is_grad_enabled():
            return _remat.checkpoint_block(
                self._remat_forward, x, deterministic, dropout_seed,
                policy=self.cfg.remat_policy)
        return self._forward(x, kv_positions, kv, deterministic,
                             dropout_seed)

    def _remat_forward(self, x, deterministic, dropout_seed):
        return self._forward(x, None, None, deterministic, dropout_seed,
                             seats=True)

    def _forward(self, x, kv_positions, kv, deterministic, dropout_seed,
                 seats: bool = False):
        attn_rng = None
        if self.cfg.dropout > 0.0 and not deterministic:
            attn_rng = _dropout.site_seed(dropout_seed, self.layer,
                                          _dropout.ATTENTION)
        x = x + self.attn(self.ln1(x), kv_positions=kv_positions, kv=kv,
                          dropout_rng=attn_rng, seats=seats)
        out, aux = self.moe(self.ln2(x))
        return x + out, aux


class MoeTransformerLM(nn.Module):
    """Causal MoE LM (flax ``MoeTransformerLM``): ``wte``/``wpe``, the
    unrolled blocks ``blocks.i`` (flax ``block_i``), ``ln_f`` and the head
    tied to ``wte``. ``forward(tokens)`` returns ``(logits, aux)``: f32
    logits (B, T, vocab) and the blocks' mean aux loss. ``positions``,
    ``kv_positions`` and ``cache`` (a list of ``DenseKV``) are
    ``TransformerLM``'s shared-index and per-row cached modes, which
    :func:`~ray_lightning_tpu_torch.models.generate.generate` drives.
    ``device=None`` builds on the card."""

    def __init__(self, cfg: MoeConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.d_model, cfg, dev)
        self.wpe = Embed(cfg.max_seq_len, cfg.d_model, cfg, dev)
        self.blocks = nn.ModuleList(MoeTransformerBlock(cfg, dev, layer=i)
                                    for i in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg, dev)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """:func:`~ray_lightning_tpu_torch.models.transformer.init_params`
        from ``generator``: N(0, 0.02) matrices and expert banks, zero
        biases, unit LayerNorm scales."""
        init_params(self, generator)

    @property
    def device(self) -> torch.device:
        return self.ln_f.weight.device

    def dispatched(self) -> List[int]:
        """Each layer's dispatched slots in the last forward."""
        return [int(b.moe.last_dispatched) for b in self.blocks]

    def forward(self, tokens: torch.Tensor, positions=None,
                kv_positions=None, cache=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        T = tokens.shape[1]
        if positions is None:
            check_seq_len(cfg, T)
            positions = torch.arange(T, device=tokens.device)[None]
        check_dropout_seed(cfg, deterministic, dropout_seed)
        x = self.wte(tokens) + self.wpe(positions)
        aux_total = 0.0
        for i, block in enumerate(self.blocks):
            x, aux = block(x, kv_positions=kv_positions,
                           kv=None if cache is None else cache[i],
                           deterministic=deterministic,
                           dropout_seed=dropout_seed)
            aux_total = aux_total + aux
        x = self.ln_f(x)
        return self.wte.attend(x).float(), aux_total / cfg.n_layers


@functools.lru_cache(maxsize=16)
def jax_leaves(cfg: MoeConfig):
    """The JAX MoE LM's parameter leaves over the port's parameters
    (``transformer.jax_leaves``' form, for ``make_optimizer(leaves=)``):
    the MoE is unrolled, so every parameter is a leaf of its own, in the
    flax layout (the qkv kernel (d, 3, H, D) and its bias (3, H, D), the
    router's kernel (d, E), the expert banks as they are)."""
    from ray_lightning_tpu_torch.interop import flax_layout
    leaves = []
    for i, (name, p) in enumerate(
            MoeTransformerLM(cfg, device="meta").named_parameters()):
        shape = tuple(flax_layout(name, p, cfg.n_heads).shape)
        if name.endswith("attn.qkv.bias"):
            shape = (3, cfg.n_heads, cfg.head_dim)
        leaves.append((shape, (i,)))
    return tuple(leaves)


MOE_SIZES = {
    # name: (n_layers, d_model, n_heads, n_experts)
    "nano": (2, 64, 2, 4),
    "small": (4, 256, 4, 8),
}


def moe_config(size: str = "nano", **overrides) -> MoeConfig:
    n_layers, d_model, n_heads, n_experts = MOE_SIZES[size]
    base = dict(d_model=d_model, n_heads=n_heads, n_layers=n_layers,
                d_ff=4 * d_model, n_experts=n_experts, causal=True,
                scan_layers=False)
    base.update(overrides)
    return MoeConfig(**base)


def _synthetic_lm_tokens(num_samples: int, seq_len: int, vocab_size: int,
                         seed: int):
    """The JAX package's learnable synthetic LM data, draw for draw: next
    token = (token + 1) mod vocab, with 5% noise. Returns (inputs,
    targets), each (num_samples, seq_len) int32."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab_size, size=(num_samples, 1))
    ramp = np.arange(seq_len + 1)[None, :]
    toks = ((start + ramp) % vocab_size).astype(np.int32)
    noise = rng.integers(0, vocab_size, size=toks.shape)
    toks = np.where(rng.random(toks.shape) < 0.05, noise, toks)
    return toks[:, :-1], toks[:, 1:]


class MoeModule(TpuModule):
    """MoE LM training on the synthetic LM data. The loss is ``ce +
    aux_loss_weight · aux``, with ``train_ce`` and ``train_aux`` logged;
    validation returns ``val_ce`` and ``val_aux``. ``optimizer`` is a
    ``make_optimizer`` preset on the JAX model's leaves (weight decay
    0.01; the adam presets' ``b2`` left at 0.999, as the JAX module
    leaves it)."""

    def __init__(self, config: Optional[MoeConfig] = None,
                 size: str = "nano", batch_size: int = 8,
                 seq_len: int = 64, num_samples: int = 256,
                 lr: float = 1e-3, vocab_size: int = 256,
                 optimizer: str = "adamw"):
        super().__init__()
        if config is None:
            config = moe_config(size, vocab_size=vocab_size,
                                max_seq_len=seq_len)
        self.cfg = config
        self.batch_size = batch_size
        self.seq_len = min(seq_len, config.max_seq_len)
        self.num_samples = num_samples
        self.lr = lr
        self.optimizer = optimizer

    def configure_model(self):
        # built on "meta": the trainer places and initialises it
        return MoeTransformerLM(self.cfg, device="meta")

    def configure_optimizers(self):
        return make_optimizer(self.optimizer, self.lr, weight_decay=0.01,
                              leaves=jax_leaves(self.cfg))

    def _loader(self, seed: int, shuffle: bool = False):
        x, y = _synthetic_lm_tokens(self.num_samples, self.seq_len,
                                    self.cfg.vocab_size, seed)
        return DataLoader(ArrayDataset((x, y)), batch_size=self.batch_size,
                          shuffle=shuffle)

    def train_dataloader(self):
        return self._loader(0, shuffle=True)

    def val_dataloader(self):
        return self._loader(1)

    def _loss(self, model, batch):
        tokens, targets = batch
        logits, aux = model(tokens)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1).long())
        return ce, aux

    def training_step(self, model, batch, generator):
        ce, aux = self._loss(model, batch)
        self.log("train_ce", ce)
        self.log("train_aux", aux)
        return ce + self.cfg.aux_loss_weight * aux

    def validation_step(self, model, batch, generator):
        ce, aux = self._loss(model, batch)
        return {"val_ce": ce, "val_aux": aux}
