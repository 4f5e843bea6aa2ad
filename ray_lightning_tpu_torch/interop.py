"""Weights across frameworks: the JAX package's flax param tree -> the port.

:func:`load_flax_params` takes the tree of a ``TransformerLM`` of the JAX
package as nested dicts of numpy arrays (anything ``np.asarray`` reads),
in either layer layout -- scanned (``stack/layers/block`` with a leading
layer axis) or unrolled (``stack/block_i``) -- and fills the port's
module in place; so it does for the encoder family and the MLP
(``TransformerEncoder``, ``BertClassifier``, ``ViTClassifier``,
``MNISTNet``). A flax path is the port's attribute path
(``encoder/stack/block_3/attn/qkv/kernel`` is
``encoder.stack.blocks.3.attn.qkv.weight``), every leaf is taken by it,
and a JAX leaf the port lacks, or a port parameter the tree lacks,
raises. The layouts differ in these places:

- flax ``Dense`` kernels are (in, out); torch ``Linear`` weights are
  (out, in), so every kernel is transposed;
- ``qkv`` is a ``DenseGeneral`` kernel (d, 3, H, head_dim) with bias
  (3, H, head_dim): flattened to (3·H·head_dim, d) rows ordered
  (3, H, head_dim), which is the split ``MultiHeadAttention`` takes;
  ``out`` is an (H·head_dim, d) kernel;
- flax ``LayerNorm`` names its weight ``scale`` (and uses epsilon 1e-6
  with f32 statistics -- ``models.transformer.LayerNorm`` matches it);
- the LM head is tied to ``wte/embedding`` (vocab, d), or, untied
  (``tie_embeddings=False``), a bias-free Dense kernel ``lm_head/kernel``
  (d, vocab), the port's ``lm_head.weight`` transposed;
- embeddings are ``embedding`` (rows, d), the same layout as torch;
- ViT's patch embedding is a flax ``Conv`` kernel (p, p, C, D): the
  port's ``patch_embed.weight`` is torch's convolution layout (D, C, p,
  p); ``cls_token`` and ``pos_embed`` are raw leaves of the same shape;
- a ResNet comes as flax *variables*, ``{"params": ..., "batch_stats":
  ...}``: every conv kernel (kh, kw, C, D) becomes (D, C, kh, kw), a
  BatchNorm's ``scale``/``bias`` its ``weight``/``bias``, and its
  ``batch_stats`` ``mean``/``var`` the buffers ``running_mean``/
  ``running_var``; the blocks ``ResNetBlock_i`` / ``BottleneckBlock_i``
  are ``blocks.i``. A ResNet's bare param tree lacks the running
  statistics and raises;
- a Mixture-of-Experts LM (``MoeTransformerLM``) has its blocks
  ``block_i`` straight under the root (no ``stack``) and no untied head:
  ``block_i/moe/router/kernel`` (d, E) is transposed like every Dense
  kernel, and the expert banks ``experts_up`` (E, d, d_ff),
  ``experts_down`` (E, d_ff, d) and their biases (E, 1, ·) keep their
  layout (the port's banks are the flax ones);
- an encoder-decoder (``Seq2SeqTransformer``) has its encoder stack
  ``encoder`` (scanned or unrolled) and its decoder blocks ``dec_i``
  straight under the root, with the names flax gives them; a decoder
  block's cross-attention has a ``q`` kernel (d, H, head_dim) with bias
  (H, head_dim) and a ``kv`` kernel (d, 2, H, head_dim) with bias (2, H,
  head_dim), flattened as ``qkv`` is (rows ordered (2, H, head_dim));
- a LoRA model's adapter banks (``lora_A`` (N, in, r) and ``lora_B``
  (N, r, out) beside a targeted projection's kernel) keep their layout:
  the port's banks are the flax ones (``models/lora.py``). An adapter
  tree (one bank slot, nested dicts under the flax paths) is the same
  in both packages: the port's ``install_adapter`` reads the JAX
  package's as it is, and :func:`adapter_to_numpy` gives the JAX
  package a port tree.

Quantized weights keep the flax layout (``models/quant.py``):
:func:`flax_weights` gives the flax-layout view of each of a port
model's matrices (what the port quantizes, so its codes and scales are
JAX's), and :func:`load_flax_quantized` carries a tree quantized by the
JAX package's ``quantize_params`` across as it is.

The tanh GELU and the final f32 cast of the logits are the model's
business (``models/transformer.py``), not the weights'.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.models.quant import QTensor

#: the port's Dense weights of flax ``Dense`` kernels: flax kernel =
#: weight.T
_DENSE_SUFFIXES = (".attn.out.weight", ".mlp.up.weight", ".mlp.down.weight",
                   ".moe.router.weight", ".self_attn.out.weight",
                   ".cross_attn.out.weight")
_LM_HEAD = "lm_head.weight"        # the untied head, also weight.T
#: ``DenseGeneral`` projections with head axes, by the port's module
#: name: their flax kernel's feature axes ahead of (H, head_dim) -- the
#: self-attention's fused qkv (3, H, hd), the cross-attention's q (H,
#: hd) and kv (2, H, hd)
_GENERAL_GROUPS = {"qkv": 3, "q": 1, "kv": 2}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _general(name: str):
    """``(groups, "weight" | "bias")`` of a ``DenseGeneral`` projection
    with head axes, or None."""
    parts = name.rsplit(".", 2)
    if len(parts) == 3 and parts[1] in _GENERAL_GROUPS \
            and parts[2] in ("weight", "bias"):
        return _GENERAL_GROUPS[parts[1]], parts[2]
    return None


def _is_lora(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("lora_A", "lora_B")


def _is_dense(name: str) -> bool:
    return name.endswith(_DENSE_SUFFIXES) or name == _LM_HEAD


def _is_quantized_leaf(leaf) -> bool:
    """A quantized leaf of the JAX package (its ``QTensor``), read by
    duck type: codes ``q``, ``scale`` and the metadata beside them."""
    return all(hasattr(leaf, a) for a in ("q", "scale", "bits",
                                          "group_size", "shape", "dtype"))


def unstack_scan_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Scanned layer stacks (``layers/block`` with a leading layer axis)
    -> the unrolled ``block_i`` layout, anywhere in the tree."""
    if not isinstance(params, Mapping):
        return params
    out: Dict[str, Any] = {}
    for key, val in params.items():
        if key == "layers" and isinstance(val, Mapping) \
                and set(val) == {"block"}:
            n_layers = _first_leaf(val["block"]).shape[0]
            for i in range(n_layers):
                out[f"block_{i}"] = _map_leaves(lambda x, i=i: x[i],
                                                val["block"])
        else:
            out[key] = unstack_scan_params(val)
    return out


def _stacked_leaf(leaf) -> np.ndarray:
    if _is_quantized_leaf(leaf):
        raise ValueError(
            "a quantized leaf inside a scanned layer stack has scales "
            "shared across the layer axis; quantize the unrolled tree "
            "(scan_layers=False) instead")
    return np.asarray(leaf)


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return _stacked_leaf(tree)


def _map_leaves(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(_stacked_leaf(tree))


def _flax_leaves(params: Mapping[str, Any]) -> Iterator[Tuple[str, Any]]:
    """(port state-dict name, flax leaf) for every leaf of a flax
    ``TransformerLM`` tree, scanned or unrolled; leaves as they are."""
    p = unstack_scan_params(params)
    yield "wte.weight", p["wte"]["embedding"]
    yield "wpe.weight", p["wpe"]["embedding"]
    yield "ln_f.weight", p["ln_f"]["scale"]
    yield "ln_f.bias", p["ln_f"]["bias"]
    if "lm_head" in p:
        yield _LM_HEAD, p["lm_head"]["kernel"]
    stack = p["stack"]
    n_layers = sum(1 for k in stack if k.startswith("block_"))
    for i in range(n_layers):
        blk = stack[f"block_{i}"]
        pre = f"stack.blocks.{i}."
        for mod, name in (("attn", "qkv"), ("attn", "out"), ("mlp", "up"),
                          ("mlp", "down")):
            proj = blk[mod][name]
            yield pre + f"{mod}.{name}.weight", proj["kernel"]
            yield pre + f"{mod}.{name}.bias", proj["bias"]
            for bank in ("lora_A", "lora_B"):
                if bank in proj:
                    yield pre + f"{mod}.{name}.{bank}", proj[bank]
        for ln in ("ln1", "ln2"):
            yield pre + f"{ln}.weight", blk[ln]["scale"]
            yield pre + f"{ln}.bias", blk[ln]["bias"]


def _to_port_layout(name: str, leaf: np.ndarray) -> np.ndarray:
    general = _general(name)
    if general is not None:
        if general[1] == "weight":          # (d, [3 | 2,] H, hd)
            return leaf.reshape(leaf.shape[0], -1).T
        return leaf.reshape(-1)             # ([3 | 2,] H, hd)
    if _is_dense(name):
        return leaf.T
    return leaf


#: flax leaf names -> the port's parameter names
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
#: flax ``batch_stats`` leaf names -> the port's buffer names
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
#: flax's names of repeated layers, each ``<prefix>i`` the port's
#: ``blocks.i``
_BLOCK_PREFIXES = ("block_", "ResNetBlock_", "BottleneckBlock_")


def _port_key(key: str) -> list:
    for prefix in _BLOCK_PREFIXES:
        idx = key[len(prefix):]
        if key.startswith(prefix) and idx.isdigit():
            return ["blocks", idx]
    return [key]


def _tree_leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _tree_leaves(val, path + (key,))
        else:
            yield path + (key,), val


def flax_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's state-dict entries (as numpy) for a flax param tree --
    a ``TransformerLM``'s or a ``Seq2SeqTransformer``'s, scanned or
    unrolled, or one of the encoder family's or the MLP's -- or for flax
    variables ``{"params": ..., "batch_stats": ...}`` (a ResNet's), every
    leaf by its path: ``block_i``, ``ResNetBlock_i`` and
    ``BottleneckBlock_i`` are ``blocks.i``; a Dense kernel is
    transposed, the qkv, q and kv kernels and biases flattened, a conv
    kernel (kh, kw, C, D) becomes (D, C, kh, kw);
    ``batch_stats`` ``mean``/``var`` become ``running_mean``/
    ``running_var``."""
    if "params" in params and isinstance(params["params"], Mapping):
        stats = params.get("batch_stats", {})
        extra = sorted(set(params) - {"params", "batch_stats"})
        if extra:
            raise ValueError(f"flax variables with collections {extra}: "
                             "only params and batch_stats map to the port")
        return {**flax_state_dict(params["params"]),
                **_stat_entries(stats)}
    out = {}
    for path, leaf in _tree_leaves(unstack_scan_params(params)):
        parts = [p for key in path[:-1] for p in _port_key(key)]
        name = ".".join(parts + [_LEAF_NAMES.get(path[-1], path[-1])])
        x = np.asarray(leaf)
        if _general(name) is not None:
            x = _to_port_layout(name, x)
        elif path[-1] == "kernel":
            x = x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T
        out[name] = x
    return out


def _stat_entries(stats: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's buffer entries for a flax ``batch_stats`` tree."""
    return {".".join([p for key in path[:-1] for p in _port_key(key)]
                     + [_STAT_NAMES[path[-1]]]): np.asarray(leaf)
            for path, leaf in _tree_leaves(stats)}


def flax_layout(name: str, weight: torch.Tensor,
                n_heads: int) -> torch.Tensor:
    """The flax-layout view of one port matrix (the inverse of the
    transposes above): qkv (3·H·hd, d) -> (d, 3, H, hd), a
    cross-attention's q (H·hd, d) -> (d, H, hd) and kv (2·H·hd, d) ->
    (d, 2, H, hd); out, up, down and the untied head (out, in) -> (in,
    out); embeddings as they are."""
    general = _general(name)
    if general is not None and general[1] == "weight":
        groups = general[0]
        rows, d = weight.shape
        lead = (groups,) if groups > 1 else ()
        return weight.T.reshape(d, *lead, n_heads,
                                rows // (groups * n_heads))
    if _is_dense(name):
        return weight.T
    return weight


def flax_weights(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The flax-layout view of every full-precision matrix (parameter of
    ndim >= 2) of a port ``TransformerLM`` (or ``Seq2SeqTransformer``):
    the Dense weights and the embedding tables -- the leaves JAX
    ``quantize_params`` quantizes -- keyed by the port's state-dict
    names."""
    return {name: flax_layout(name, p.detach(), model.cfg.n_heads)
            for name, p in model.named_parameters()
            if p.ndim >= 2 and not _is_lora(name)}


def load_flax_params(model: torch.nn.Module,
                     params: Mapping[str, Any]) -> torch.nn.Module:
    """Fill ``model`` (a port ``TransformerLM``, ``TransformerEncoder``,
    ``BertClassifier``, ``ViTClassifier``, ``MNISTNet``, ``ResNet``,
    ``MoeTransformerLM`` or ``Seq2SeqTransformer``)
    from a flax param tree or flax variables, in place, each value cast
    to its parameter's or buffer's dtype; every parameter and buffer
    must be covered and every leaf used (strict): a model with running
    statistics needs the variables' ``batch_stats``. Returns the
    model."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in flax_state_dict(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def load_flax_quantized(model: torch.nn.Module,
                        params: Mapping[str, Any]) -> torch.nn.Module:
    """Fill ``model`` from a tree quantized by the JAX package's
    ``quantize_params`` (unrolled layers), in place. Its quantized leaves
    (read as numpy ``q``/``scale`` and their bits, group size, shape and
    dtype) become the model's quantized weights as they are, codes in
    the flax layout; every other leaf loads as :func:`load_flax_params`
    loads it. Returns the model."""
    plain, quantized = {}, {}
    dev = model.device
    for name, leaf in _flax_leaves(params):
        if _is_quantized_leaf(leaf):
            quantized[name] = QTensor(
                torch.from_numpy(np.array(leaf.q, dtype=np.int8)),
                torch.from_numpy(np.array(leaf.scale, dtype=np.float32)),
                int(leaf.bits), leaf.group_size, tuple(leaf.shape),
                _TORCH_DTYPES[np.dtype(leaf.dtype).name]).to(dev)
        else:
            plain[name] = torch.from_numpy(np.array(
                _to_port_layout(name, np.asarray(leaf)), dtype=np.float32)
            ).to(model.cfg.param_dtype)
    model.load_quantized(quantized)
    model.load_state_dict(plain, strict=True)
    return model


def adapter_to_numpy(adapter: Mapping[str, Any]) -> Dict[str, Any]:
    """An adapter tree (``models/lora.py:extract_adapter``) with every
    leaf as a float32 numpy array on the host: what the JAX package's
    ``install_adapter`` takes."""
    if isinstance(adapter, Mapping):
        return {k: adapter_to_numpy(v) for k, v in adapter.items()}
    if isinstance(adapter, torch.Tensor):
        return adapter.detach().float().cpu().numpy()
    return np.array(adapter, dtype=np.float32)
