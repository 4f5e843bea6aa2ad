"""The port's ``TransformerConfig`` takes every field of the JAX package's.

A JAX config's fields pass through by name: the layout knobs with no
counterpart (``scan_layers``, ``scan_unroll``, ``decode``) change
nothing, dtypes arrive as JAX spells them (``jnp.float32``), the JAX
``__post_init__`` checks raise its ``ValueError``s, a value the port
cannot honour yet raises ``NotImplementedError`` naming its ``ROADMAP.md``
item, and the values ported since (remat policies, the untied head, a
bf16 softmax) run the model as JAX does. Kernel names are the one translation: the JAX package's ``"xla"``
and ``"pallas"`` are the port's ``"torch"`` and ``"cuda"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.lora import LoraConfig
from ray_lightning_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from ray_lightning_tpu_torch.models import (TransformerConfig, TransformerLM,
                                            gpt2_config)

pytestmark = pytest.mark.torch_port

KERNEL_NAMES = {"xla": "torch", "pallas": "cuda"}


def _from_jax(jax_cfg):
    kw = {f.name: getattr(jax_cfg, f.name)
          for f in dataclasses.fields(jax_cfg)}
    for name in ("attention_kernel", "matmul_kernel"):
        kw[name] = KERNEL_NAMES[kw[name]]
    return TransformerConfig(**kw)


def test_every_jax_field_at_its_default_builds_the_port_default():
    jax_names = {f.name for f in dataclasses.fields(JaxTransformerConfig)}
    port_names = {f.name for f in dataclasses.fields(TransformerConfig)}
    assert jax_names <= port_names
    cfg = _from_jax(JaxTransformerConfig())
    assert cfg == TransformerConfig()
    assert (cfg.dtype, cfg.param_dtype, cfg.attention_softmax_dtype) == (
        torch.bfloat16, torch.float32, torch.float32)


def test_a_serving_config_of_the_jax_package_builds():
    """The nano serve family's layout knobs: the port model is the same
    with or without them."""
    cfg = gpt2_config("nano", scan_layers=False, decode=True, lora=None)
    assert (cfg.scan_layers, cfg.decode, cfg.lora) == (False, True, None)
    kw = dict(vocab_size=128, max_seq_len=32, d_model=128, n_heads=4,
              n_layers=2, d_ff=512)
    ported = _from_jax(JaxTransformerConfig(
        scan_layers=False, decode=True, dtype=jnp.float32, **kw))
    assert ported.dtype == torch.float32
    a = TransformerLM(ported, device="cpu")
    b = TransformerLM(gpt2_config("nano", vocab_size=128, max_seq_len=32,
                                  dtype=torch.float32), device="cpu")
    assert [(n, p.shape) for n, p in a.named_parameters()] == [
        (n, p.shape) for n, p in b.named_parameters()]


@pytest.mark.parametrize("spelling", [torch.float32, jnp.float32,
                                      np.float32, np.dtype("float32"),
                                      "float32"])
def test_softmax_dtype_spellings(spelling):
    cfg = TransformerConfig(attention_softmax_dtype=spelling)
    assert cfg.attention_softmax_dtype is torch.float32
    assert hash(cfg) == hash(TransformerConfig())


@pytest.mark.parametrize("kw,item", [
    (dict(attention_impl="ring"), "item 9: multi-axis meshes"),
    (dict(attention_impl="ulysses"), "item 9: multi-axis meshes"),
], ids=["ring", "ulysses"])
def test_values_the_port_cannot_honour_name_their_item(kw, item):
    JaxTransformerConfig(**kw)      # the reference takes them
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md A, {item}"):
        TransformerConfig(**kw)


NANO = dict(vocab_size=128, max_seq_len=32, d_model=128, n_heads=4,
            n_layers=2, d_ff=512, dtype=jnp.float32, scan_layers=False)


@pytest.mark.parametrize("kw", [
    dict(remat=True, remat_policy="dots"),
    dict(tie_embeddings=False),
    dict(attention_softmax_dtype=jnp.bfloat16),
    dict(attention_softmax_dtype=torch.bfloat16),
    dict(lora=LoraConfig(rank=4, num_adapters=2)),
    dict(num_segments=2),
], ids=["remat_policy", "untied", "softmax-bf16-jnp", "softmax-bf16-torch",
        "lora", "segments"])
def test_values_earlier_slices_refused_now_build_and_run_as_jax(kw):
    """The values the port refused before T3, item 8 and S4 build, and the
    model's forward equals JAX's: to 1e-5, or with a bf16 softmax no
    farther from JAX's than JAX's bf16-softmax logits are from its
    f32-softmax ones. A LoRA model's banks are filled with noise first,
    so the forward (every row on bank slot 0) runs through them.
    ``num_segments`` sizes the encoder's segment table and leaves the LM
    as it is, in both packages."""
    from ray_lightning_tpu.models.transformer import \
        TransformerLM as JaxTransformerLM
    from ray_lightning_tpu_torch.interop import load_flax_params
    jkw = {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
           for k, v in kw.items()}
    jcfg = JaxTransformerConfig(**NANO, **jkw)
    cfg = _from_jax(jcfg)
    assert all(getattr(cfg, k) == getattr(TransformerConfig(**NANO, **kw), k)
               for k in kw)
    tokens = np.random.default_rng(0).integers(0, 128, (2, 16)).astype(
        np.int32)
    params = JaxTransformerLM(jcfg).init(jax.random.PRNGKey(0),
                                         tokens)["params"]
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (0.1 * noise.standard_normal(v.shape)).astype(
            np.float32) if "lora_" in jax.tree_util.keystr(path) else v,
        params)
    want = np.asarray(JaxTransformerLM(jcfg).apply({"params": params},
                                                   tokens))
    model = load_flax_params(TransformerLM(cfg, device="cpu"), params)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    bound = 1e-5
    if cfg.attention_softmax_dtype != torch.float32:
        f32 = dataclasses.replace(jcfg, attention_softmax_dtype=jnp.float32)
        bound = np.abs(want - np.asarray(JaxTransformerLM(f32).apply(
            {"params": params}, tokens))).max()
    assert np.abs(got - want).max() <= bound


@pytest.mark.parametrize("kw,match", [
    (dict(scan_unroll=0), "scan_unroll must be >= 1"),
    (dict(scan_unroll=2, scan_layers=False), "scan_layers=False"),
    (dict(remat_policy="dots"), "remat=False"),
    (dict(remat=True, remat_policy="bogus"), "remat_policy must be one of"),
], ids=["unroll-0", "unroll-unscanned", "policy-no-remat", "policy-bogus"])
def test_the_jax_post_init_checks_raise_its_value_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        JaxTransformerConfig(**kw)
    with pytest.raises(ValueError, match=match):
        TransformerConfig(**kw)
