"""The port's flash attention (``ray_lightning_tpu_torch/ops``) against the JAX package.

The same numpy q/k/v/dO (made with a seeded ``np.random.default_rng``) go
through the JAX function and its counterpart, in f32 on the CPU:

- the plain versions of the CUDA kernels K2-K4 (``flash_fwd_reference``,
  ``flash_bwd_reference``) against the Pallas kernels run in interpret
  mode (``_flash_fwd_impl``/``_flash_bwd_impl(..., interpret=True)``):
  out, lse, dq, dk and dv at atol 1e-5 (f32 sums in another order);
- ``_Flash`` on CPU tensors (autograd through the plain versions) against
  ``jax.grad`` of ``pallas_flash_attention(..., interpret=True)``;
- the blockwise ``use_kernel=False`` path against the JAX XLA path
  (``flash_attention(use_pallas=False)``), output and gradients;
- a mask falls back to ``dot_product_attention``.

The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.ops.attention import \
    dot_product_attention as jax_dot_product_attention
from ray_lightning_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from ray_lightning_tpu.ops.pallas_flash import (_flash_bwd_impl,
                                                _flash_fwd_impl,
                                                pallas_flash_attention)
from ray_lightning_tpu_torch.ops import cuda_flash as cf
from ray_lightning_tpu_torch.ops.attention import dot_product_attention
from ray_lightning_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

ATOL = 1e-5
# (T, S, block) of tests/test_attention.py's Pallas cases, plus an
# end-aligned causal T > S whose first T - S rows admit no key
PALLAS_SHAPES = [(64, 64, 32), (96, 96, 64), (96, 48, 64), (64, 32, 32)]


def _inputs(T, S, B=2, H=4, D=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, H, D), dtype=np.float32)
    v = rng.standard_normal((B, S, H, D), dtype=np.float32)
    do = rng.standard_normal((B, T, H, D), dtype=np.float32)
    return q, k, v, do


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,S,block", PALLAS_SHAPES,
                         ids=lambda x: str(x))
def test_plain_versions_match_pallas_interpret(causal, T, S, block):
    q, k, v, do = _inputs(T, S)
    jout, jlse = _flash_fwd_impl(q, k, v, causal, block, block, True)
    jlse_t = np.array(jlse)[:, :, :T, 0]               # (B, H, T)
    out, lse = cf.flash_fwd_reference(*map(torch.from_numpy, (q, k, v)),
                                      causal)
    _close(out, jout, "out")
    _close(lse, jlse_t, "lse")
    # the backward on the same inputs: JAX's out and lse
    jdq, jdk, jdv = _flash_bwd_impl(q, k, v, jout, jlse, do, causal, block,
                                    block, True)
    dq, dk, dv = cf.flash_bwd_reference(
        *map(torch.from_numpy, (q, k, v, np.array(jout), jlse_t, do)),
        causal)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        _close(got, want, name)
    if causal and T > S:
        assert np.all(np.asarray(jout)[:, :T - S] == 0)
        assert torch.count_nonzero(out[:, :T - S]) == 0
        assert bool((lse[:, :, :T - S] == 1e30).all())
        assert torch.count_nonzero(dq[:, :T - S]) == 0


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,S,block", PALLAS_SHAPES[1:3],
                         ids=lambda x: str(x))
def test_flash_autograd_matches_jax_custom_vjp(causal, T, S, block):
    """``_Flash`` on CPU tensors against ``jax.grad`` through the Pallas
    ``custom_vjp`` (interpret mode)."""
    q, k, v, do = _inputs(T, S, seed=1)

    def f(q, k, v):
        return jnp.sum(pallas_flash_attention(
            q, k, v, causal=causal, block_q=block, block_k=block,
            interpret=True) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    launches = cf.kernel_launches()
    out = flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(do)).sum().backward()
    assert cf.kernel_launches() == launches      # CPU: no kernel launch
    for name, got, w in zip("qkv", (tq, tk, tv), want):
        _close(got.grad, w, f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,S,block", [(64, 64, 16), (48, 80, 32),
                                       (100, 100, 64), (64, 40, 16)],
                         ids=lambda x: str(x))
def test_blockwise_path_matches_jax_xla_path(causal, T, S, block):
    """``use_kernel=False`` (blockwise online softmax, autograd) against
    ``flash_attention(use_pallas=False)``: output and gradients."""
    q, k, v, do = _inputs(T, S, H=2, D=16, seed=2)

    def f(q, k, v):
        return jax_flash_attention(q, k, v, causal=causal, block_q=block,
                                   block_k=block, use_pallas=False)

    jout, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, block_q=block,
                          block_k=block, use_kernel=False)
    _close(out, jout, "out")
    out.backward(torch.from_numpy(do))
    for name, got, w in zip("qkv", (tq, tk, tv), vjp(do)):
        _close(got.grad, w, f"d{name}")


def test_blockwise_path_matches_the_plain_versions():
    """The two plain routes agree: blockwise loop and dense softmax."""
    q, k, v, _ = map(torch.from_numpy, _inputs(100, 100, seed=3))
    a = flash_attention(q, k, v, causal=True, block_q=32, block_k=48,
                        use_kernel=False)
    b = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_mask_falls_back_to_dot_product_attention():
    q, k, v, _ = _inputs(32, 32, seed=4)
    mask = np.where(np.random.default_rng(1).random((1, 1, 32, 32)) < 0.8,
                    0.0, np.finfo(np.float32).min).astype(np.float32)
    want = jax_dot_product_attention(q, k, v, mask=mask)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    got = flash_attention(tq, tk, tv, mask=tm)
    _close(got, want, "masked")
    torch.testing.assert_close(got, dot_product_attention(tq, tk, tv,
                                                          mask=tm))


def test_unported_and_misplaced_requests_raise():
    q, k, v, _ = map(torch.from_numpy, _inputs(8, 8))
    with pytest.raises(NotImplementedError, match="dropout"):
        flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, k, v, use_kernel=True)


def test_wrappers_take_the_plain_versions_on_cpu_without_counting():
    q, k, v, do = map(torch.from_numpy, _inputs(40, 24, seed=5))
    cf.reset_kernel_launches()
    out, lse = cf.flash_fwd(q, k, v, True)
    delta = cf.flash_delta(out, do)
    dk, dv = cf.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    dq = cf.flash_bwd_dq(q, k, v, do, lse, delta, True)
    assert cf.kernel_launches() == dict.fromkeys(cf.KERNELS, 0)
    ref = cf.flash_bwd_reference(q, k, v, out, lse, do, True)
    for got, want in zip((dq, dk, dv), ref):
        assert torch.equal(got, want)
    assert delta.shape == (2, 4, 40) and delta.is_contiguous()
