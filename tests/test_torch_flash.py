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
  (``flash_attention(use_pallas=False)``), output and gradients, in f32
  and in bf16;
- a mask falls back to ``dot_product_attention``;
- in bf16, the element-wise bounds the CUDA kernels are held to on the
  card: ``flash_out_bound`` (the forward) and ``flash_grad_bound`` (the
  backward) hold the Pallas kernels in interpret mode, and a gradient
  with one tile's contribution dropped falls outside the latter.

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
@pytest.mark.parametrize("T,S,block", PALLAS_SHAPES, ids=lambda x: str(x))
def test_bf16_out_within_the_element_wise_bound(causal, T, S, block):
    """bf16: the Pallas kernel (interpret mode) and the blockwise path
    round p against their running maximum, the plain version against the
    final one; out agrees within ``flash_out_bound`` (the bound the CUDA
    kernels are held to on the card), lse to 1e-5."""
    q, k, v, _ = _inputs(T, S, seed=6)
    jout, jlse = _flash_fwd_impl(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)), causal,
        block, block, True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out, lse = cf.flash_fwd_reference(tq, tk, tv, causal)
    bound = cf.flash_out_bound(tq, tk, tv, causal, out)
    blockwise = flash_attention(tq, tk, tv, causal=causal, block_q=block,
                                block_k=block, use_kernel=False)
    for got in (torch.from_numpy(np.array(jout.astype(jnp.float32))),
                blockwise.float()):
        assert bool(((got - out.float()).abs() <= bound).all())
    _close(lse, np.array(jlse)[:, :, :T, 0], "lse")


def _bf16_backward(T, S, causal, block, seed=7):
    """bf16 q, k, v, dO through the Pallas forward and backward (interpret
    mode); returns the torch inputs, the Pallas gradients as f32 tensors,
    and the plain versions' gradients on the same lse and delta (delta as
    ``_flash_bwd_impl`` computes it)."""
    q, k, v, do = (jnp.asarray(x).astype(jnp.bfloat16)
                   for x in _inputs(T, S, seed=seed))
    jout, jlse = _flash_fwd_impl(q, k, v, causal, block, block, True)
    grads = _flash_bwd_impl(q, k, v, jout, jlse, do, causal, block, block,
                            True)
    delta = jnp.sum(do.astype(jnp.float32) * jout.astype(jnp.float32),
                    axis=-1).transpose(0, 2, 1)

    def t(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32)))

    tq, tk, tv, tdo = (t(x).to(torch.bfloat16) for x in (q, k, v, do))
    lse = torch.from_numpy(np.array(jlse)[:, :, :T, 0])
    delta = torch.from_numpy(np.array(delta))
    rdk, rdv = cf.flash_bwd_dkv_reference(tq, tk, tv, tdo, lse, delta, causal)
    rdq = cf.flash_bwd_dq_reference(tq, tk, tv, tdo, lse, delta, causal)
    return ((tq, tk, tv, tdo, lse, delta), [t(g) for g in grads],
            (rdq, rdk, rdv))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,S,block", PALLAS_SHAPES, ids=lambda x: str(x))
def test_bf16_grads_within_the_element_wise_bound(causal, T, S, block):
    """bf16: ``_flash_dkv_kernel`` and ``_flash_dq_kernel`` (interpret
    mode) keep the rounding points ``flash_grad_bound`` is derived from;
    their dq, dk and dv agree with the plain versions on the same lse and
    delta within it, element by element."""
    args, pallas, refs = _bf16_backward(T, S, causal, block)
    bounds = cf.flash_grad_bound(*args, causal, *refs)
    for name, got, ref, bound in zip(("dq", "dk", "dv"), pallas, refs,
                                     bounds):
        assert got.shape == ref.shape == bound.shape, name
        assert bool(((got - ref.float()).abs() <= bound).all()), name


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,S,block", PALLAS_SHAPES, ids=lambda x: str(x))
def test_bf16_blockwise_dv_within_the_element_wise_bound(causal, T, S,
                                                         block):
    """The blockwise path differentiated by autograd in bf16: its dv
    (p rounded once in the forward's P.V, the transposed product summed)
    stays within ``flash_grad_bound``. Its dq and dk are not held to it:
    autograd rounds dP to bf16 before ds = p (dP - delta), a rounding
    point the Pallas kernels do not have, whose cancellation the bound
    does not cover."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(T, S, seed=7))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves, causal=causal, block_q=block, block_k=block,
                    use_kernel=False).backward(do)
    out, lse = cf.flash_fwd_reference(q, k, v, causal)
    delta = cf.flash_delta(out, do)
    refs = cf.flash_bwd_reference(q, k, v, out, lse, do, causal)
    bound = cf.flash_grad_bound(q, k, v, do, lse, delta, causal, *refs)[2]
    assert bool(((leaves[2].grad.float() - refs[2].float()).abs()
                 <= bound).all())


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_grad_bound_catches_a_dropped_tile(causal):
    """A backward that misses one tile -- q rows [32, 64) in dK/dV, keys
    [32, 64) in dQ -- falls outside ``flash_grad_bound``."""
    T = S = 96
    args, _, refs = _bf16_backward(T, S, causal, 32)
    q, k, v, do, lse, delta = args
    p, ds = cf._recomputed_p_ds(q, k, v, do, lse, delta, causal)
    scale = q.shape[-1] ** -0.5
    rows, keys = p.clone(), ds.clone()
    rows[:, :, 32:64], keys[:, :, :, 32:64] = 0.0, 0.0
    ds_rows = ds.clone()
    ds_rows[:, :, 32:64] = 0.0
    dropped = (
        torch.einsum("bhqk,bkhd->bqhd", keys.to(torch.bfloat16).float(),
                     k.float()) * scale,
        torch.einsum("bhqk,bqhd->bkhd", ds_rows.to(torch.bfloat16).float(),
                     q.float()) * scale,
        torch.einsum("bhqk,bqhd->bkhd", rows.to(torch.bfloat16).float(),
                     do.float()))
    bounds = cf.flash_grad_bound(*args, causal, *refs)
    for name, got, ref, bound in zip(("dq", "dk", "dv"), dropped, refs,
                                     bounds):
        got = got.to(torch.bfloat16).float()
        assert bool(((got - ref.float()).abs() > bound).any()), name


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


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,S,block", [(64, 64, 16), (48, 80, 32),
                                       (100, 100, 64), (64, 40, 16)],
                         ids=lambda x: str(x))
def test_bf16_blockwise_path_matches_jax_xla_path(causal, T, S, block):
    """The same inputs and shapes in bf16: ``use_kernel=False``
    differentiated by autograd against ``jax.vjp`` of
    ``flash_attention(use_pallas=False)``. Both round p to bf16 before
    P.V, and both round dP to bf16 before ds = p (dP - delta) -- the
    cotangent of a bf16 operand is bf16 in JAX as in torch -- so that
    rounding point is the reference's own. Bound: one bf16 rounding of the
    largest magnitude, 2**-7 max(1, max|jax|), for out, dq, dk and dv
    (f32 sums in another order can flip a rounding)."""
    q, k, v, do = _inputs(T, S, H=2, D=16, seed=2)

    def f(q, k, v):
        return jax_flash_attention(q, k, v, causal=causal, block_q=block,
                                   block_k=block, use_pallas=False)

    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    jout, vjp = jax.vjp(f, jq, jk, jv)
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
              for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, block_q=block,
                          block_k=block, use_kernel=False)
    out.backward(torch.from_numpy(do).to(torch.bfloat16))
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               (out, *(x.grad for x in leaves)),
                               (jout, *vjp(jdo))):
        assert got.dtype == torch.bfloat16, name
        want = np.asarray(want.astype(jnp.float32))
        bound = 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=0, atol=bound, err_msg=name)


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
    """Attention dropout is ported (T3): with a seed it takes the dense
    path, as the JAX function does, and without one (JAX: without a key)
    it drops nothing. A kernel demanded on CPU tensors raises."""
    q, k, v, _ = map(torch.from_numpy, _inputs(8, 8))
    torch.testing.assert_close(
        flash_attention(q, k, v, dropout_rate=0.1, dropout_rng=3),
        dot_product_attention(q, k, v, dropout_rate=0.1, dropout_rng=3),
        atol=0, rtol=0)
    torch.testing.assert_close(flash_attention(q, k, v, dropout_rate=0.1),
                               flash_attention(q, k, v), atol=0, rtol=0)
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
