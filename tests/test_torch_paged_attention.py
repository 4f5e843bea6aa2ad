"""The port's paged attention (``ray_lightning_tpu_torch/models/paged_attention.py``).

The plain version is held against the JAX package's Pallas kernel (in
interpret mode, as the JAX suite runs it on the CPU) and against the
XLA read side of ``_page_native_attention``, on the same numpy inputs:
f32 and int8 pages, T=1 (decode) and T=4 (verify), unmapped (−1)
page-table entries, and a row whose positions are all −1 (every key
masked: it must emit 0). f32 tolerance 1e-5: the two sides differ only
in summation order. The CUDA kernel itself is held against the plain
version on the card (``tests/test_torch_cuda.py``, skipped without one;
``chip_smoke.py`` does the same at serving shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.pallas_attention import \
    paged_attention as jax_paged_attention
from ray_lightning_tpu.models.quant import kv_quantize as jax_kv_quantize
from ray_lightning_tpu.models.quant import kv_scales as jax_kv_scales
from ray_lightning_tpu_torch.models import paged_attention as pa
from ray_lightning_tpu_torch.models.quant import (kv_dequantize,
                                                  kv_quantize, kv_scales)
from test_pallas_attention import _xla_read_reference

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

B, H, D, P, PS, PP = 3, 4, 32, 10, 4, 8


def _inputs(T, quantized, seed=7):
    """numpy inputs: ragged rows, −1 page-table entries, row 2 with all
    positions −1 (nothing admitted)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, PS, H, D)).astype(np.float32)
    vp = rng.normal(size=(P, PS, H, D)).astype(np.float32)
    pt = np.full((B, PP), -1, np.int32)
    pt[0, :4] = [4, 1, 7, 3]
    pt[1, :2] = [0, 2]
    pos0 = np.array([12, 5, 0], np.int32)
    pos = np.stack([pos0 + t for t in range(T)], axis=1).astype(np.int32)
    pos[2] = -1
    ks = vs = None
    if quantized:
        ks = np.asarray(jax_kv_scales(jnp.asarray(kp), (1, 3)))
        vs = np.asarray(jax_kv_scales(jnp.asarray(vp), (1, 3)))
        kp = np.asarray(jax_kv_quantize(jnp.asarray(kp), ks))
        vp = np.asarray(jax_kv_quantize(jnp.asarray(vp), vs))
    return q, kp, vp, ks, vs, pos, pt


def _torch(args):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in args]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


CASES = pytest.mark.parametrize(
    "T,quantized", [(1, False), (4, False), (1, True), (4, True)],
    ids=["f32-decode", "f32-verify", "int8-decode", "int8-verify"])


@CASES
def test_plain_matches_pallas_interpret(T, quantized):
    args = _inputs(T, quantized)
    ref = np.asarray(jax_paged_attention(*_jax(args), interpret=True))
    out = pa.paged_attention_reference(*_torch(args)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@CASES
def test_plain_matches_xla_read_side(T, quantized):
    args = _inputs(T, quantized)
    ref = np.asarray(_xla_read_reference(*_jax(args)))
    out = pa.paged_attention_reference(*_torch(args)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@CASES
def test_all_masked_row_emits_zero(T, quantized):
    out = pa.paged_attention_reference(*_torch(_inputs(T, quantized)))
    assert torch.count_nonzero(out[2]) == 0
    assert torch.count_nonzero(out[0]) > 0


def test_kv_quant_helpers_match_jax():
    """Round-half-to-even codes, guarded zero groups, dequant in f32
    then cast: byte-equal to the JAX helpers."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 4, 3, 8)).astype(np.float32)
    x[1] = 0.0                          # an all-zero page: scale 1, codes 0
    x[2, 0, 0, :2] = [0.5, -2.5]        # exact .5 ties after scaling
    s = kv_scales(torch.from_numpy(x), (1, 3))
    s_j = np.asarray(jax_kv_scales(jnp.asarray(x), (1, 3)))
    np.testing.assert_array_equal(s.numpy(), s_j)
    half = np.float32(127.0) * np.array([0.5, 1.5, 2.5, -0.5], np.float32)
    ties = np.full((1, 4, 1, 1), 127.0, np.float32)
    codes = kv_quantize(torch.from_numpy(half.reshape(1, 4, 1, 1) / 127.0),
                        torch.from_numpy(ties) / 127.0)
    codes_j = jax_kv_quantize(jnp.asarray(half.reshape(1, 4, 1, 1) / 127.0),
                              jnp.asarray(ties) / 127.0)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    q = kv_quantize(torch.from_numpy(x), s)
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jax_kv_quantize(jnp.asarray(x), s_j)))
    back = kv_dequantize(q, s, torch.float32)
    assert torch.all(back[1] == 0)


def test_wrapper_takes_plain_version_on_cpu():
    """CPU tensors go to the plain version, and that is no launch."""
    args = _torch(_inputs(4, True))
    pa.reset_kernel_launches()
    out = pa.paged_attention(*args)
    assert torch.equal(out, pa.paged_attention_reference(*args))
    assert pa.kernel_launches() == 0


def test_wrapper_refuses_other_devices():
    q, kp, vp, ks, vs, pos, pt = _torch(_inputs(1, False))
    with pytest.raises(ValueError, match="cpu or cuda"):
        pa.paged_attention(q.to("meta"), kp.to("meta"), vp.to("meta"),
                           None, None, pos.to("meta"), pt.to("meta"))
    with pytest.raises(ValueError, match="span devices"):
        pa.paged_attention(q.to("meta"), kp, vp, None, None, pos, pt)


@pytest.mark.parametrize("what", [
    "q_dtype", "head_dim", "T", "page_dtype", "scales_missing",
    "scales_shape", "scales_given", "positions_dtype", "table_dtype",
    "shared_memory"])
def test_kernel_input_checks(what):
    """What the kernel does not take is refused before any launch."""
    q, kp, vp, ks, vs, pos, pt = _torch(_inputs(1, False))
    qi, kpi, vpi, ksi, vsi, _, _ = _torch(_inputs(1, True))
    args = dict(q=q, k_pages=kp, v_pages=vp, k_scales=None, v_scales=None,
                kv_positions=pos, page_table=pt)
    if what == "q_dtype":
        args["q"] = q.double()
    elif what == "head_dim":
        args.update(q=q[..., :16], k_pages=kp[..., :16],
                    v_pages=vp[..., :16])
    elif what == "T":
        args.update(q=q.expand(B, 9, H, D),
                    kv_positions=pos.expand(B, 9))
    elif what == "page_dtype":
        args.update(k_pages=kp.bfloat16(), v_pages=vp.bfloat16())
    elif what == "scales_missing":
        args.update(k_pages=kpi, v_pages=vpi)
    elif what == "scales_shape":
        args.update(k_pages=kpi, v_pages=vpi, k_scales=ksi[:, :, :2],
                    v_scales=vsi)
    elif what == "scales_given":
        args.update(k_scales=ksi, v_scales=vsi)
    elif what == "positions_dtype":
        args["kv_positions"] = pos.long()
    elif what == "table_dtype":
        args["page_table"] = pt.long()
    elif what == "shared_memory":
        # T = 8 queries over 16384 pages of 4 keys: a block of a cluster of
        # 8 holds 8 x 8192 f32 scores, over the 227 KB it may use
        big = torch.zeros((1, 16384), dtype=torch.int32)
        args.update(q=q[:1].expand(1, 8, H, D).contiguous(),
                    kv_positions=torch.zeros((1, 8), dtype=torch.int32),
                    page_table=big)
    with pytest.raises(ValueError):
        pa._check(**args)


def test_kernel_input_checks_accept_the_serving_shapes():
    for quantized in (False, True):
        args = _torch(_inputs(4, quantized))
        assert pa._check(*args) is quantized


@pytest.mark.parametrize("S,cluster", [(16, 1), (127, 1), (128, 2),
                                       (255, 2), (256, 4), (511, 4),
                                       (512, 8), (1024, 8), (65536, 8)])
def test_cluster_size_follows_the_slot_length(S, cluster):
    """Blocks per (row, head): at least 64 keys a block over a full slot,
    at most the portable cluster of 8 (phase 1's S = 1024 takes 8)."""
    assert pa.cluster_size(S) == cluster


@pytest.mark.parametrize("T,D,ps", [(1, 64, 16), (8, 128, 16), (4, 32, 1)])
def test_kernel_input_checks_shared_memory_edge(T, D, ps):
    """The longest slot the wrapper admits: its scores per block (T x
    ceil(S / cluster) f32) and partial outputs fill at most the 227 KB a
    block may use, and one page more is refused."""
    def call(pp):
        q = torch.zeros(1, T, 2, D)
        pages = torch.zeros(2, ps, 2, D)
        pos = torch.zeros(1, T, dtype=torch.int32)
        return pa._check(q, pages, pages, None, None, pos,
                         torch.zeros(1, pp, dtype=torch.int32))

    def fits(pp):
        S = pp * ps
        return pa.smem_bytes(T, D, S, pp, pa.cluster_size(S),
                             4) <= pa._MAX_SMEM

    pp = 1
    while fits(pp + 1):
        pp += 1
    assert call(pp) is False
    with pytest.raises(ValueError, match="shared memory"):
        call(pp + 1)
    S = pp * ps
    kb = -(-S // pa.cluster_size(S))
    chunk = min(kb, 16384 // (4 * D))      # f32 rows of K (then V) staged
    # the K or V chunk, scores, the 4 warps' and up to 8 blocks' partial
    # outputs, 8 blocks' (max, sum) pairs and 4 warps' scratch for 8
    # queries, 8 positions
    assert pa.smem_bytes(T, D, S, pp, pa.cluster_size(S), 4) == 4 * (
        chunk * D + T * kb + (4 + 8) * T * D + 2 * 8 * 8 + 2 * 4 * 8
        + 8 + pp)
