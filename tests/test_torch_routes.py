"""Which kernel takes a call: the wrappers' route functions, on the CPU.

The port's K5 (``models/quantized_matmul.py``) and K2-K4
(``ops/cuda_flash.py``) each have more than one CUDA kernel, and the
wrapper -- not the C side -- decides which one runs: ``_route``,
``_fwd_route`` and ``_bwd_route`` are pure functions of shapes,
dtypes, addresses and strides, so the decision is tested here without a
card. The C side
launches the route it is given or refuses, and names its routes in its
numbering for the wrapper to check when it loads the library;
``tests/test_torch_cuda.py`` checks on the card that each call was
counted on its route.
"""
import types

import pytest
import torch

from ray_lightning_tpu_torch import _build
from ray_lightning_tpu_torch.models import quantized_matmul as qmm
from ray_lightning_tpu_torch.models.quant import quantize_params
from ray_lightning_tpu_torch.ops import cuda_flash as cf

pytestmark = [pytest.mark.torch_port]

BF16, F32 = torch.bfloat16, torch.float32

# GPT-2-small's projections as (N, K, transpose): qkv, out, up, down, head
GPT2_SMALL = {"qkv": (2304, 768, False), "out": (768, 768, False),
              "up": (3072, 768, False), "down": (768, 3072, False),
              "head": (50257, 768, True)}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("proj", list(GPT2_SMALL))
def test_decode_step_takes_the_gemvs(proj, bits):
    """A decode step (8 slots, M = 8): every projection on a GEMV, in
    bf16 and f32 alike."""
    N, K, transpose = GPT2_SMALL[proj]
    want = "gemv_attend" if transpose else "gemv_dense"
    for dtype in (BF16, F32):
        assert qmm._route(8, N, K, bits, transpose, dtype) == want


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("proj", list(GPT2_SMALL))
def test_prefill_takes_the_tensor_cores_in_bf16(proj, bits):
    """A prefill dispatch (8 x 128 tokens, M = 1024): bf16 x on the
    tensor cores, f32 x (the parity path) on the CUDA-core tiled kernel."""
    N, K, transpose = GPT2_SMALL[proj]
    assert qmm._route(1024, N, K, bits, transpose, BF16) == "tc"
    assert qmm._route(1024, N, K, bits, transpose, F32) == "tiled_f32"


@pytest.mark.parametrize("M,N,K,bits,transpose,gemv", [
    (16, 768, 768, 8, False, "gemv_dense"),     # the last M a GEMV takes
    (17, 768, 768, 8, False, None),             # one row more: not a GEMV
    (8, 772, 768, 8, False, "gemv_dense"),      # N % 4 == 0
    (8, 770, 768, 8, False, None),              # N % 4 == 2
    (8, 257, 200, 8, False, None),              # odd N
    (8, 257, 772, 8, True, "gemv_attend"),      # int8: K % 4 == 0
    (7, 257, 770, 8, True, None),               # int8: K % 4 == 2
    (7, 257, 1100, 4, True, None),              # int4: K % 8 == 4
    (7, 257, 1104, 4, True, "gemv_attend"),     # int4: K % 8 == 0
    (1, 50257, 768, 8, True, "gemv_attend"),
    (100, 50257, 768, 4, True, None),
])
def test_gemv_edges_and_the_rest(M, N, K, bits, transpose, gemv):
    """The GEMVs take M <= 16 where their 32-bit code loads align; every
    other call goes to the tensor cores in bf16 and to the tiled kernel in
    f32 -- nothing else, and nothing refused."""
    for dtype, rest in ((BF16, "tc"), (F32, "tiled_f32")):
        assert qmm._route(M, N, K, bits, transpose, dtype) == (gemv or rest)


# each wrapper: its module, the C function naming the library's routes in
# its numbering, and the wrapper's own numbering
WRAPPERS = {"quantized_matmul": (qmm, "quantized_matmul_route_names",
                                 qmm.ROUTES),
            "flash_attention": (cf, "flash_fwd_route_names", cf.FWD_ROUTES),
            "flash_attention_bwd": (cf, "flash_bwd_route_names",
                                    cf.BWD_ROUTES)}


@pytest.mark.parametrize("which", list(WRAPPERS))
def test_routes_name_the_c_sides_numbering(which, monkeypatch):
    """A wrapper passes a route as its index in its own tuple; it loads a
    library whose route names come in that order and refuses one that
    numbers them otherwise (the module's other route lists numbered
    right)."""
    module, symbol, routes = WRAPPERS[which]

    def library(wrong):
        names = {sym: r[::-1] if wrong and sym == symbol else r
                 for mod, sym, r in WRAPPERS.values() if mod is module}
        return types.SimpleNamespace(
            **{sym: (lambda n=n: ",".join(n).encode())
               for sym, n in names.items()})

    _build.check_routes(library(False), symbol, routes)
    monkeypatch.setattr(module, "_lib", None)
    monkeypatch.setattr(_build, "load", lambda name: library(True))
    with pytest.raises(RuntimeError, match="numbers its routes"):
        module._library()


def test_cpu_calls_launch_nothing():
    """CPU tensors take the plain version: no launch, no route counted."""
    qt = quantize_params({"w": torch.randn(64, 96)}, "int8")["w"]
    qmm.reset_kernel_launches()
    qmm.quantized_matmul(torch.randn(40, 64).to(BF16), qt)
    assert qmm.kernel_launches() == 0
    assert set(qmm.route_launches().values()) == {0}
    cf.reset_kernel_launches()
    q = torch.randn(1, 16, 2, 32).to(BF16)
    out, lse = cf.flash_fwd(q, q, q, True)
    delta = cf.flash_delta(out, q)
    cf.flash_bwd_dkv(q, q, q, q, lse, delta, True)
    cf.flash_bwd_dq(q, q, q, q, lse, delta, True)
    assert cf.route_launches() == {"simt": 0, "tc": 0}
    for name in cf.KERNELS:
        assert cf.route_launches(name) == {"simt": 0, "tc": 0}


def _fused(B, T, H, D, dtype, pad=0, offset=0):
    """q, k, v as views of one fused (B, T, 3, H, D + pad) projection,
    starting ``offset`` elements into each head's row."""
    qkv = torch.zeros(B, T, 3, H, D + pad, dtype=dtype)
    return tuple(qkv[:, :, i, :, offset:offset + D] for i in range(3))


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_fused_qkv_views_take_the_tensor_cores(D):
    """The training path's q, k, v: views of one fused qkv projection,
    16-byte aligned with strides in multiples of 8 elements."""
    q, k, v = _fused(2, 100, 12, D, BF16)
    assert q.stride() == (100 * 36 * D, 36 * D, D, 1)
    assert cf._fwd_route(q, k, v) == "tc"
    assert cf._fwd_route(*(x.float() for x in (q, k, v))) == "simt"


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_backward_takes_the_tensor_cores_in_bf16(D):
    """The training path's backward: the fused views and autograd's
    contiguous dO go to the tensor-core dK/dV and dQ kernels; f32 to the
    CUDA-core ones."""
    q, k, v = _fused(2, 100, 12, D, BF16)
    do = torch.zeros(2, 100, 12, D, dtype=BF16)
    assert cf._bwd_route(q, k, v, do) == "tc"
    assert cf._bwd_route(*(x.float() for x in (q, k, v, do))) == "simt"


@pytest.mark.parametrize("pad,offset", [(1, 1), (2, 0), (8, 4), (4, 1)])
def test_flash_misaligned_views_take_the_simt_route(pad, offset):
    """Rows that do not start on 16-byte boundaries, or strides that are
    not multiples of 8 elements, go (counted) to the CUDA-core kernel."""
    q, k, v = _fused(2, 100, 3, 64, BF16, pad, offset)
    assert cf._fwd_route(q, k, v) == "simt"


def test_flash_one_misaligned_operand_is_enough():
    q, k, v = _fused(2, 64, 3, 64, BF16)
    odd = torch.zeros(2, 64, 3, 65, dtype=BF16)[..., 1:]
    assert cf._fwd_route(q, k, v) == "tc"
    for args in ((odd, k, v), (q, odd, v), (q, k, odd)):
        assert cf._fwd_route(*args) == "simt"


@pytest.mark.parametrize("pad,offset", [(1, 1), (2, 0), (8, 4), (4, 1)])
def test_flash_misaligned_do_takes_the_simt_backward(pad, offset):
    """Aligned q, k, v with a dO whose rows do not allow 16-byte copies:
    the backward goes (counted) to the CUDA-core kernels; the forward,
    which never reads dO, stays on the tensor cores."""
    q, k, v = _fused(2, 64, 3, 64, BF16)
    do = torch.zeros(2, 64, 3, 64 + pad, dtype=BF16)[..., offset:offset + 64]
    assert cf._fwd_route(q, k, v) == "tc"
    assert cf._bwd_route(q, k, v, do) == "simt"
