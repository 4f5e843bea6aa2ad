"""The port's CUDA kernels on the card (skipped without one).

These tests import neither jax nor the JAX package, so they run where
only PyTorch is installed::

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Each kernel is held against its plain PyTorch version on the same
inputs. Paged attention: f32 to 1e-5 (only the order of the f32 sums
differs), bf16 to 2e-2 (both round the softmax weights and the output to
bf16 at the same points; a summation-order difference can flip one such
rounding, one bf16 ulp of an output below 4). Flash attention (K2-K4):
see :func:`flash_tol`. Fused dequant-matmul (K5): f32 to 1e-5 x max(1,
max|ref|), bf16 to one bf16 ulp of the largest magnitude, 2**-7 x max(1,
max|ref|) (the same rounded operands, f32 sums in another order).
Every bf16 kernel runs on the tensor cores and its f32 counterpart on
the CUDA cores; every test checks which route (``route_launches()``)
took the call. The decode kernels split their work over thread-block
clusters (paged attention: the keys of a (row, head); the dense GEMV: K):
they are held at cluster sizes 4 and 8, at GPT-2-small's projections and
M of 1 to 16, at the longest rows the wrapper admits, for bitwise
repeatability, for a launch geometry that fills the card, and for a CUDA
graph replay equal to the eager call. The trainer on the card:
checkpoints round-trip in both formats with the optimizer state back on
the card, nano GPT on the flash kernels resumes bitwise after a kill,
and the non-finite guard skips a poisoned batch. One process per card:
nano GPT fit by a spawned worker in an NCCL group of world size 1 under
each strategy, its flash kernels on the tensor cores in the worker; more
card workers than cards refused before any spawn; a worker that sees no
card raising instead of training on the CPU; ZeRO at world size 1 bitwise
the one-process fit under AdamW and both memory presets, adafactor under
FSDP2; and a checkpoint-sized stream (1.49 GB, GPT-2-small's) put by a
card worker into the session queue and read back on the driver.
Speculative decoding: the paged-attention kernel at a verify's T = 5, and
a nano spec engine whose greedy tokens equal the non-spec engine's in
f32, whose verify launches the kernel once per layer and round at T =
k+1, whose identical draft is always accepted, and whose quantized verify
runs K5 on the tensor cores and its draft's feeds on the GEMVs. The
dense KV layouts (the slot pool, the dense view): K5 routed by M as on
the page-native engine and no K1, a decode dispatch's launches as
``chip_smoke.py`` phase G records them, ``generate()`` with int8 weights
on the GEMVs and ``tc``, spec equal to non-spec in f32, and the
paged-attention kernel refused without ``page_native=True``. Async
dispatch: the pipelined client's tokens bitwise the sync client's on
every layout and with spec, bf16 and f32, and a steady-state enqueue
making no synchronizing call under ``set_sync_debug_mode("error")``.
Multi-LoRA: the bank's delta in f32 equal to ``F.linear`` by the merged
weight, and an adapted int8-weight engine routing K5 exactly as the
bankless engine does. Serving reliability: crash replay on the
page-native, chunked, spec and async int8-weight engines equal to the
fault-free run in f32 with the kernels on, each kernel launched by the
rebuilt engines, the card's allocated bytes equal after every rebuild;
armed telemetry adding no launch and no synchronizing call. The health
of a fit: ``StepStatsCallback(block=True)``'s step time covering the
step's CUDA-event time, the in-memory checkpoint tier holding only host
tensors after a fit on the card, and an armed fit (telemetry, step
stats, the profiler) launching exactly what a disarmed one does. The
input pipeline: the shared-memory ring's loader spawning its producers
once CUDA is live, with the in-process loader's batches, and
``DevicePrefetcher`` copying through pinned staging buffers on a side
stream, each batch equal on the host. The in-process replica fleet: a
2-replica fleet's tokens equal one client's in f32 with the kernels on,
and a replica killed mid-decode fails over with every token kept and the
card's allocated bytes back where they were. The process replica fleet
(one worker process per replica on the card): its f32 tokens equal one
client's, K1 launched inside the workers n_layers times a decode step;
and a device-side assert (a prompt id outside the vocab) in one worker
fails that request while the other worker, never stopped, serves its own
requests to the single client's tokens. The encoder family: K2-K4 at
BERT's and ViT-B/16's sequence lengths, BERT-tiny's f32 logits and
gradients through the kernels equal to the dense attention's, and a
ViT fit under its remat policy launching K2 twice a layer a step. The
MoE LM: K2-K4 at its attention shape (causal, H = 4, T = 128), a bf16
MoE-small step launching each once a layer on ``tc``, the f32 step
against the CPU under the near-tie routing rule, a fit's launches, and
greedy decode equal to the CPU's. The encoder-decoder: K2-K4 at the
reversal gate's shape (D = 32, T = 8), the f32 step with a padded source
against the CPU (the all-padding row's cross-attention exactly 0), and a
bf16 remat fit's exact launches, split by mask.
``chip_smoke.py`` repeats this at the serving and training paths' full
shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (FSDPStrategy, GPTModule,
                                     HorovodRayStrategy, RayShardedStrategy,
                                     RayStrategy, Trainer)
from ray_lightning_tpu_torch.core import Callback
from ray_lightning_tpu_torch.launchers import (ExecutorBase, ProcessRay,
                                               RayLauncher)
from ray_lightning_tpu_torch.models import paged_attention as pa
from ray_lightning_tpu_torch.models import quantized_matmul as qmm
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.ops import cuda_flash as cf
from ray_lightning_tpu_torch.models.quant import (QTensor, kv_quantize,
                                                  kv_scales, quantize_params)
from ray_lightning_tpu_torch.serve import ServeClient

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dtype, quantized, T, D, ps, B=5, H=3, seed=0):
    """Ragged rows that own their pages through their last position,
    unmapped (−1) entries elsewhere, and a last row that admits nothing."""
    g = torch.Generator().manual_seed(seed)
    pp = max(6, 16 // ps)
    P = B * pp
    q = torch.randn(B, T, H, D, generator=g).to(dtype)
    kp = torch.randn(P, ps, H, D, generator=g)
    vp = torch.randn(P, ps, H, D, generator=g)
    ks = vs = None
    if quantized:
        ks, vs = kv_scales(kp, (1, 3)), kv_scales(vp, (1, 3))
        kp, vp = kv_quantize(kp, ks), kv_quantize(vp, vs)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    S = pp * ps
    start = np.linspace(0, S - T, B).astype(np.int32)
    pos = torch.from_numpy(start[:, None] + np.arange(T, dtype=np.int32))
    pos[-1] = -1
    pt = torch.full((B, pp), -1, dtype=torch.int32)
    perm = torch.randperm(P, generator=g).to(torch.int32)
    for b in range(B - 1):
        n = int(pos[b].max()) // ps + 1
        pt[b, :n] = perm[b * pp:b * pp + n]
    return q, kp, vp, ks, vs, pos, pt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("quantized", [False, True], ids=["same", "int8"])
@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("D,ps", [(32, 4), (64, 16), (128, 1)])
def test_kernel_matches_plain(cuda, dtype, quantized, T, D, ps):
    args = [None if a is None else a.to(cuda)
            for a in _inputs(dtype, quantized, T, D, ps)]
    before = pa.kernel_launches()
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.kernel_launches() == before + 1
    ref = pa.paged_attention_reference(*args)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.count_nonzero(out[-1]) == 0
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, kp, vp, ks, vs, pos, pt = [
        None if a is None else a.to(cuda)
        for a in _inputs(torch.float32, False, 1, 32, 4)]
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(torch.cat([q, q], dim=-1)[..., :32], kp, vp,
                           None, None, pos, pt)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q[..., :16].contiguous(),
                           kp[..., :16].contiguous(),
                           vp[..., :16].contiguous(), None, None, pos, pt)


def _cluster_inputs(dtype, quantized, T, D, ps, pp, B=6, H=3, seed=0):
    """Rows that split over a cluster of blocks: row 0 admits only its
    first T positions (one key for T=1), row 1 every position of the
    slot (the longest S), rows 2.. ragged, the last row nothing."""
    g = torch.Generator().manual_seed(seed)
    P = B * pp
    S = pp * ps
    q = torch.randn(B, T, H, D, generator=g).to(dtype)
    kp = torch.randn(P, ps, H, D, generator=g)
    vp = torch.randn(P, ps, H, D, generator=g)
    ks = vs = None
    if quantized:
        ks, vs = kv_scales(kp, (1, 3)), kv_scales(vp, (1, 3))
        kp, vp = kv_quantize(kp, ks), kv_quantize(vp, vs)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    start = np.linspace(0, S - T, B).astype(np.int32)
    start[0], start[1] = 0, S - T
    pos = torch.from_numpy(start[:, None] + np.arange(T, dtype=np.int32))
    pos[-1] = -1
    pt = torch.full((B, pp), -1, dtype=torch.int32)
    perm = torch.randperm(P, generator=g).to(torch.int32)
    for b in range(B - 1):
        n = int(pos[b].max()) // ps + 1
        pt[b, :n] = perm[b * pp:b * pp + n]
    return q, kp, vp, ks, vs, pos, pt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("quantized", [False, True], ids=["same", "int8"])
@pytest.mark.parametrize("T", [1, 4, 8])
@pytest.mark.parametrize("D,ps,pp", [(32, 16, 40), (64, 16, 64),
                                     (128, 8, 33)])
def test_kernel_clusters_match_plain(cuda, dtype, quantized, T, D, ps, pp):
    """Rows split over clusters of 4 or 8 blocks (S = 640, 1024, 264):
    one-key rows, full rows, ragged rows and an all-masked row, within the
    tolerance; a second call gives the same bits."""
    args = [None if a is None else a.to(cuda)
            for a in _cluster_inputs(dtype, quantized, T, D, ps, pp)]
    assert pa.cluster_size(ps * pp) in (4, 8)
    before = pa.kernel_launches()
    out = pa.paged_attention(*args)
    again = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.kernel_launches() == before + 2
    assert torch.equal(out, again)
    ref = pa.paged_attention_reference(*args)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.count_nonzero(out[-1]) == 0
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_at_the_longest_rows_it_admits(cuda, dtype):
    """T = 8, D = 128: the most pages per slot whose scores fit one
    block's shared memory (one page more is refused), with a row at its
    last position."""
    T, D, ps, H = 8, 128, 16, 1
    pp = 1
    while pa.smem_bytes(T, D, (pp + 1) * ps, pp + 1,
                        pa.cluster_size((pp + 1) * ps),
                        4 if dtype == torch.float32 else 2) <= pa._MAX_SMEM:
        pp += 1
    args = [None if a is None else a.to(cuda)
            for a in _cluster_inputs(dtype, False, T, D, ps, pp, B=3, H=H)]
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_attention_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)
    q, kp, vp, ks, vs, pos, pt = args
    wide = torch.full((3, pp + 1), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        pa.paged_attention(q, kp, vp, ks, vs, pos, wide)


def test_kernel_geometry_fills_the_card(cuda):
    """Phase 1's bf16 T=1 shape: clusters of 8 blocks, every cluster of
    the grid resident at once."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    q = torch.zeros(8, 1, 12, 64, dtype=torch.bfloat16, device=cuda)
    kp = torch.zeros(512, 16, 12, 64, dtype=torch.bfloat16, device=cuda)
    pt = torch.zeros(8, 64, dtype=torch.int32, device=cuda)
    geo = pa.launch_geometry(q, kp, pt)
    assert geo["cluster"] == 8 and geo["grid"] == 8 * 12 * 8
    assert geo["grid"] >= sms
    assert geo["max_active_clusters"] * 8 >= sms


def _graph_replays_equal_eager(fn):
    """Capture one call of ``fn`` in a CUDA graph; its replay equals the
    eager call bit for bit."""
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_kernel_replays_in_a_cuda_graph(cuda, quantized):
    args = [None if a is None else a.to(cuda)
            for a in _cluster_inputs(torch.bfloat16, quantized, 1, 64, 16,
                                     64)]
    _graph_replays_equal_eager(lambda: pa.paged_attention(*args))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_serving_runs_through_the_kernel(cuda, kv_dtype):
    """A small f32 engine on the card: the kernel launches once per layer
    per decode step, and its greedy tokens equal the plain path's."""
    cfg = gpt2_config("nano", vocab_size=128, max_seq_len=32,
                      dtype=torch.float32)
    torch.manual_seed(0)
    sd = TransformerLM(cfg, device="cpu").state_dict()
    trace = [(0, dict(prompt=[5, 17, 3, 9], max_new_tokens=6)),
             (0, dict(prompt=[9, 2, 44], max_new_tokens=6)),
             (3, dict(prompt=[42, 7], max_new_tokens=6))]
    out = {}
    for kernel in ("torch", "cuda"):
        pa.reset_kernel_launches()
        client = ServeClient(TransformerLM(cfg, device="meta"), sd,
                             num_slots=2, prefill_len=8, page_size=4,
                             page_native=True, kv_dtype=kv_dtype,
                             attention_kernel=kernel, device=cuda)
        out[kernel] = client.serve_trace(list(trace))
        launches = pa.kernel_launches()
        expect = (cfg.n_layers * client.engine.decode_substeps
                  if kernel == "cuda" else 0)
        assert launches == expect
    assert {r: c.tokens for r, c in out["cuda"].items()} == \
        {r: c.tokens for r, c in out["torch"].items()}


# ------------------------------------------------------- flash attention
def flash_tol(dtype, name: str, ref: torch.Tensor, grad: bool, q, k, v,
              causal: bool, grad_bounds=None):
    """Bound on |kernel - plain| for one output: a number, or a tensor of
    ref's shape bounding each element (``grad_bounds``: bf16 dq, dk, dv's,
    from ``cf.flash_grad_bound``).

    f32: the kernels sum in another order (tiles of 64, an online softmax
    whose running maximum rescales earlier tiles) -- 1e-5 for out and lse,
    1e-4 of the largest magnitude for a gradient summed over up to S or T
    terms. lse is f32 sums of exact products in both dtypes: 1e-5 (rows
    that admit no key are 1e30 in both, exactly). bf16 out, element by
    element: ``cf.flash_out_bound`` -- the kernel rounds the softmax
    weights to bf16 relative to its running maximum and the plain version
    relative to the final one, and each rounds out once. bf16 gradients,
    element by element: ``cf.flash_grad_bound`` -- p and ds are rounded
    to bf16 once before each product (a few f32 ulps apart in kernel and
    plain version, so a rounding may flip) and each output once."""
    if name == "lse":
        return 1e-5
    top = float(ref.float().abs().max())
    if dtype == torch.float32:
        return 1e-4 * max(top, 1e-30) if grad else 1e-5
    if name == "out":
        return cf.flash_out_bound(q, k, v, causal, ref)
    return grad_bounds[name]


def _grad_bounds(dtype, q, k, v, do, lse, delta, causal, ref_dq, ref_dk,
                 ref_dv):
    """bf16: ``cf.flash_grad_bound`` by gradient name; f32: None."""
    if dtype != torch.bfloat16:
        return None
    return dict(zip(("dq", "dk", "dv"), cf.flash_grad_bound(
        q, k, v, do, lse, delta, causal, ref_dq, ref_dk, ref_dv)))


def _assert_within(got, ref, tol, what):
    """|got - ref| <= tol, a number or an element-wise tensor."""
    d = (got.float() - ref.float()).abs()
    used = float(torch.where(d > 0, d / tol, 0.0).max())
    assert used <= 1.0, f"{what}: max error {float(d.max())}, {used} of " \
                        f"the bound"


def _flash_inputs(B, T, S, H, D, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    # q, k and v as views of one fused projection, the model's layout
    qkv = torch.randn(B, T, 3, H, D, generator=g)
    kv = torch.randn(B, S, 2, H, D, generator=g)
    do = torch.randn(B, T, H, D, generator=g)
    qkv, kv, do = (x.to(dtype).to(device) for x in (qkv, kv, do))
    return qkv[:, :, 0], kv[:, :, 0], kv[:, :, 1], do


# (T, S, D): square, ragged tails (T not a multiple of the 128-row or
# 64-key tiles), end-aligned T < S, and T > S, whose first causal rows
# admit no key; each head_dim the kernels take; and the encoders'
# sequences (BERT's 128, ViT-B/16's 197 = 196 patches + CLS, whose last
# tile is partial), run bidirectional ("full") on their main paths
FLASH_CASES = {"square": (64, 64, 64), "ragged": (100, 100, 32),
               "t<s": (96, 160, 128), "empty-rows": (80, 48, 64),
               "ragged-d64": (200, 200, 64), "ragged-d128": (130, 130, 128),
               "t<s-d32": (96, 160, 32), "t<s-d64": (100, 300, 64),
               "empty-rows-d128": (150, 64, 128),
               "empty-rows-d32": (200, 72, 32),
               "bert": (128, 128, 64), "vit": (197, 197, 64)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T,S,D", list(FLASH_CASES.values()),
                         ids=list(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, dtype, causal, T, S, D):
    q, k, v, do = _flash_inputs(2, T, S, 3, D, dtype, cuda)
    before = cf.kernel_launches()
    routes = {n: cf.route_launches(n) for n in cf.KERNELS}
    out, lse = cf.flash_fwd(q, k, v, causal)
    delta = cf.flash_delta(out, do)
    dk, dv = cf.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq = cf.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    after = cf.kernel_launches()
    assert all(after[n] == before[n] + 1 for n in cf.KERNELS)
    # bf16 views of one fused projection (and a contiguous dO) go to the
    # tensor cores, every kernel
    route = "tc" if dtype == torch.bfloat16 else "simt"
    for n in cf.KERNELS:
        routes[n][route] += 1
        assert cf.route_launches(n) == routes[n], n
    ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, causal)
    # the same inputs for both: the kernel's lse and delta
    ref_dk, ref_dv = cf.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                causal)
    ref_dq = cf.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    bounds = _grad_bounds(dtype, q, k, v, do, lse, delta, causal, ref_dq,
                          ref_dk, ref_dv)
    for name, got, ref, grad in (("out", out, ref_out, False),
                                 ("lse", lse, ref_lse, False),
                                 ("dq", dq, ref_dq, True),
                                 ("dk", dk, ref_dk, True),
                                 ("dv", dv, ref_dv, True)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert bool(torch.isfinite(got).all()), name
        _assert_within(got, ref,
                       flash_tol(dtype, name, ref, grad, q, k, v, causal,
                                 bounds),
                       name)
    if causal and T > S:
        # rows that admit no key: out 0, lse 1e30, no gradient
        empty = T - S
        assert torch.count_nonzero(out[:, :empty]) == 0
        assert bool((lse[:, :, :empty] == 1e30).all())
        assert torch.count_nonzero(dq[:, :empty]) == 0


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_misaligned_bf16_views_take_the_simt_route(cuda, causal):
    """A bf16 view whose rows start off a 16-byte boundary cannot be
    copied 16 bytes at a time: the forward goes, counted, to the CUDA-core
    kernel, and agrees with the plain version and the tensor-core kernel
    on an aligned copy of the same values."""
    g = torch.Generator().manual_seed(1)
    base = torch.randn(2, 100, 3, 3, 65, generator=g).to(torch.bfloat16)
    base = base.to(cuda)
    q, k, v = (base[:, :, i, :, 1:] for i in range(3))   # 2-byte offset
    assert cf._fwd_route(q, k, v) == "simt"
    routes = cf.route_launches()
    out, lse = cf.flash_fwd(q, k, v, causal)
    routes["simt"] += 1
    assert cf.route_launches() == routes
    ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, causal)
    aligned = [x.contiguous() for x in (q, k, v)]
    assert cf._fwd_route(*aligned) == "tc"
    tc_out, tc_lse = cf.flash_fwd(*aligned, causal)
    bound = flash_tol(torch.bfloat16, "out", ref_out, False, q, k, v, causal)
    for got in (out, tc_out):
        _assert_within(got, ref_out, bound, "out")
    for got in (lse, tc_lse):
        torch.testing.assert_close(got, ref_lse, rtol=0, atol=1e-5)


def test_flash_misaligned_do_takes_the_simt_backward(cuda):
    """A bf16 dO whose rows start off a 16-byte boundary: both backward
    kernels go, counted, to the CUDA cores and agree with the plain
    versions within the element-wise bound; the forward stays on the
    tensor cores."""
    q, k, v, _ = _flash_inputs(2, 100, 100, 3, 64, torch.bfloat16, cuda)
    g = torch.Generator().manual_seed(2)
    do = torch.randn(2, 100, 3, 65, generator=g).to(torch.bfloat16)
    do = do.to(cuda)[..., 1:]                        # 2-byte offset
    assert cf._fwd_route(q, k, v) == "tc"
    assert cf._bwd_route(q, k, v, do) == "simt"
    routes = {n: cf.route_launches(n) for n in cf.KERNELS}
    out, lse = cf.flash_fwd(q, k, v, True)
    delta = cf.flash_delta(out, do)
    dk, dv = cf.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    dq = cf.flash_bwd_dq(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    for n, route in zip(cf.KERNELS, ("tc", "simt", "simt")):
        routes[n][route] += 1
        assert cf.route_launches(n) == routes[n], n
    ref_dk, ref_dv = cf.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                True)
    ref_dq = cf.flash_bwd_dq_reference(q, k, v, do, lse, delta, True)
    bounds = _grad_bounds(torch.bfloat16, q, k, v, do, lse, delta, True,
                          ref_dq, ref_dk, ref_dv)
    for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                           ("dv", dv, ref_dv)):
        _assert_within(got, ref, bounds[name], name)


def test_flash_tc_launch_that_fails_raises(cuda, monkeypatch):
    """The C side launches the route it is given or refuses: f32 named
    onto the tensor-core route raises, and nothing is counted."""
    q, k, v, do = _flash_inputs(1, 64, 64, 2, 64, torch.float32, cuda)
    out, lse = cf.flash_fwd(q, k, v, True)
    delta = cf.flash_delta(out, do)
    monkeypatch.setattr(cf, "_fwd_route", lambda *a: "tc")
    monkeypatch.setattr(cf, "_bwd_route", lambda *a: "tc")
    before = cf.kernel_launches()
    routes = {n: cf.route_launches(n) for n in cf.KERNELS}
    with pytest.raises(RuntimeError, match=r"flash_fwd kernel launch \(tc\)"):
        cf.flash_fwd(q, k, v, True)
    with pytest.raises(RuntimeError, match=r"flash_bwd_dkv kernel launch"):
        cf.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    with pytest.raises(RuntimeError, match=r"flash_bwd_dq kernel launch"):
        cf.flash_bwd_dq(q, k, v, do, lse, delta, True)
    assert cf.kernel_launches() == before
    assert {n: cf.route_launches(n) for n in cf.KERNELS} == routes


def test_flash_tc_repeats_bitwise(cuda):
    """No atomics and a fixed order of sums: two calls of each
    tensor-core kernel give the same bits."""
    q, k, v, do = _flash_inputs(2, 300, 300, 3, 64, torch.bfloat16, cuda)
    out1, lse1 = cf.flash_fwd(q, k, v, True)
    out2, lse2 = cf.flash_fwd(q, k, v, True)
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)
    delta = cf.flash_delta(out1, do)
    assert cf._bwd_route(q, k, v, do) == "tc"
    grads = [(*cf.flash_bwd_dkv(q, k, v, do, lse1, delta, True),
              cf.flash_bwd_dq(q, k, v, do, lse1, delta, True))
             for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_flash_cuda_tensors_never_reach_the_plain_versions(cuda,
                                                           monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("flash_fwd_reference", "flash_bwd_dkv_reference",
                 "flash_bwd_dq_reference"):
        monkeypatch.setattr(cf, name, refuse)
    q, k, v, do = _flash_inputs(2, 64, 64, 2, 32, torch.float32, cuda)
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    cf.reset_kernel_launches()
    cf._Flash.apply(q, k, v, True).backward(do)
    torch.cuda.synchronize()
    assert cf.kernel_launches() == dict.fromkeys(cf.KERNELS, 1)
    assert all(x.grad is not None for x in (q, k, v))


def test_flash_refuses_what_it_does_not_take(cuda):
    q, k, v, _ = _flash_inputs(1, 32, 32, 2, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        cf.flash_fwd(q[..., :16], k[..., :16], v[..., :16], True)
    with pytest.raises(ValueError, match="dtype"):
        cf.flash_fwd(q, k.to(torch.bfloat16), v, True)
    with pytest.raises(ValueError, match="last axis"):
        cf.flash_fwd(q.transpose(1, 3).contiguous().transpose(1, 3), k, v,
                     True)


def test_training_runs_through_the_flash_kernels(cuda):
    """A nano GPT fit on the card: the forward kernel launches once per
    layer per training and validation batch, the two backward kernels
    once per layer per training batch, and the loss falls."""
    cfg = gpt2_config("nano", vocab_size=256, max_seq_len=64,
                      attention_impl="flash")
    module = GPTModule(config=cfg, batch_size=4, num_samples=64, lr=1e-3)
    cf.reset_kernel_launches()
    trainer = Trainer(strategy=RayStrategy(num_workers=1), max_epochs=1,
                      limit_train_batches=6, limit_val_batches=2, seed=0)
    trainer.fit(module)
    n = cfg.n_layers
    assert trainer.global_step == 6
    assert cf.kernel_launches() == {"flash_fwd": n * 8,
                                    "flash_bwd_dkv": n * 6,
                                    "flash_bwd_dq": n * 6}
    # bf16 compute: every forward and backward on the tensor cores
    assert cf.route_launches() == {"simt": 0, "tc": n * 8}
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        assert cf.route_launches(name) == {"simt": 0, "tc": n * 6}
    assert np.isfinite(trainer.callback_metrics["val_loss"])


def test_bert_tiny_flash_matches_dot(cuda):
    """BERT-tiny in f32 on the card: logits and every gradient through
    K2-K4 (``simt``, bidirectional) equal the dense attention's
    differentiated by autograd, K2-K4 n_layers times each; in bf16 the
    same step launches each on ``tc``."""
    from ray_lightning_tpu_torch.models import BertClassifier, bert_config
    cfg = bert_config("tiny", vocab_size=512, max_seq_len=64,
                      attention_impl="flash", dtype=torch.float32)
    toks = torch.randint(0, 512, (4, 64),
                         generator=torch.Generator().manual_seed(0)).to(cuda)
    out = {}
    for impl in ("flash", "dot"):
        model = BertClassifier(dataclasses.replace(cfg, attention_impl=impl),
                               device=cuda)
        before = cf.kernel_launches()
        logits = model(toks)
        logits.square().sum().backward()
        torch.cuda.synchronize()
        after = cf.kernel_launches()
        out[impl] = (logits.detach(), {n: p.grad for n, p
                                       in model.named_parameters()},
                     {n: after[n] - before[n] for n in cf.KERNELS})
    (lk, gk, nk), (lp, gp, np_) = out["flash"], out["dot"]
    assert nk == dict.fromkeys(cf.KERNELS, cfg.n_layers)
    assert np_ == dict.fromkeys(cf.KERNELS, 0)
    assert float((lk - lp).abs().max()) <= 1e-5
    for name, g in gp.items():
        assert float((gk[name] - g).abs().max()) <= 1e-4 * max(
            float(g.abs().max()), 1e-30), name
    bf16 = BertClassifier(dataclasses.replace(cfg, dtype=torch.bfloat16),
                          device=cuda)
    routes = {n: cf.route_launches(n) for n in cf.KERNELS}
    bf16(toks).float().square().sum().backward()
    torch.cuda.synchronize()
    for n in cf.KERNELS:
        routes[n]["tc"] += cfg.n_layers
        assert cf.route_launches(n) == routes[n], n


def test_vit_fit_under_its_remat_policy_launches_the_kernels(cuda):
    """A ViT-tiny fit with the default policy
    (``dots_with_no_batch_dims_save_attn``) on the card: K2 twice a layer
    a training step (the forward and the backward's replay) and once a
    layer a validation batch, K3 and K4 once a layer a step, all on
    ``tc``; the losses finite."""
    from ray_lightning_tpu_torch.models import ViTModule, vit_config
    cfg = vit_config("tiny", 32, 4, attention_impl="flash")
    module = ViTModule(config=cfg, image_size=32, patch_size=4, batch_size=8,
                       num_samples=32)
    cf.reset_kernel_launches()
    trainer = Trainer(strategy=RayStrategy(num_workers=1), max_epochs=1,
                      limit_train_batches=3, limit_val_batches=2, seed=0)
    trainer.fit(module)
    n = cfg.n_layers
    assert trainer.global_step == 3
    want = {"flash_fwd": n * (2 * 3 + 2), "flash_bwd_dkv": n * 3,
            "flash_bwd_dq": n * 3}
    assert cf.kernel_launches() == want
    for name in cf.KERNELS:
        assert cf.route_launches(name) == {"simt": 0, "tc": want[name]}
    assert np.isfinite(trainer.callback_metrics["val_loss"])


# ------------------------------------------------------------- ResNet
# one f32 ResNet-10 training step, card (TF32 off) against the CPU: the
# loss to 1e-5 of itself, each gradient and running statistic to 1e-4 of
# its largest magnitude (cuDNN's convolution algorithms sum in other
# orders than the CPU's)
RESNET_LOSS_RTOL, RESNET_RTOL = 1e-5, 1e-4


def _resnet_step(model, x, y):
    """One training-mode forward and backward: (loss, gradients, the
    running statistics after it), all on the host."""
    import torch.nn.functional as F
    model.train()
    loss = F.cross_entropy(model(x), y)
    loss.backward()
    return (loss.item(),
            {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: b.cpu() for n, b in model.named_buffers()})


def _resnet_batch(batch_size=16):
    from ray_lightning_tpu_torch.data import synthetic_images
    x, y = synthetic_images(batch_size, 10, 32, seed=0)
    return torch.from_numpy(x), torch.from_numpy(y).long()


def test_resnet10_f32_step_on_the_card_matches_the_cpu(cuda):
    """ResNet-10 at full width from the same weights and batch: the card's
    loss, gradients and updated running statistics against the CPU's."""
    from ray_lightning_tpu_torch.models import resnet10
    x, y = _resnet_batch()
    cpu = resnet10(device="cpu")
    card = resnet10(device=cuda)
    card.load_state_dict(cpu.state_dict())
    lc, gc, bc = _resnet_step(cpu, x, y)
    lg, gg, bg = _resnet_step(card, x.to(cuda), y.to(cuda))
    assert abs(lg - lc) <= RESNET_LOSS_RTOL * abs(lc)
    for want, got in ((gc, gg), (bc, bg)):
        for n, w in want.items():
            assert float((got[n] - w).abs().max()) <= RESNET_RTOL * max(
                float(w.abs().max()), 1e-30), n


def test_resnet18_bf16_fit_moves_finite_buffers(cuda):
    """ResNet-18 in bf16 through the trainer on the card: the losses
    finite, params and running statistics f32 on the card, every running
    statistic finite and moved off its start (mean 0, variance 1)."""
    from ray_lightning_tpu_torch.core import LambdaCallback
    from ray_lightning_tpu_torch.models import ResNetModule
    losses = []
    trainer = Trainer(strategy=RayStrategy(num_workers=1), max_epochs=1,
                      limit_train_batches=2, limit_val_batches=1, seed=0,
                      callbacks=[LambdaCallback(
                          on_train_batch_end=lambda tr, m, out, b, i:
                          losses.append(float(out["loss"])))])
    trainer.fit(ResNetModule(depth=18, batch_size=16, num_samples=32,
                             dtype=torch.bfloat16))
    assert len(losses) == 2 and np.isfinite(losses).all()
    for n, t in trainer.model.state_dict().items():
        assert t.is_cuda and t.dtype == torch.float32, n
    for n, b in trainer.model.named_buffers():
        start = 0.0 if n.endswith("running_mean") else 1.0
        assert torch.isfinite(b).all(), n
        assert float((b - start).abs().max()) > 0, n
    assert np.isfinite(trainer.callback_metrics["val_loss"])


@pytest.mark.parametrize("fmt", ["stream", "orbax"])
def test_resnet_buffers_round_trip_a_checkpoint_on_the_card(cuda, tmp_path,
                                                            fmt):
    """A ResNet-10 card run's checkpoint, both formats, restored by a
    fresh trainer: params and running statistics bitwise, on the card."""
    from ray_lightning_tpu_torch import ModelCheckpoint
    from ray_lightning_tpu_torch.models import ResNetModule

    def module():
        return ResNetModule(depth=10, batch_size=16, num_samples=64)

    t = _card_fit(tmp_path, module(),
                  callbacks=[ModelCheckpoint(save_format=fmt)])
    best = t.checkpoint_callback.best_model_path
    t2 = _card_fit(tmp_path, module(), ckpt_path=best, max_epochs=0)
    bufs = dict(t.model.named_buffers())
    assert bufs
    sd2 = t2.model.state_dict()
    for n, a in t.model.state_dict().items():
        assert sd2[n].device.type == "cuda" and torch.equal(a, sd2[n]), n
    assert not torch.equal(bufs["bn_init.running_var"],
                           torch.ones_like(bufs["bn_init.running_var"]))


# ------------------------------------------------------------ the MoE
# MoE-small's widths (4 layers, d_model 256, 4 heads of 64, 8 experts) at
# the slice's sequence length
MOE_CFG = dict(vocab_size=256, max_seq_len=128, attention_impl="flash",
               n_experts=8)


def _moe_batch(cfg, batch_size, seed=0):
    from ray_lightning_tpu_torch.models import moe
    x, y = moe._synthetic_lm_tokens(batch_size, cfg.max_seq_len,
                                    cfg.vocab_size, seed)
    return torch.from_numpy(x), torch.from_numpy(y).long()


def test_moe_attention_kernels_at_the_slice_shape(cuda):
    """K2-K4 at MoE-small's attention shape (B=8, H=4, D=64, T=S=128,
    causal) against their plain versions: bf16 on ``tc``, f32 on
    ``simt``, within ``chip_smoke.flash_case``'s bounds."""
    import chip_smoke
    flush = torch.empty(1 << 20, dtype=torch.uint8, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        chip_smoke.flash_case("test", "moe", 8, 128, 128, True, dtype, flush,
                              H=4)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_bf16_step_runs_k2_k4_on_tc(cuda, k):
    """MoE-small in bf16 at the slice's batch (8 x 128): one forward and
    backward of ``ce + w·aux`` launches K2-K4 once a layer each, on
    ``tc``; the loss, aux and every gradient finite, the banks' among
    them."""
    import torch.nn.functional as F
    from ray_lightning_tpu_torch.models import MoeTransformerLM, moe_config
    cfg = moe_config("small", expert_top_k=k, **MOE_CFG)
    model = MoeTransformerLM(cfg, device=cuda)
    x, y = _moe_batch(cfg, 8)
    cf.reset_kernel_launches()
    logits, aux = model(x.to(cuda))
    loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                           y.to(cuda).reshape(-1)) + cfg.aux_loss_weight * aux
    loss.backward()
    torch.cuda.synchronize()
    for n in cf.KERNELS:
        assert cf.route_launches(n) == {"simt": 0, "tc": cfg.n_layers}, n
    assert torch.isfinite(loss) and torch.isfinite(aux)
    for n, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), n
    assert float(model.blocks[0].moe.experts_up.grad.abs().max()) > 0


@pytest.mark.parametrize("k", [1, 2])
def test_moe_f32_step_on_the_card_matches_the_cpu(cuda, k):
    """Phase Z (f) (c)'s rule on MoE-small at batch 2: layer by layer on
    the CPU's inputs, a token may take other experts on the card only at
    a near tie of the CPU's probabilities, every other token's output
    within 1e-4 of the layer's largest; without a flip the loss, aux and
    every gradient (``chip_smoke.moe_step_vs_cpu`` raises on a miss)."""
    import chip_smoke
    from ray_lightning_tpu_torch.models import moe_config
    cfg = moe_config("small", expert_top_k=k, dtype=torch.float32, **MOE_CFG)
    res = chip_smoke.moe_step_vs_cpu(cfg, 2, device=cuda)
    assert res["end_to_end"] == "held" or res["near_tie_flips"] > 0


def test_moe_fit_on_the_card_counts_the_kernels(cuda):
    """A nano ``MoeModule`` fit on the card (adafactor, bf16 over f32
    weights): K2 once a layer a step and a validation batch, K3 and K4
    once a layer a step, all on ``tc``; ``train_aux`` and the validation
    metrics finite."""
    from ray_lightning_tpu_torch.models import MoeModule, moe_config
    cfg = moe_config("nano", vocab_size=256, max_seq_len=64,
                     attention_impl="flash")
    cf.reset_kernel_launches()
    trainer = Trainer(strategy=RayStrategy(num_workers=1), max_epochs=1,
                      limit_train_batches=3, limit_val_batches=2, seed=0)
    trainer.fit(MoeModule(config=cfg, seq_len=64, optimizer="adafactor"))
    n = cfg.n_layers
    want = {"flash_fwd": n * 5, "flash_bwd_dkv": n * 3,
            "flash_bwd_dq": n * 3}
    for name in cf.KERNELS:
        assert cf.route_launches(name) == {"simt": 0, "tc": want[name]}
    metrics = trainer.callback_metrics
    for name in ("train_aux", "val_ce", "val_aux"):
        assert np.isfinite(float(metrics[name])), name


def test_moe_greedy_generate_on_the_card_matches_the_cpu(cuda):
    """Greedy ``generate()`` of an f32 MoE-small at capacity factor 16
    (no expert overflows in the prefill or a step): the card's tokens
    equal the CPU's."""
    from ray_lightning_tpu_torch.models import (MoeTransformerLM, generate,
                                                moe_config)
    cfg = moe_config("small", dtype=torch.float32, capacity_factor=16.0,
                     **MOE_CFG)
    cpu = MoeTransformerLM(cfg, device="cpu")
    card = MoeTransformerLM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    prompts = np.random.default_rng(3).integers(0, 256, (2, 8))
    want = generate(cpu, None, prompts, 8, rng=0, temperature=0.0)
    got = generate(card, None, prompts, 8, rng=0, temperature=0.0)
    assert torch.equal(got.cpu(), want)


# ------------------------------------------------ the encoder-decoder
@pytest.mark.parametrize("causal", [False, True], ids=["encoder", "decoder"])
def test_seq2seq_gate_shape_kernels_match_plain(cuda, causal):
    """K2-K4 at the reversal gate's attention shape (B=32, H=4, D=32,
    T=S=8), the encoder's (full) and the decoder's (causal) against their
    plain versions: bf16 on ``tc``, f32 on ``simt``, within
    ``chip_smoke.flash_case``'s bounds."""
    import chip_smoke
    flush = torch.empty(1 << 20, dtype=torch.uint8, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        chip_smoke.flash_case("test", "s2s_gate", 32, 8, 8, causal, dtype,
                              flush, H=4, D=32)


def test_seq2seq_f32_step_with_a_padded_source_matches_the_cpu(cuda):
    """Phase Z (g) (c)'s check at a narrower vocab and length: one f32
    step of 2 + 2 layers at d_model 512, row 0's source padded after 40
    tokens and row 1's all padding; the loss, logits and every gradient
    within 1e-4 of their largest magnitude, the all-padding row's
    cross-attention exactly 0, K2-K4 twice each on ``simt``
    (``chip_smoke.s2s_step_vs_cpu`` raises on a miss)."""
    import chip_smoke
    res = chip_smoke.s2s_step_vs_cpu(device=cuda, keep=40, vocab_size=1024,
                                     max_seq_len=64)
    assert res["all_padding_cross_attention"] == "exactly 0"


def test_seq2seq_bf16_remat_fit_counts_the_kernels(cuda):
    """A narrow ``Seq2SeqModule`` under ``remat_policy=
    "dots_with_no_batch_dims_save_attn"`` on the card, bf16 over f32
    weights: K2 at 2·n_layers sites twice a step (the forward and the
    backward's replay) and once a validation batch, K3 and K4 once a
    site a step, all on ``tc``, half of each kernel's launches causal
    (the decoder's) and half full (the encoder's); the losses finite."""
    from ray_lightning_tpu_torch import Seq2SeqModule, TransformerConfig
    cfg = TransformerConfig(vocab_size=512, max_seq_len=64, d_model=256,
                            n_heads=4, n_layers=2, d_ff=512, causal=True,
                            attention_impl="flash", remat=True,
                            remat_policy="dots_with_no_batch_dims_save_attn")
    cf.reset_kernel_launches()
    trainer = Trainer(strategy=RayStrategy(num_workers=1), max_epochs=1,
                      limit_train_batches=3, limit_val_batches=2, seed=0)
    trainer.fit(Seq2SeqModule(config=cfg, batch_size=8, seq_len=64,
                              num_samples=64))
    n = cfg.n_layers
    calls = {"flash_fwd": 2 * 3 + 2, "flash_bwd_dkv": 3, "flash_bwd_dq": 3}
    for name in cf.KERNELS:
        assert cf.route_launches(name) == {"simt": 0,
                                           "tc": 2 * n * calls[name]}, name
        assert cf.mask_launches(name) == {"causal": n * calls[name],
                                          "full": n * calls[name]}, name
    for key in ("train_loss", "val_loss", "val_acc"):
        assert np.isfinite(float(trainer.callback_metrics[key])), key


# ------------------------------------------------ fused dequant-matmul
# (bits, leaf shape, transpose, int4 group): K = 200 leaves a ragged
# contraction tile, the (200, 3, 2, 16) leaf repeats its 16 int8 scales
# over 6 heads, 257 rows / columns leave a ragged output tile, K = 1100 and
# 1100 span several staged chunks of x, and group 2 or 4 splits a lane's
# codes over groups. At M <= 16 the first kind of each orientation runs
# the GEMVs; N % 4 != 0 (dense) and K % 4 or K % 8 != 0 (int8 or int4,
# transposed) run the tiled kernel there, as every case does at M = 40.
# int4 (200, 100): code rows of 50 bytes, too ragged for any asynchronous
# copy, so the dense GEMV loads its tiles element by element.
QMM_CASES = [(8, (200, 3, 2, 16), False, None), (4, (200, 3, 2, 16), False, 8),
             (4, (200, 96), False, 2), (8, (1100, 128), False, None),
             (8, (200, 257), False, None), (4, (200, 198), False, 2),
             (8, (257, 200), True, None), (4, (257, 200), True, 8),
             (8, (64, 1100), True, None), (4, (64, 1104), True, 8),
             (8, (257, 198), True, None), (4, (96, 196), True, 4),
             (4, (200, 100), False, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [1, 7, 40])
@pytest.mark.parametrize(
    "bits,shape,transpose,group", QMM_CASES,
    ids=[f"int{b}-{'x'.join(map(str, s))}-{'attend' if t else 'dense'}"
         + (f"-g{g}" if g else "") for b, s, t, g in QMM_CASES])
def test_quantized_matmul_matches_plain(cuda, bits, shape, transpose, group,
                                        M, dtype):
    g = torch.Generator().manual_seed(M + bits)
    w = torch.randn(shape, generator=g) * 0.05
    qt = quantize_params({"w": w}, f"int{bits}", group)["w"].to(cuda)
    K = shape[-1] if transpose else shape[0]
    x = torch.randn(M, K, generator=g).to(dtype).to(cuda)
    _check_quantized_matmul(x, qt, transpose)


def _check_quantized_matmul(x, qt, transpose):
    """One call against the plain version, counted on the route
    ``_route`` names; returns the output."""
    from ray_lightning_tpu_torch.models.quant import matmul_view
    _, _, K, N = matmul_view(qt, transpose)
    route = qmm._route(x.shape[0], N, K, qt.bits, transpose, x.dtype)
    routes = qmm.route_launches()
    out = qmm.quantized_matmul(x, qt, transpose)
    torch.cuda.synchronize()
    routes[route] += 1
    assert qmm.route_launches() == routes
    ref = qmm.quantized_matmul_reference(x, qt, transpose)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    top = max(1.0, float(ref.float().abs().max()))
    tol = (1e-5 if x.dtype == torch.float32 else 2.0 ** -7) * top
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    return out


# The tensor-core kernel at the serving path's widths: (bits, leaf shape,
# transpose, int4 group) for qkv (its 64 head_dim scales over 36 heads),
# out, up, down and the tied head (N = 50257: odd rows of the output)
TC_CASES = [(8, (768, 3, 12, 64), False, None), (8, (768, 768), False, None),
            (8, (768, 3072), False, None), (8, (3072, 768), False, None),
            (8, (50257, 768), True, None), (4, (768, 2304), False, 64),
            (4, (3072, 768), False, 64), (4, (50257, 768), True, 64)]


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-leaf", "bf16-leaf"])
@pytest.mark.parametrize("M", [17, 100, 1024])
@pytest.mark.parametrize(
    "bits,shape,transpose,group", TC_CASES,
    ids=[f"int{b}-{'x'.join(map(str, s))}-{'attend' if t else 'dense'}"
         for b, s, t, _ in TC_CASES])
def test_quantized_matmul_tc_at_path_widths(cuda, bits, shape, transpose,
                                            group, M, param_dtype):
    g = torch.Generator(device=cuda).manual_seed(M + bits)
    w = (torch.randn(shape, generator=g, device=cuda) * 0.02).to(param_dtype)
    qt = quantize_params({"w": w}, f"int{bits}", group)["w"]
    K = shape[-1] if transpose else shape[0]
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    assert qmm._route(M, 0, K, bits, transpose, x.dtype) == "tc"
    out = _check_quantized_matmul(x, qt, transpose)
    if M == 100:     # no atomics, a fixed order of sums: the same bits
        assert torch.equal(out, qmm.quantized_matmul(x, qt, transpose))


@pytest.mark.parametrize("gemv", ["gemv", "tiled", "tc"])
@pytest.mark.parametrize("transpose", [False, True], ids=["dense", "attend"])
def test_quantized_matmul_int4_sign_extension_all_bytes(cuda, transpose,
                                                        gemv):
    """All 256 packed bytes as codes, unit scales, x rows of the
    identity: the output is the dequantized leaf exactly, through the
    decode GEMVs (8 rows at a time), the tiled kernel (f32, the identity
    three times over, M > 16) and the tensor-core kernel (the same in
    bf16: codes -8..7 are exact there)."""
    packed = torch.arange(-128, 128, dtype=torch.int32).to(
        torch.int8).reshape(16, 16)
    qt = QTensor(packed, torch.ones(16, 1, 1), 4, 32, (16, 32),
                 torch.float32).to(cuda)
    w = qt.dequantize()                     # (16, 32), codes -8..7
    w2d = w.T if transpose else w
    eye = torch.eye(w2d.shape[0], device=cuda)
    routes = qmm.route_launches()
    if gemv == "gemv":
        for r0 in range(0, eye.shape[0], 8):
            out = qmm.quantized_matmul(eye[r0:r0 + 8].contiguous(), qt,
                                       transpose)
            assert torch.equal(out, w2d[r0:r0 + 8])
        routes["gemv_attend" if transpose else "gemv_dense"] += \
            eye.shape[0] // 8
    else:
        dtype = torch.bfloat16 if gemv == "tc" else torch.float32
        out = qmm.quantized_matmul(eye.repeat(3, 1).to(dtype), qt, transpose)
        assert torch.equal(out, w2d.repeat(3, 1).to(dtype))
        routes["tc" if gemv == "tc" else "tiled_f32"] += 1
    assert qmm.route_launches() == routes


def test_quantized_matmul_refuses_what_it_does_not_take(cuda):
    qt = quantize_params({"w": torch.randn(64, 96)}, "int8")["w"].to(cuda)
    x = torch.randn(4, 128, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        qmm.quantized_matmul(x[:, ::2], qt)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qmm.quantized_matmul(x[:, :64].contiguous().half(), qt)
    with pytest.raises(ValueError, match="devices"):
        qmm.quantized_matmul(x[:, :64].cpu(), qt)


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_bf16_quantized_prefill_takes_only_the_tc_route(cuda, weight_dtype):
    """A bf16 prefill of 4 x 16 tokens (M = 64 rows for every projection
    and the head) through a quantized nano model: all 4 x n_layers + 1
    calls on the tensor cores, none on another route."""
    from ray_lightning_tpu_torch.models.generate import _prefill_impl
    cfg = gpt2_config("nano", vocab_size=256, max_seq_len=32,
                      matmul_kernel="cuda")
    torch.manual_seed(0)
    model = TransformerLM(cfg, device="cpu").to(cuda)
    # int4 groups of 32: nano's head_dim
    model.quantize_weights(weight_dtype, 32 if weight_dtype == "int4" else None)
    model.requires_grad_(False).eval()
    tokens = torch.randint(0, 256, (4, 16), device=cuda)
    qmm.reset_kernel_launches()
    with torch.inference_mode():
        _, last = _prefill_impl(model, tokens, None)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(last.float()).all())
    assert qmm.route_launches() == {
        "gemv_dense": 0, "gemv_attend": 0, "tc": 4 * cfg.n_layers + 1,
        "tiled_f32": 0}


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_quantized_serving_runs_through_the_kernel(cuda, weight_dtype):
    """A small f32 engine with quantized weights on the card: the kernel
    launches 4 x n_layers + 1 times per forward (every decode step and
    every prefill), and its greedy tokens equal the plain path's."""
    cfg = gpt2_config("nano", vocab_size=128, max_seq_len=32,
                      dtype=torch.float32)
    torch.manual_seed(0)
    sd = TransformerLM(cfg, device="cpu").state_dict()
    trace = [(0, dict(prompt=[5, 17, 3, 9], max_new_tokens=6)),
             (0, dict(prompt=[9, 2, 44], max_new_tokens=6)),
             (3, dict(prompt=[42, 7], max_new_tokens=6))]
    group = 32 if weight_dtype == "int4" else None
    out = {}
    for kernel in ("torch", "cuda"):
        qmm.reset_kernel_launches()
        client = ServeClient(TransformerLM(cfg, device="meta"), sd,
                             num_slots=2, prefill_len=8, page_size=4,
                             page_native=True, attention_kernel="cuda",
                             weight_dtype=weight_dtype,
                             weight_group_size=group, matmul_kernel=kernel,
                             device=cuda)
        out[kernel] = client.serve_trace(list(trace))
        eng = client.engine
        expect = ((4 * cfg.n_layers + 1) * (eng.decode_substeps
                                            + eng.prefills)
                  if kernel == "cuda" else 0)
        assert qmm.kernel_launches() == expect
    assert {r: c.tokens for r, c in out["cuda"].items()} == \
        {r: c.tokens for r, c in out["torch"].items()}


# ------------------------------------------------ the decode GEMVs
GPT2_SMALL = {"qkv": ((768, 3, 12, 64), False), "out": ((768, 768), False),
              "up": ((768, 3072), False), "down": ((3072, 768), False),
              "head": ((50257, 768), True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 7, 8, 16])
@pytest.mark.parametrize("proj", list(GPT2_SMALL))
def test_gemv_at_gpt2_small_projections(cuda, proj, M, bits, dtype):
    """Every GPT-2-small projection at decode sizes on its GEMV route,
    int8 and int4 (group 64), bf16 and f32 x: within the tolerance, and a
    second call gives the same bits."""
    shape, transpose = GPT2_SMALL[proj]
    g = torch.Generator(device=cuda).manual_seed(M + bits)
    w = torch.randn(shape, generator=g, device=cuda) * 0.02
    qt = quantize_params({"w": w}, f"int{bits}")["w"]
    K = shape[-1] if transpose else shape[0]
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    N = shape[0] if transpose else int(np.prod(shape[1:]))
    assert qmm._route(M, N, K, bits, transpose, dtype) == (
        "gemv_attend" if transpose else "gemv_dense")
    out = _check_quantized_matmul(x, qt, transpose)
    assert torch.equal(out, qmm.quantized_matmul(x, qt, transpose))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("proj", list(GPT2_SMALL))
def test_gemv_geometry_fills_the_card(cuda, proj, bits):
    """At M = 8 every projection puts a block on every SM: the dense ones
    with 16-column tiles (out and down by splitting K over a cluster),
    bf16 x on the tensor cores; the head by 128 columns a block. Codes
    arrive in 16-byte loads or copies (8-byte copies of int4's 16-column
    tiles)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    shape, transpose = GPT2_SMALL[proj]
    qt = quantize_params({"w": torch.zeros(shape, device=cuda)},
                         f"int{bits}")["w"]
    K = shape[-1] if transpose else shape[0]
    x = torch.zeros(8, K, dtype=torch.bfloat16, device=cuda)
    geo = qmm.launch_geometry(x, qt, transpose)
    assert geo["grid_x"] * geo["grid_y"] >= sms
    assert geo["max_active_clusters"] * geo["cluster"] >= min(
        sms, geo["grid_x"] * geo["grid_y"])
    assert geo["load_bytes"] >= 8
    if transpose:
        assert geo["route"] == "gemv_attend" and geo["cluster"] == 1
    else:
        assert geo["route"] == "gemv_dense" and geo["tensor_cores"]
        # N = 768 has too few column tiles: K is split over a cluster
        assert geo["cluster"] > 1 or proj not in ("out", "down")


@pytest.mark.parametrize("proj", ["out", "head"])
def test_gemv_replays_in_a_cuda_graph(cuda, proj):
    shape, transpose = GPT2_SMALL[proj]
    g = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn(shape, generator=g, device=cuda) * 0.02
    qt = quantize_params({"w": w}, "int8")["w"]
    K = shape[-1] if transpose else shape[0]
    x = torch.randn(8, K, generator=g, device=cuda).to(torch.bfloat16)
    _graph_replays_equal_eager(lambda: qmm.quantized_matmul(x, qt, transpose))


# ------------------------------------------- checkpoint, resume, guard
def _card_fit(root, module, ckpt_path=None, **kw):
    for k, v in dict(max_epochs=2, limit_train_batches=4,
                     limit_val_batches=1, seed=0).items():
        kw.setdefault(k, v)
    trainer = Trainer(strategy=RayStrategy(), default_root_dir=str(root),
                      **kw)
    trainer.fit(module, ckpt_path=ckpt_path)
    return trainer


def _boring(name):
    from ray_lightning_tpu_torch import BoringModel, make_optimizer

    class Boring(BoringModel):
        def configure_optimizers(self):
            return make_optimizer(name, 1e-2)

    return Boring()


@pytest.mark.parametrize("fmt", ["stream", "orbax"])
@pytest.mark.parametrize("name", ["adamw", "adamw_bf16m", "adafactor"])
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path, fmt, name):
    """A checkpoint of a card run, both formats, restored by a fresh
    trainer: params bitwise, every optimizer state tensor back on the
    card in its dtype (torch's AdamW step counts and the presets' int32
    counts stay on the host, as torch keeps them)."""
    from ray_lightning_tpu_torch import ModelCheckpoint
    t = _card_fit(tmp_path, _boring(name),
                  callbacks=[ModelCheckpoint(save_format=fmt)])
    best = t.checkpoint_callback.best_model_path
    t2 = _card_fit(tmp_path, _boring(name), ckpt_path=best, max_epochs=0)
    for (n, a), b in zip(t.model.state_dict().items(),
                         t2.model.state_dict().values()):
        assert b.device.type == "cuda" and torch.equal(a, b), n
    opt, opt2 = t.train_state.optimizer, t2.train_state.optimizer
    for p, p2 in zip(t.model.parameters(), t2.model.parameters()):
        for key, v in opt.state[p].items():
            v2 = opt2.state[p2][key]
            assert v2.dtype == v.dtype and torch.equal(v2.cpu(), v.cpu())
            assert v2.device.type == ("cpu" if key == "step" else "cuda")
    assert all(opt2.state[k].device.type == "cpu"
               for k in ("count", "ema_count") if k in opt2.state)


@pytest.mark.parametrize("fmt", ["stream", "orbax"])
def test_gpt_kill_and_resume_is_bitwise_on_the_card(cuda, tmp_path, fmt):
    """Nano GPT on the flash kernels in bf16 over f32 master weights,
    killed after a mid-epoch save and resumed with resume="auto": the
    final params and optimizer state equal the uninterrupted run's."""
    from ray_lightning_tpu_torch import ModelCheckpoint
    from ray_lightning_tpu_torch.reliability import FaultPlan, InjectedFault
    cfg = gpt2_config("nano", attention_impl="flash", vocab_size=256,
                      max_seq_len=64)

    def module():
        return GPTModule(config=cfg, batch_size=4, num_samples=32)

    ref = _card_fit(tmp_path / "ref", module())
    cb = dict(dirpath=str(tmp_path / "ck"), save_format=fmt,
              every_n_train_steps=3, save_top_k=-1)
    with pytest.raises(InjectedFault):   # dies after the step-3 save
        with FaultPlan.at("train.step", [3]).armed():
            _card_fit(tmp_path, module(), callbacks=[ModelCheckpoint(**cb)])
    cf.reset_kernel_launches()
    resumed = _card_fit(tmp_path, module(), resume="auto",
                        callbacks=[ModelCheckpoint(**cb)])
    assert cf.route_launches("flash_bwd_dkv")["tc"] == cfg.n_layers * 5
    for (n, a), b in zip(ref.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    for p, p2 in zip(ref.model.parameters(), resumed.model.parameters()):
        for key, v in ref.train_state.optimizer.state[p].items():
            assert torch.equal(v, resumed.train_state.optimizer.state[p2][
                key]), key


def test_guarded_step_skips_a_nan_batch_on_the_card(cuda, tmp_path):
    """nonfinite_action="skip_batch" with one batch NaN-poisoned: one
    skipped batch, every param finite, one optimizer step fewer than
    batches."""
    from ray_lightning_tpu_torch.reliability import FaultPlan
    with FaultPlan.at("loader.next", [1], mode="nan").armed():
        t = _card_fit(tmp_path, _boring("adamw"), limit_val_batches=0,
                      nonfinite_action="skip_batch")
    assert t.nonfinite_batches == 1
    assert all(torch.isfinite(p).all() for p in t.model.parameters())
    steps = {int(s["step"]) for s in t.train_state.optimizer.state.values()}
    assert steps == {t.global_step - 1} and t.global_step == 8


# ------------------------------------------------ one process per card
class _WorkerProbe(Callback):
    """Per-step losses and the flash kernels' launches per route, counted
    in the worker that trains (reset at fit start): the launches ride
    back in ``callback_metrics``, the losses as this callback's state."""

    def __init__(self):
        self.losses = []

    def on_fit_start(self, trainer, module):
        cf.reset_kernel_launches()

    def on_train_batch_end(self, trainer, module, outputs, batch, idx):
        self.losses.append(float(outputs["loss"]))

    def on_train_end(self, trainer, module):
        for name in cf.KERNELS:
            for route, n in cf.route_launches(name).items():
                trainer.callback_metrics[f"{name}/{route}"] = n
        trainer.callback_metrics["device"] = str(trainer.strategy.root_device)

    def state_dict(self):
        return {"losses": self.losses}

    def load_state_dict(self, state):
        self.losses = state["losses"]


def _nano_bf16(optimizer="adamw"):
    cfg = gpt2_config("nano", attention_impl="flash", vocab_size=256,
                      max_seq_len=64)
    return GPTModule(config=cfg, batch_size=4, num_samples=32,
                     optimizer=optimizer)


@pytest.fixture(scope="module")
def card_world():
    """One spawned worker process that owns the card, reused by the
    tests below (each launch forms a fresh NCCL group of world size 1)."""
    if not torch.cuda.is_available():
        pytest.skip("the card workers need a card: no CUDA device")
    ray = ProcessRay()
    ray.init()
    workers = [ray.remote(ExecutorBase).options(
        construct_timeout=300).remote()]
    yield ray, workers
    ray.shutdown()
    assert ray.live_actor_count() == 0


CARD_STRATEGIES = {"ddp": RayStrategy, "allreduce": HorovodRayStrategy,
                   "zero": RayShardedStrategy, "fsdp": FSDPStrategy}


@pytest.mark.parametrize("name", sorted(CARD_STRATEGIES))
def test_one_worker_per_card_through_the_process_backend(cuda, card_world,
                                                         tmp_path, name):
    """Nano GPT in bf16 on the flash kernels, fit by a spawned worker in
    an NCCL process group of world size 1 under each strategy: K2-K4 ran
    on the tensor cores in the worker, n_layers times a step each; the
    losses equal the in-process fit's bitwise under DDP and the explicit
    all-reduce (an all-reduce of one rank is a copy), and within 1e-3 of
    them under ZeRO and FSDP2 (the sharded paths may sum in another
    order, which can flip a bf16 rounding)."""
    ray, workers = card_world
    local_probe = _WorkerProbe()
    local = _card_fit(tmp_path, _nano_bf16(), max_epochs=1,
                      limit_val_batches=0, callbacks=[local_probe])
    probe = _WorkerProbe()
    strategy = CARD_STRATEGIES[name](num_workers=1)
    trainer = Trainer(strategy=strategy, max_epochs=1, limit_train_batches=4,
                      limit_val_batches=0, seed=0, callbacks=[probe])
    trainer._launcher = RayLauncher(strategy, ray_module=ray,
                                    workers=workers)
    trainer.fit(_nano_bf16())
    m = trainer.callback_metrics
    n = local.model.cfg.n_layers * 4
    for kernel in cf.KERNELS:
        assert (m[f"{kernel}/tc"], m[f"{kernel}/simt"]) == (n, 0), kernel
    assert m["device"] == "cuda:0" and trainer.global_step == 4
    if name in ("ddp", "allreduce"):
        assert probe.losses == local_probe.losses
        got = trainer.train_state_dict["params"]
        for key, t in local.model.state_dict().items():
            assert torch.equal(got[key], t.cpu()), key
    else:
        np.testing.assert_allclose(probe.losses, local_probe.losses,
                                   rtol=1e-3, atol=0)


def test_more_card_workers_than_cards_raise_before_any_spawn(cuda):
    import multiprocessing
    before = len(multiprocessing.active_children())
    strategy = RayStrategy(num_workers=torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="visible GPU"):
        Trainer(strategy=strategy, max_steps=1).fit(_nano_bf16())
    assert len(multiprocessing.active_children()) == before


def test_a_worker_without_a_card_raises(cuda):
    """A worker started with CUDA_VISIBLE_DEVICES empty sees no card: it
    raises, and the driver re-raises, rather than training on the CPU."""
    ray = ProcessRay(worker_env={"CUDA_VISIBLE_DEVICES": ""})
    strategy = RayStrategy(num_workers=1)
    trainer = Trainer(strategy=strategy, max_steps=1)
    trainer._launcher = RayLauncher(strategy, ray_module=ray)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            trainer.fit(_nano_bf16())
    finally:
        ray.shutdown()
    assert ray.live_actor_count() == 0


def _worker_fit(card_world, cls, module):
    """``module`` fit by the card worker under ``cls(num_workers=1)``:
    (trainer, the worker's per-step losses)."""
    ray, workers = card_world
    probe = _WorkerProbe()
    strategy = cls(num_workers=1)
    trainer = Trainer(strategy=strategy, max_epochs=1, limit_train_batches=4,
                      limit_val_batches=0, seed=0, callbacks=[probe])
    trainer._launcher = RayLauncher(strategy, ray_module=ray,
                                    workers=workers)
    trainer.fit(module)
    m = trainer.callback_metrics
    n = module.cfg.n_layers * 4
    for kernel in cf.KERNELS:
        assert (m[f"{kernel}/tc"], m[f"{kernel}/simt"]) == (n, 0), kernel
    return trainer, probe.losses


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_bf16m", "adafactor"])
def test_zero_at_world_size_one_is_bitwise_the_one_process_fit(
        cuda, card_world, tmp_path, optimizer):
    """ZeRO by the JAX package's split, in an NCCL group of world size 1:
    every param is one rank's whole shard, so the losses and the final
    params equal the in-process fit's bitwise."""
    local_probe = _WorkerProbe()
    local = _card_fit(tmp_path, _nano_bf16(optimizer), max_epochs=1,
                      limit_val_batches=0, callbacks=[local_probe])
    trainer, losses = _worker_fit(card_world, RayShardedStrategy,
                                  _nano_bf16(optimizer))
    assert losses == local_probe.losses
    got = trainer.train_state_dict["params"]
    for key, t in local.model.state_dict().items():
        assert torch.equal(got[key], t.cpu()), key


def test_adafactor_under_fsdp2_on_the_card(cuda, card_world, tmp_path):
    """The adafactor preset on FSDP2's DTensor params in an NCCL group of
    world size 1: losses within 1e-3 of the in-process fit (FSDP2's
    gathered paths may sum in another order, which can flip a bf16
    rounding), a state that gathers into the one-process layout."""
    local_probe = _WorkerProbe()
    local = _card_fit(tmp_path, _nano_bf16("adafactor"), max_epochs=1,
                      limit_val_batches=0, callbacks=[local_probe])
    trainer, losses = _worker_fit(card_world, FSDPStrategy,
                                  _nano_bf16("adafactor"))
    np.testing.assert_allclose(losses, local_probe.losses, rtol=1e-3, atol=0)
    want = local.train_state.optimizer.state_dict()["state"]
    got = trainer.train_state_dict["opt_state"]["state"]
    assert got.keys() == want.keys()
    for i, st in want.items():
        if isinstance(st, dict):
            for k, t in st.items():
                assert got[i][k].shape == t.shape, (i, k)
                assert got[i][k].dtype == t.dtype, (i, k)


# GPT-2-small's stream checkpoint with AdamW is 1,493,454,109 bytes
STREAM_INTS = 373_300_000


def _put_card_stream(queue, n):
    """In a card worker: an int32 state of ``n`` elements made on the
    card, serialized as a trial checkpoint is, and put into ``queue``;
    returns the stream's bytes."""
    from ray_lightning_tpu_torch.util import to_state_stream
    state = {"a": torch.arange(n, dtype=torch.int32, device="cuda")}
    stream = to_state_stream(state)
    queue.put((0, stream))
    return len(stream)


def test_a_checkpoint_sized_stream_crosses_the_session_queue(cuda,
                                                             card_world):
    """1.49 GB put by a card worker into ``ProcessRay``'s queue reaches
    the driver whole (through a temporary file, removed once read)."""
    import os
    import tempfile

    from ray_lightning_tpu_torch.util import load_state_stream
    ray, workers = card_world
    q = ray.make_queue()
    try:
        size = ray.get(workers[0].execute.remote(_put_card_stream, q,
                                                 STREAM_INTS))
        rank, stream = q.get(timeout=600)
        assert rank == 0 and len(stream) == size > 1.49e9
        a = load_state_stream(stream, map_location="cpu")["a"]
        del stream
        assert torch.equal(a, torch.arange(STREAM_INTS, dtype=torch.int32))
    finally:
        q.shutdown()
    assert not [f for f in os.listdir(tempfile.gettempdir())
                if f.startswith("processray-")]


# ------------------------------------- chunked prefill: K2 on serving
# the chunk path's K2 calls: one row (B = 1), a chunk of T queries at the
# end of the S keys its row holds (S = offset + T), GPT-2-small's heads
CHUNK_SHAPES = [(T, S) for T in (128, 256) for S in range(T, 1025, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T,S", CHUNK_SHAPES,
                         ids=[f"t{T}-s{S}" for T, S in CHUNK_SHAPES])
def test_flash_fwd_at_the_chunk_shapes(cuda, dtype, T, S):
    """K2 as chunked prefill calls it: q a view of the fused qkv
    projection, k and v the gathered pages plus the chunk's own, made
    contiguous; causal, end-aligned. bf16 on ``tc`` held element by
    element by ``cf.flash_out_bound``, f32 on ``simt`` to 1e-5."""
    g = torch.Generator().manual_seed(T * 7 + S)
    qkv = torch.randn(1, T, 3, 12, 64, generator=g).to(dtype).to(cuda)
    k = torch.randn(1, S, 12, 64, generator=g).to(dtype).to(cuda)
    v = torch.randn(1, S, 12, 64, generator=g).to(dtype).to(cuda)
    q = qkv[:, :, 0]
    cf.reset_kernel_launches()
    out, lse = cf.flash_fwd(q, k, v, True)
    torch.cuda.synchronize()
    route = "tc" if dtype == torch.bfloat16 else "simt"
    assert cf.route_launches() == {"simt": 0, "tc": 0, route: 1}
    ref, ref_lse = cf.flash_fwd_reference(q, k, v, True)
    tol = (cf.flash_out_bound(q, k, v, True, ref)
           if dtype == torch.bfloat16 else 1e-5)
    _assert_within(out, ref, tol, f"chunk out T={T} S={S}")
    _assert_within(lse, ref_lse, 1e-5, f"chunk lse T={T} S={S}")


@pytest.mark.parametrize("weight_dtype", [None, "int8"])
def test_chunked_serving_runs_through_k2_and_k5(cuda, weight_dtype):
    """A bf16 nano engine with ``prefill_chunk`` and ``prefix_cache``
    (every prompt through chunks) on the card: K2 launches n_layers times
    per chunk dispatch, all on ``tc``; with int8 weights K5 launches 4 x
    n_layers + 1 times per chunk dispatch on ``tc`` and per decode step
    on the GEMVs, none on ``tiled_f32``. Every request runs its budget;
    the shared system prompt's pages are adopted."""
    cfg = gpt2_config("nano", vocab_size=128, max_seq_len=64)
    torch.manual_seed(0)
    sd = TransformerLM(cfg, device="cpu").state_dict()
    sysp = list(range(3, 35))                      # one chunk of 32
    trace = [(0, dict(prompt=sysp + [5, 9], max_new_tokens=6)),
             (0, dict(prompt=[9, 2, 44], max_new_tokens=6)),
             (6, dict(prompt=sysp + [42, 7, 3], max_new_tokens=6)),
             (7, dict(prompt=list(range(40, 80)), max_new_tokens=6,
                      temperature=0.8, top_k=20))]
    kw = {} if weight_dtype is None else dict(weight_dtype=weight_dtype,
                                              matmul_kernel="cuda")
    cf.reset_kernel_launches()
    qmm.reset_kernel_launches()
    # chunks of 32 rows: K5's tensor-core route (the GEMVs take M <= 16)
    client = ServeClient(TransformerLM(cfg, device="meta"), sd, num_slots=3,
                         prefill_len=16, page_size=8, page_native=True,
                         prefill_chunk=32, prefix_cache=True,
                         attention_kernel="cuda", device=cuda, **kw)
    out = client.serve_trace(list(trace))
    eng = client.engine
    assert [len(out[r].tokens) for r in range(4)] == [6] * 4
    assert out[2].prefix_hit_tokens == 32 and eng.prefills == 0
    n = eng.chunk_dispatches
    assert cf.route_launches() == {"simt": 0, "tc": cfg.n_layers * n}
    per_forward = 4 * cfg.n_layers + 1
    want = {"gemv_dense": 0, "gemv_attend": 0, "tc": 0, "tiled_f32": 0}
    if weight_dtype is not None:
        want = {"gemv_dense": 4 * cfg.n_layers * eng.decode_substeps,
                "gemv_attend": eng.decode_substeps, "tc": per_forward * n,
                "tiled_f32": 0}
    assert qmm.route_launches() == want
    client.shutdown()


def test_adafactor_state_bytes_of_the_training_path(cuda):
    """``GPTModule``'s adafactor on GPT-2-small on the card (the module
    of ``chip_smoke.py``'s phases O and D) holds the JAX preset's
    optimizer state: 334,953,400 bytes."""
    from ray_lightning_tpu_torch.core import opt_state_bytes
    module = GPTModule(config=gpt2_config("small", attention_impl="flash"),
                       batch_size=8, seq_len=1024, optimizer="adafactor")
    model = TransformerLM(module.cfg, device=cuda)
    opt = module.configure_optimizers()(model.parameters())
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    assert opt_state_bytes(opt) == 334_953_400


# ------------------------------------------------- speculative decoding
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("quantized", [False, True], ids=["same", "int8"])
def test_kernel_at_the_verify_width(cuda, dtype, quantized):
    """T = 5 (a spec verify at k = 4) at phase S's geometry (D = 64, 16-token
    pages, 64 pages a slot): within the tolerance, bitwise on a second
    call."""
    args = [None if a is None else a.to(cuda)
            for a in _cluster_inputs(dtype, quantized, 5, 64, 16, 64)]
    pa.reset_kernel_launches()
    out = pa.paged_attention(*args)
    again = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches_by_t() == {5: 2}
    assert torch.equal(out, again)
    ref = pa.paged_attention_reference(*args)
    assert torch.count_nonzero(out[-1]) == 0
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)


SPEC_TRACE = [(0, dict(prompt=[5, 17, 3, 9], max_new_tokens=10)),
              (0, dict(prompt=[9, 2, 44], max_new_tokens=10)),
              (3, dict(prompt=[42, 7], max_new_tokens=10)),
              (5, dict(prompt=[1], max_new_tokens=3))]


def _spec_models(dtype):
    """A nano target (vocab 128, max_seq_len 64) and a 1-layer draft cut
    from it (its embeddings, final norm and first block)."""
    cfg = gpt2_config("nano", vocab_size=128, max_seq_len=64, dtype=dtype)
    torch.manual_seed(0)
    sd = TransformerLM(cfg, device="cpu").state_dict()
    dsd = {k: v for k, v in sd.items()
           if not k.startswith("stack.blocks.1.")}
    return cfg, sd, dataclasses.replace(cfg, n_layers=1), dsd


def _spec_serve(cuda, cfg, sd, dcfg=None, dsd=None, k=4, **kw):
    """Serve SPEC_TRACE on the card (4 slots, so the verify's M is 20):
    completions, the engine, and its draft refills."""
    if dcfg is not None:
        kw.update(draft_model=TransformerLM(dcfg, device="meta"),
                  draft_params=dsd, spec_k=k)
    client = ServeClient(TransformerLM(cfg, device="meta"), sd, num_slots=4,
                         prefill_len=8, page_size=4, page_native=True,
                         attention_kernel="cuda", device=cuda, **kw)
    out = client.serve_trace(list(SPEC_TRACE))
    eng = client.engine
    refills = eng.spec.refills if eng.spec is not None else 0
    client.shutdown()
    assert [len(out[r].tokens) for r in range(4)] == [10, 10, 10, 3]
    return out, eng, refills


def _tokens(out):
    return {r: c.tokens for r, c in out.items()}


@pytest.mark.parametrize("k", [2, 4])
def test_spec_serving_on_the_card_equals_non_spec_in_f32(cuda, k):
    """f32: the spec engine's greedy tokens equal the non-spec engine's;
    the verify launches the paged-attention kernel n_layers times a
    round, every launch at T = k+1."""
    cfg, sd, dcfg, dsd = _spec_models(torch.float32)
    plain, _, _ = _spec_serve(cuda, cfg, sd)
    pa.reset_kernel_launches()
    out, eng, _ = _spec_serve(cuda, cfg, sd, dcfg, dsd, k=k)
    assert eng.spec_rounds > 0
    assert pa.launches_by_t() == {k + 1: cfg.n_layers * eng.spec_rounds}
    assert _tokens(out) == _tokens(plain)


def test_spec_identical_draft_is_always_accepted_on_the_card(cuda):
    """The target as its own draft (f32): every judged draft accepted,
    the same tokens as the non-spec engine."""
    cfg, sd, _, _ = _spec_models(torch.float32)
    plain, _, _ = _spec_serve(cuda, cfg, sd)
    out, eng, _ = _spec_serve(cuda, cfg, sd, cfg, sd)
    assert eng.spec_rejected_tokens == 0 and eng.spec_accepted_tokens > 0
    assert _tokens(out) == _tokens(plain)


def test_spec_quantized_verify_on_tc_and_draft_on_the_gemvs(cuda):
    """bf16 with int8 target and draft weights through K5: the verify
    (M = 4 x 5 = 20), the prefills (M = 32) and the draft's refills (M =
    64) on the tensor cores, the draft's feeds (M = 4) on the GEMVs, none
    on ``tiled_f32``."""
    cfg, sd, dcfg, dsd = _spec_models(torch.bfloat16)
    qmm.reset_kernel_launches()
    _, eng, refills = _spec_serve(cuda, cfg, sd, dcfg, dsd,
                                  weight_dtype="int8",
                                  draft_weight_dtype="int8",
                                  matmul_kernel="cuda")
    per_forward, draft_forward = 4 * cfg.n_layers + 1, 4 * dcfg.n_layers + 1
    assert refills == len(SPEC_TRACE)
    assert qmm.route_launches() == {
        "gemv_dense": 4 * dcfg.n_layers * eng.spec_draft_steps,
        "gemv_attend": eng.spec_draft_steps,
        "tc": per_forward * (eng.spec_rounds + eng.prefills)
        + draft_forward * refills,
        "tiled_f32": 0}


# ------------------------------- T3 and the rest of the model core (item 8)
REMAT_POLICIES = [None, "dots", "dots_with_no_batch_dims",
                  "dots_with_no_batch_dims_save_attn",
                  "dots_with_no_batch_dims_save_attn_mlp"]


def _core_model(cuda, **kw):
    """A bf16 nano GPT on the flash kernels, its weights from seed 0."""
    cfg = gpt2_config("nano", attention_impl="flash", vocab_size=256,
                      max_seq_len=64, **kw)
    model = TransformerLM(cfg, device=cuda)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def _core_step(model, cuda, **kw):
    toks = torch.randint(0, 256, (4, 65),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    logits = model(toks[:, :-1], **kw)
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), toks[:, 1:].reshape(-1))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_dropout_steps_take_the_dense_path_on_the_card(cuda):
    """With dropout on, a step launches none of K2-K4 (the reference's
    dense route); a deterministic forward launches K2 once a layer; the
    same seed gives the same step bitwise."""
    model = _core_model(cuda, dropout=0.1)
    cf.reset_kernel_launches()
    a = _core_step(model, cuda, deterministic=False, dropout_seed=3)
    assert cf.kernel_launches() == dict.fromkeys(cf.KERNELS, 0)
    for p in model.parameters():
        p.grad = None
    b = _core_step(model, cuda, deterministic=False, dropout_seed=3)
    assert torch.equal(a[0], b[0]) and torch.isfinite(a[0])
    with torch.no_grad():
        model(torch.zeros((2, 64), dtype=torch.long, device=cuda))
    n = model.cfg.n_layers
    assert cf.route_launches("flash_fwd") == {"simt": 0, "tc": n}


@pytest.mark.parametrize("policy", REMAT_POLICIES, ids=str)
def test_remat_replays_k2_on_the_card(cuda, policy):
    """Under every policy a step launches K2 twice a layer (the forward
    and its replay in backward) and K3 and K4 once, all on ``tc``; the
    loss and gradients equal the plain step's bitwise."""
    plain = _core_step(_core_model(cuda), cuda)
    model = _core_model(cuda, remat=True, remat_policy=policy)
    cf.reset_kernel_launches()
    got = _core_step(model, cuda)
    n = model.cfg.n_layers
    assert {k: cf.route_launches(k) for k in cf.KERNELS} == {
        "flash_fwd": {"simt": 0, "tc": 2 * n},
        "flash_bwd_dkv": {"simt": 0, "tc": n},
        "flash_bwd_dq": {"simt": 0, "tc": n}}
    assert torch.equal(got[0], plain[0])
    for name, g in plain[1].items():
        assert torch.equal(got[1][name], g), name


@pytest.mark.parametrize("M", [8, 128, 1024])
def test_k5_at_the_untied_head(cuda, M):
    """The untied GPT-2 head, the dense orientation at K = 768, N =
    50257 (not a multiple of 4, so even M = 8 goes to ``tc``): bf16 x on
    ``tc``, f32 x on ``tiled_f32``, each against the plain version."""
    w = 0.02 * torch.randn(768, 50257, generator=torch.Generator()
                           .manual_seed(0))
    qt = quantize_params({"w": w}, "int8")["w"].to(cuda)
    for dtype, route in ((torch.bfloat16, "tc"), (torch.float32,
                                                 "tiled_f32")):
        x = torch.randn(M, 768, generator=torch.Generator().manual_seed(M)
                        ).to(cuda, dtype)
        qmm.reset_kernel_launches()
        got = qmm.quantized_matmul(x, qt)
        assert qmm.route_launches(n=50257) == {
            r: int(r == route) for r in qmm.ROUTES}
        ref = qmm.quantized_matmul_reference(x, qt)
        scale = max(1.0, ref.float().abs().max().item())
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        assert (got.float() - ref.float()).abs().max().item() <= tol * scale


def test_untied_quantized_serving_runs_the_head_on_tc(cuda):
    """An untied bf16 nano model with int8 weights served through K5: an
    odd vocab puts the head on ``tc`` at every M (prefill and decode),
    none of it on ``tiled_f32``."""
    cfg = gpt2_config("nano", vocab_size=251, max_seq_len=32,
                      tie_embeddings=False)
    model = TransformerLM(cfg, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    client = ServeClient(model, model.state_dict(), num_slots=3,
                         prefill_len=8, page_size=4, page_native=True,
                         attention_kernel="cuda", matmul_kernel="cuda",
                         weight_dtype="int8", device=cuda)
    qmm.reset_kernel_launches()
    out = client.serve_trace([(0, dict(prompt=[5, 17, 3], max_new_tokens=6)),
                              (2, dict(prompt=[9, 2], max_new_tokens=6))])
    eng = client.engine
    heads = qmm.route_launches(n=251)
    client.shutdown()
    assert all(len(c.tokens) == 6 for c in out.values())
    assert heads["tc"] > 0 and heads["tc"] == sum(heads.values())
    assert qmm.route_launches()["tiled_f32"] == 0
    assert eng.prefills > 0


def test_lm_head_losses_on_the_card(cuda):
    """The direct and chunked LM-head losses on bf16 hidden states
    against the materialized f32 cross-entropy, value and both
    gradients within bf16 bounds."""
    from ray_lightning_tpu_torch.ops.lm_head_loss import (
        chunked_lm_head_xent, lm_head_xent)
    g = torch.Generator().manual_seed(0)
    hidden = torch.randn(4, 300, 64, generator=g).to(cuda, torch.bfloat16)
    table = (0.2 * torch.randn(1001, 64, generator=g)).to(cuda)
    labels = torch.randint(0, 1001, (4, 300), generator=g).to(cuda)

    def run(fn):
        h = hidden.detach().requires_grad_()
        t = table.detach().requires_grad_()
        loss = fn(h, t)
        loss.backward()
        return loss.item(), h.grad.float(), t.grad

    want = run(lambda h, t: torch.nn.functional.cross_entropy(
        (h.float() @ t.to(torch.bfloat16).float().T).reshape(-1, 1001),
        labels.reshape(-1)))
    for fn in (lambda h, t: lm_head_xent(h, t, labels),
               lambda h, t: chunked_lm_head_xent(h, t, labels,
                                                 chunk_size=256)):
        loss, gh, gt = run(fn)
        assert abs(loss - want[0]) <= 1e-2
        for got, ref in ((gh, want[1]), (gt, want[2])):
            scale = ref.abs().max().item()
            assert (got - ref).abs().max().item() <= 2 * 2.0 ** -7 * scale


# --------------------------- dense KV and decode outside the engine (S1, T9)
DENSE_LAYOUTS = {"dense": {}, "view": dict(page_size=4),
                 "page-native": dict(page_size=4, page_native=True,
                                     attention_kernel="cuda")}


@pytest.mark.parametrize("layout", list(DENSE_LAYOUTS))
def test_dense_layouts_route_k5_as_the_page_native_engine(cuda, layout):
    """bf16 with int8 weights through K5 on every KV layout: the decode
    GEMVs at M = 3 slots, ``tc`` at the prefill's M = 3 x 8, never
    ``tiled_f32``; K1 only on the page-native engine."""
    cfg, sd, _, _ = _spec_models(torch.bfloat16)
    qmm.reset_kernel_launches()
    pa.reset_kernel_launches()
    client = ServeClient(TransformerLM(cfg, device="meta"), sd, num_slots=3,
                         prefill_len=8, weight_dtype="int8",
                         matmul_kernel="cuda", device=cuda,
                         **DENSE_LAYOUTS[layout])
    out = client.serve_trace(list(SPEC_TRACE))
    eng = client.engine
    assert [len(out[r].tokens) for r in range(4)] == [10, 10, 10, 3]
    per_forward = 4 * cfg.n_layers + 1
    assert qmm.route_launches() == {
        "gemv_dense": 4 * cfg.n_layers * eng.decode_substeps,
        "gemv_attend": eng.decode_substeps,
        "tc": per_forward * eng.prefills, "tiled_f32": 0}
    k1 = cfg.n_layers * eng.decode_substeps if layout == "page-native" else 0
    assert pa.kernel_launches() == k1
    client.shutdown()


@pytest.fixture(scope="module")
def gpt2_small_serving():
    """``chip_smoke.py`` phase 2's GPT-2-small weights and trace."""
    import chip_smoke
    from ray_lightning_tpu_torch.interop import load_flax_params
    cfg = gpt2_config("small")
    rng = np.random.default_rng(0)
    sd = load_flax_params(TransformerLM(cfg, device="cpu"),
                          chip_smoke.random_flax_params(cfg, rng)
                          ).state_dict()
    return chip_smoke, cfg, sd, chip_smoke.make_trace(rng, cfg.vocab_size)


@pytest.mark.parametrize("layout", ["dense", "view"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_dense_decode_dispatch_launches_match_phase_g(
        cuda, gpt2_small_serving, layout, kv_dtype):
    """One decode dispatch of GPT-2-small on the dense pool and on the
    dense view, bf16 and int8 KV, as ``chip_smoke.py`` phase G (a) and
    (b) profile it, launches the kernels that phase records
    (``G_DECODE_LAUNCHES``, within the profiler's spread between calls,
    ``G_LAUNCH_SPREAD``)."""
    chip_smoke, cfg, sd, trace = gpt2_small_serving
    prof = chip_smoke.profile_decode(TransformerLM(cfg, device="meta"), sd,
                                     trace, chip_smoke.G_LAYOUTS[layout],
                                     kv_dtype=kv_dtype)
    key = f"{layout} {kv_dtype or 'bf16'}"
    n = chip_smoke.dispatch_launches(prof)
    assert chip_smoke.launches_close(n, key), (
        n, prof["launches"], prof["host_launch_calls"],
        chip_smoke.G_DECODE_LAUNCHES[key])


def test_generate_with_int8_weights_runs_k5_on_gemvs_and_tc(cuda):
    """``generate()`` with int8 weights, bf16: K5 on the GEMVs for every
    decode step (M = 3 rows) and on ``tc`` for the prefill (M = 3 x 8);
    in f32 its greedy tokens equal ``generate_full_scan``'s and the dense
    engine's."""
    from ray_lightning_tpu_torch.models import generate, generate_full_scan
    prompts = [[5, 17, 3, 9, 1, 2, 3, 4], [9, 2, 44], [42, 7]]
    batch = np.zeros((3, 8), np.int64)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    lengths = np.array([len(p) for p in prompts])
    n = 6
    cfg, sd, _, _ = _spec_models(torch.bfloat16)
    model = TransformerLM(dataclasses.replace(cfg, matmul_kernel="cuda"),
                          device="meta").to_empty(device=cuda)
    model.load_state_dict(sd)
    model.quantize_weights("int8")
    qmm.reset_kernel_launches()
    out = generate(model, None, batch, n, 0, temperature=0.0,
                   prompt_lengths=lengths)
    assert out.shape == (3, 8 + n) and out.device.type == "cuda"
    assert qmm.route_launches() == {
        "gemv_dense": 4 * cfg.n_layers * (n - 1), "gemv_attend": n - 1,
        "tc": 4 * cfg.n_layers + 1, "tiled_f32": 0}
    cfg32, sd32, _, _ = _spec_models(torch.float32)
    m32 = TransformerLM(cfg32, device="meta").to_empty(device=cuda)
    m32.load_state_dict(sd32)
    kw = dict(temperature=0.0, prompt_lengths=lengths)
    split = generate(m32, None, batch, n, 0, **kw).cpu().numpy()
    full = generate_full_scan(m32, None, batch, n, 0, **kw).cpu().numpy()
    client = ServeClient(TransformerLM(cfg32, device="meta"), sd32,
                         num_slots=3, prefill_len=8, device=cuda)
    served = client.serve_trace([(0, dict(prompt=p, max_new_tokens=n))
                                 for p in prompts])
    for i, L in enumerate(lengths):
        assert split[i, L:L + n].tolist() == full[i, L:L + n].tolist()
        assert split[i, L:L + n].tolist() == served[i].tokens


def test_paged_attention_kernel_needs_page_native_on_the_card(cuda):
    """``attention_kernel="cuda"`` on a dense layout raises, as the JAX
    engine refuses its Pallas kernel without ``page_native=True``: never
    a quiet dense attention."""
    cfg, sd, _, _ = _spec_models(torch.bfloat16)
    for layout in ({}, dict(page_size=4)):
        with pytest.raises(ValueError, match="page_native=True"):
            ServeClient(TransformerLM(cfg, device="meta"), sd, num_slots=3,
                        prefill_len=8, attention_kernel="cuda", device=cuda,
                        **layout)


@pytest.mark.parametrize("layout", ["dense", "view"])
def test_spec_on_dense_layouts_equals_non_spec_in_f32(cuda, layout):
    """f32: spec (k = 4, a 1-layer draft) on the dense pool and on the
    dense view gives the non-spec engine's greedy tokens."""
    cfg, sd, dcfg, dsd = _spec_models(torch.float32)

    def run(**kw):
        client = ServeClient(TransformerLM(cfg, device="meta"), sd,
                             num_slots=4, prefill_len=8, device=cuda,
                             **DENSE_LAYOUTS[layout], **kw)
        out = client.serve_trace(list(SPEC_TRACE))
        rounds = client.engine.spec_rounds
        client.shutdown()
        return _tokens(out), rounds

    plain, _ = run()
    spec, rounds = run(draft_model=TransformerLM(dcfg, device="meta"),
                       draft_params=dsd, spec_k=4)
    assert rounds > 0 and spec == plain


# --------------------------- async dispatch and multi-LoRA serving (S5, S4)
ASYNC_TRACE = SPEC_TRACE + [
    (1, dict(prompt=[7, 3, 3], max_new_tokens=8, temperature=0.9, top_k=20,
             seed=5))]
ASYNC_ENGINES = {
    "page-native": dict(page_size=4, page_native=True,
                        attention_kernel="cuda"),
    "int8-weights": dict(page_size=4, page_native=True,
                         attention_kernel="cuda", weight_dtype="int8",
                         matmul_kernel="cuda"),
    "dense": {},
    "view": dict(page_size=4),
}


def _async_serve(cuda, cfg, sd, trace, **kw):
    client = ServeClient(TransformerLM(cfg, device="meta"), sd, num_slots=4,
                         prefill_len=8, device=cuda, **kw)
    out = client.serve_trace(list(trace))
    client.shutdown()
    return {r: (c.tokens, c.finish_reason) for r, c in out.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("engine", list(ASYNC_ENGINES) + ["spec"])
def test_async_tokens_bitwise_equal_sync_on_the_card(cuda, engine, dtype):
    """The pipelined client runs the same kernels on the same inputs as
    the sync client: tokens and finish reasons equal, greedy and
    sampled."""
    cfg, sd, dcfg, dsd = _spec_models(dtype)
    kw = dict(ASYNC_ENGINES.get(engine, ASYNC_ENGINES["page-native"]))
    if engine == "spec":
        kw.update(draft_model=TransformerLM(dcfg, device="meta"),
                  draft_params=dsd, spec_k=4)
    sync = _async_serve(cuda, cfg, sd, ASYNC_TRACE, **kw)
    assert _async_serve(cuda, cfg, sd, ASYNC_TRACE, async_dispatch=True,
                        **kw) == sync


@pytest.mark.parametrize("engine", list(ASYNC_ENGINES) + ["spec"])
def test_async_enqueue_makes_no_synchronizing_call(cuda, engine):
    """A steady-state ``step_enqueue`` (greedy rows; bf16) launches its
    dispatch without one synchronizing call: under
    ``torch.cuda.set_sync_debug_mode("error")`` any would raise."""
    from ray_lightning_tpu_torch.serve import ServeEngine
    from ray_lightning_tpu_torch.serve.request import Request
    cfg, sd, dcfg, dsd = _spec_models(torch.bfloat16)
    kw = dict(ASYNC_ENGINES.get(engine, ASYNC_ENGINES["page-native"]))
    if engine == "spec":
        kw.update(draft_model=TransformerLM(dcfg, device="meta"),
                  draft_params=dsd, spec_k=4)
    eng = ServeEngine(TransformerLM(cfg, device="meta"), sd, num_slots=4,
                      prefill_len=8, device=cuda, **kw)
    eng.prefill([Request(id=i, prompt=p["prompt"], max_new_tokens=40)
                 for i, (_, p) in enumerate(SPEC_TRACE)])
    pending = [eng.step_enqueue(), eng.step_enqueue()]
    eng.step_sync(pending.pop(0))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            pending.append(eng.step_enqueue())
            torch.cuda.set_sync_debug_mode(0)
            eng.step_sync(pending.pop(0))
            torch.cuda.set_sync_debug_mode("error")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eng.step_sync(pending.pop(0))
    assert not eng.carry_deferred
    eng.shutdown()


def test_lora_delta_equals_a_merged_weight_linear(cuda):
    """f32 on the card: a Dense with a bank gives, for each adapted row,
    ``F.linear`` by the merged weight W + scale * (A @ B)^T, to 1e-5 of
    the output's scale; a null row is the base projection bitwise."""
    from ray_lightning_tpu_torch.models.lora import LoraConfig
    from ray_lightning_tpu_torch.models.transformer import (Dense,
                                                            TransformerConfig)
    gen = torch.Generator().manual_seed(0)
    lora = LoraConfig(rank=16, num_adapters=4, alpha=32.0)
    layer = Dense(768, 2304, TransformerConfig(dtype=torch.float32), cuda,
                  lora=lora)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    x = torch.randn(4, 5, 768, generator=gen).to(cuda)
    ids = torch.tensor([2, -1, 0, 3], device=cuda)
    with torch.no_grad():
        got = layer(x, ids)
        base = torch.nn.functional.linear(x, layer.weight, layer.bias)
        assert torch.equal(got[1], base[1])
        for r in (0, 2, 3):
            a = int(ids[r])
            merged = layer.weight + lora.scale * (
                layer.lora_A[a] @ layer.lora_B[a]).T
            want = torch.nn.functional.linear(x[r], merged, layer.bias)
            err = (got[r] - want).abs().max().item()
            assert err <= 1e-5 * max(1.0, want.abs().max().item()), (r, err)


def _lora_adapters(model, n, seed):
    """``n`` random adapter trees for ``model``'s projections (rank 16)."""
    from ray_lightning_tpu_torch.models.lora import (LoraConfig,
                                                     extract_adapter,
                                                     install_lora_bank)
    probe = TransformerLM(model.cfg, device="cpu")
    install_lora_bank(probe, LoraConfig(rank=16, num_adapters=1))
    gen = torch.Generator().manual_seed(seed)

    def fill(t):
        return {k: fill(v) if isinstance(v, dict)
                else 0.2 * torch.randn(v.shape, generator=gen)
                for k, v in t.items()}
    tree = extract_adapter(probe, 0)
    return {f"ad{i}": fill(tree) for i in range(n)}


def test_adapted_int8_engine_routes_k5_as_the_bankless_engine(cuda):
    """bf16, int8 weights through K5: the bank adds no K5 launch (its
    delta is plain PyTorch outside the base matmuls) -- the route counts
    equal the bankless engine's on the same trace, the GEMVs at decode,
    ``tc`` at the prefills, none ``tiled_f32``; K1 once a layer a decode
    step."""
    cfg, sd, _, _ = _spec_models(torch.bfloat16)
    ads = _lora_adapters(TransformerLM(cfg, device="meta"), 2, 1)
    trace = [(t, dict(kw, adapter=("ad0", "ad1", None, "ad0")[i]))
             for i, (t, kw) in enumerate(SPEC_TRACE)]
    counts = []
    for bank in (None, ads):
        kw = dict(ASYNC_ENGINES["int8-weights"])
        if bank is not None:
            kw.update(adapters=bank, max_resident_adapters=4, lora_rank=16)
        qmm.reset_kernel_launches()
        pa.reset_kernel_launches()
        client = ServeClient(TransformerLM(cfg, device="meta"), sd,
                             num_slots=4, prefill_len=8, device=cuda, **kw)
        out = client.serve_trace(list(trace) if bank else [
            (t, {k: v for k, v in e.items() if k != "adapter"})
            for t, e in trace])
        eng = client.engine
        assert [len(out[r].tokens) for r in range(4)] == [10, 10, 10, 3]
        per_forward = 4 * cfg.n_layers + 1
        assert qmm.route_launches() == {
            "gemv_dense": 4 * cfg.n_layers * eng.decode_substeps,
            "gemv_attend": eng.decode_substeps,
            "tc": per_forward * eng.prefills, "tiled_f32": 0}
        assert pa.kernel_launches() == cfg.n_layers * eng.decode_substeps
        counts.append((qmm.route_launches(), eng.decode_substeps))
        client.shutdown()
    assert counts[0] == counts[1]


# ----------------------- serving reliability and observability (S6)
REPLAY_TRACE = ASYNC_TRACE + [
    (2, dict(prompt=[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8], max_new_tokens=6))]
#: engine -> (layout, fault site, ticks, rebuilds, recoveries): 4 slots,
#: prefill_len 16 (every prompt + emitted sequence of the trace fits the
#: batched prefill), f32
REPLAY_ENGINES = {
    "page-native": (dict(page_size=4, page_native=True,
                         attention_kernel="cuda"), "serve.dispatch",
                    [0, 3, 7], 3, 3),
    # the second crash lands on the first recovery's replay re-feed (a
    # failed attempt): 3 rebuilds in 2 recoveries
    "chunked-prefix": (dict(page_size=4, page_native=True,
                            attention_kernel="cuda", prefill_chunk=8,
                            prefix_cache=True), "serve.dispatch",
                       [1, 3, 12], 3, 2),
    "spec": (dict(page_size=4, page_native=True, attention_kernel="cuda"),
             "serve.verify", [1, 3], 2, 2),
    "int8-weights-async": (dict(ASYNC_ENGINES["int8-weights"],
                                async_dispatch=True), "serve.dispatch",
                           [4], 1, 1),
}


def _replay(cuda, engine, plan=None):
    """REPLAY_TRACE through ``chip_smoke.f_serve`` (a supervised client on
    the card, recording rebuilds) on ``engine``'s layout, f32."""
    import chip_smoke
    layout, *_ = REPLAY_ENGINES[engine]
    cfg, sd, dcfg, dsd = _spec_models(torch.float32)
    kw = dict(layout, num_slots=4, prefill_len=16)
    if engine == "spec":
        kw.update(draft_model=TransformerLM(dcfg, device="meta"),
                  draft_params=dsd, spec_k=4)
    return chip_smoke.f_serve(TransformerLM(cfg, device="meta"), sd,
                              REPLAY_TRACE, kw, plan)


@pytest.mark.parametrize("engine", sorted(REPLAY_ENGINES))
def test_crash_replay_identity_on_the_card(cuda, engine):
    """f32 with the kernels on: under the fault plan every request's
    tokens (greedy and sampled) equal the fault-free run's; the rebuilt
    engines launch the path's kernel (K1 at T = 1, K1 at T = 5, K2 in
    the chunk replays, K5); the card's allocated bytes are the same after
    every rebuild."""
    from ray_lightning_tpu_torch.reliability import FaultPlan
    _, site, ticks, rebuilds, recoveries = REPLAY_ENGINES[engine]
    base, _, _ = _replay(cuda, engine)
    done, counters, rec = _replay(cuda, engine, FaultPlan.at(site, ticks))
    assert (counters["fired"], counters["rebuilds"],
            counters["recoveries"], counters["failed_requests"]) == (
        len(ticks), rebuilds, recoveries, 0)
    assert {r: (c.tokens, c.finish_reason) for r, c in done.items()} == {
        r: (c.tokens, c.finish_reason) for r, c in base.items()}
    after = {key: {k: n - rec["at_first_rebuild"][key].get(k, 0)
                   for k, n in counts.items()}
             for key, counts in rec["launches"].items()}
    launched = {"page-native": after["k1_by_t"].get(1, 0),
                "spec": after["k1_by_t"].get(5, 0),
                "chunked-prefix": sum(sum(r["k2"].values())
                                      for r in rec["in_recovery"]),
                "int8-weights-async": sum(after["k5"].values())}[engine]
    assert launched > 0
    assert len(set(rec["rebuilt_bytes"])) == 1, rec["rebuilt_bytes"]


def _decode_dispatch_launches(cuda, telemetry):
    """Kernel launches of one profiled decode dispatch of the nano
    page-native engine (4 rows in flight), as ``chip_smoke.py`` counts
    them: the larger of the device's records and the host's launch
    calls."""
    import chip_smoke
    from torch.autograd import DeviceType
    from ray_lightning_tpu_torch.serve import ServeEngine
    from ray_lightning_tpu_torch.serve.request import Request
    cfg, sd, _, _ = _spec_models(torch.bfloat16)
    eng = ServeEngine(TransformerLM(cfg, device="meta"), sd, num_slots=4,
                      prefill_len=8, device=cuda, telemetry=telemetry,
                      **ASYNC_ENGINES["page-native"])
    eng.prefill([Request(id=i, prompt=p["prompt"], max_new_tokens=40)
                 for i, (_, p) in enumerate(SPEC_TRACE)])
    eng.step()
    events, _ = chip_smoke.profiled(eng.step)
    eng.shutdown()
    device = sum(a.count for a in events if a.device_type == DeviceType.CUDA)
    host = sum(a.count for a in events
               if a.key in chip_smoke.G_HOST_LAUNCH_CALLS)
    return max(device, host)


def test_armed_telemetry_adds_no_launch_and_no_sync(cuda):
    """Armed telemetry builds every payload from host state: a decode
    dispatch launches what the disarmed one does, and a steady-state
    enqueue makes no synchronizing call."""
    import time
    from ray_lightning_tpu_torch.obs import Telemetry
    from ray_lightning_tpu_torch.serve import ServeEngine
    from ray_lightning_tpu_torch.serve.request import Request
    tel = Telemetry(clock=time.perf_counter)
    assert _decode_dispatch_launches(cuda, tel) == \
        _decode_dispatch_launches(cuda, None)
    assert tel.events("engine.step")
    cfg, sd, _, _ = _spec_models(torch.bfloat16)
    eng = ServeEngine(TransformerLM(cfg, device="meta"), sd, num_slots=4,
                      prefill_len=8, device=cuda, telemetry=tel,
                      **ASYNC_ENGINES["page-native"])
    eng.prefill([Request(id=i, prompt=p["prompt"], max_new_tokens=40)
                 for i, (_, p) in enumerate(SPEC_TRACE)])
    pending = [eng.step_enqueue()]
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending.append(eng.step_enqueue())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for p in pending:
        eng.step_sync(p)
    eng.shutdown()
    assert len(tel.events("engine.dispatch_synced")) == 2


# ------------------------------------------------- the health of a fit
class _EventStart(Callback):
    """Records a CUDA event at each training batch's start hook (list it
    after the callback whose clock it must not precede)."""

    def __init__(self, pairs):
        self.pairs = pairs

    def on_train_batch_start(self, trainer, module, batch, idx):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self.pairs.append([start, None])


class _EventEnd(Callback):
    """Records a CUDA event at each training batch's end hook (list it
    before the callback that synchronizes there)."""

    def __init__(self, pairs):
        self.pairs = pairs

    def on_train_batch_end(self, trainer, module, outputs, batch, idx):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.pairs[-1][1] = end


def test_stepstats_block_covers_the_steps_device_time(cuda, tmp_path):
    """``StepStatsCallback(block=True)`` synchronizes the card before it
    reads its clock: each step's ``step_time_ms`` is at least the CUDA
    events' time between the same hooks (a step timed at its enqueue
    would read less on an asynchronous card)."""
    from ray_lightning_tpu_torch import StepStatsCallback

    class Record(Callback):
        def __init__(self):
            self.ms = []

        def on_train_batch_end(self, trainer, module, outputs, batch, idx):
            self.ms.append(trainer.callback_metrics["step_time_ms"])

    # device interval inside the callback's: the start event recorded
    # after its clock reads, the end event before its synchronize
    pairs, rec = [], Record()
    _card_fit(tmp_path, _nano_bf16(), limit_val_batches=0,
              callbacks=[_EventEnd(pairs), StepStatsCallback(block=True),
                         _EventStart(pairs), rec])
    torch.cuda.synchronize()
    device_ms = [s.elapsed_time(e) for s, e in pairs]
    assert len(rec.ms) == len(device_ms) == 8
    for host, dev in zip(rec.ms, device_ms):
        assert host >= dev, (host, dev)


def test_memory_tier_holds_only_host_tensors(cuda, tmp_path):
    """A fit on the card with a ``MemoryCheckpointStore`` installed:
    every tensor the store holds is in CPU memory (never a CUDA tensor,
    whose IPC handle would die with its process), equal to the live
    state it copies, and the put's bytes are recorded."""
    from ray_lightning_tpu_torch import ModelCheckpoint
    from ray_lightning_tpu_torch.reliability import MemoryCheckpointStore

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from leaves(v)
        elif isinstance(tree, torch.Tensor):
            yield tree

    store = MemoryCheckpointStore(keep_last=1)
    with store.installed():
        t = _card_fit(tmp_path, _nano_bf16(), limit_val_batches=0,
                      callbacks=[ModelCheckpoint(
                          dirpath=str(tmp_path / "ck"))])
    (step, ckpt), = store.resume_candidates(copy_payloads=False)
    assert step == t.global_step
    held = list(leaves(ckpt))
    assert held and all(x.device.type == "cpu" for x in held)
    for name, p in t.model.state_dict().items():
        assert p.device.type == "cuda"
        assert torch.equal(ckpt["state"]["params"][name], p.cpu()), name
    nbytes, _s = t.memory_puts[-1]
    assert nbytes == sum(x.numel() * x.element_size() for x in held)


def test_armed_fit_launches_what_a_disarmed_one_does(cuda, tmp_path):
    """Telemetry, ``StepStatsCallback`` and the profiler add no kernel
    launch to a fit: K2-K4 launch as often, on the same routes."""
    from ray_lightning_tpu_torch import StepStatsCallback
    from ray_lightning_tpu_torch.obs import Telemetry
    counts = {}
    for armed in (False, True):
        tel = Telemetry() if armed else None
        cf.reset_kernel_launches()
        _card_fit(tmp_path / str(armed), _nano_bf16(), telemetry=tel,
                  profiler="simple" if armed else None,
                  callbacks=[StepStatsCallback(tel)] if armed else [])
        counts[armed] = {k: cf.route_launches(k) for k in cf.KERNELS}
        if armed:
            sites = [e.site for e in tel.events()]
            assert sites[0] == "launch.start" and "fit.end" in sites
    assert counts[True] == counts[False]
    assert counts[True]["flash_fwd"]["tc"] > 0


# ------------------------------ the input pipeline and the fleet (T7c, S8a)
def _ring_loader(n=64, batch=8):
    from ray_lightning_tpu_torch.data import ArrayDataset, DataLoader
    x = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    y = np.arange(n, dtype=np.int64)
    return DataLoader(ArrayDataset((x, y)), batch_size=batch, shuffle=True,
                      seed=7)


def test_ring_loader_spawns_its_producers_once_cuda_is_live(cuda):
    from ray_lightning_tpu_torch.data import MultiprocessDataLoader
    torch.zeros(1, device=cuda)
    assert torch.cuda.is_initialized()
    loader = MultiprocessDataLoader(_ring_loader(), num_workers=2,
                                    auto_fallback=False)
    assert loader.mp_context == "spawn" and loader.uses_ring
    got = list(loader)
    want = list(_ring_loader())
    assert len(got) == len(want) == 8
    for (gx, gy), (wx, wy) in zip(got, want):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


def test_device_prefetcher_copies_on_a_side_stream(cuda):
    from ray_lightning_tpu_torch.data import DevicePrefetcher
    pref = DevicePrefetcher(_ring_loader(), depth=2)
    want = list(_ring_loader())
    got = []
    for x, y in pref:
        assert x.is_cuda and y.is_cuda and x.dtype == torch.float32
        # work queued on the consumer's stream reads the copied values
        got.append(((x * 1).cpu().numpy(), (y + 0).cpu().numpy()))
    assert pref._stream is not None
    assert pref._stream != torch.cuda.current_stream()
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    assert pref.copies == 2 * len(want)
    assert pref.bytes == sum(x.nbytes + y.nbytes for x, y in want)
    torch.cuda.synchronize()
    pref._recycle()
    pinned = [b for bufs in pref._free.values() for b in bufs]
    # buffers went back to the pool and were reused: never one per batch
    assert pinned and all(b.is_pinned() for b in pinned)
    assert len(pinned) <= 2 * (pref.depth + 2) < 2 * len(want)
    # a batch already on the card passes through with no copy
    on_card = (torch.ones(2, device=cuda),)
    (same,), = list(DevicePrefetcher([on_card]))
    assert same.data_ptr() == on_card[0].data_ptr()


def _fleet_models():
    cfg, sd, _, _ = _spec_models(torch.float32)
    return TransformerLM(cfg, device="meta"), sd


FLEET_LAYOUT = dict(num_slots=2, prefill_len=16, page_size=4,
                    page_native=True, attention_kernel="cuda")


def test_two_replica_fleet_tokens_equal_one_clients(cuda):
    from ray_lightning_tpu_torch.serve import ReplicaFleet
    proto, sd = _fleet_models()
    client = ServeClient(proto, sd, device=cuda, **dict(FLEET_LAYOUT,
                                                        num_slots=8))
    want = client.serve_trace(list(ASYNC_TRACE))
    client.shutdown()
    pa.reset_kernel_launches()
    fleet = ReplicaFleet(proto, sd, num_replicas=2, device=cuda,
                         **FLEET_LAYOUT)
    got = fleet.serve_trace(list(ASYNC_TRACE))
    fleet.shutdown()
    assert {r: c.tokens for r, c in got.items()} == {
        r: c.tokens for r, c in want.items()}
    assert pa.kernel_launches() > 0


def test_fleet_failover_keeps_tokens_and_frees_the_dead_replica(cuda):
    """The live tensors' bytes once the promoted replica has decoded equal
    those at the crash (the allocator's own few MB outside any tensor may
    move: ``chip_smoke.n_allocated``)."""
    import chip_smoke
    from ray_lightning_tpu_torch.reliability import FaultPlan
    from ray_lightning_tpu_torch.serve import ReplicaFleet
    proto, sd = _fleet_models()
    base = ReplicaFleet(proto, sd, num_replicas=2, device=cuda,
                        **FLEET_LAYOUT)
    want = base.serve_trace(list(ASYNC_TRACE))
    base.shutdown()
    del base
    fleet = ReplicaFleet(proto, sd, num_replicas=2, num_standby=1,
                         device=cuda, **FLEET_LAYOUT)
    seen = {}
    fail, tick = fleet._fail_replica, fleet.tick
    allocated = chip_smoke.n_allocated

    def failing(rep, *, dead):
        seen["victim_decoded"] = rep.client.engine.decode_substeps > 0
        seen["at_crash"] = allocated()
        out = fail(rep, dead=dead)
        seen["promoted"] = fleet._replicas[-1].client.engine
        return out

    def ticking():
        # measured once the promoted replica has decoded: an engine keeps
        # a few device buffers of its last dispatches
        out = tick()
        if "promoted" in seen and seen["promoted"].decode_substeps:
            fleet.standby._refill_thread.join(timeout=60)
            seen["after"] = allocated()
            del seen["promoted"]
        return out

    fleet._fail_replica, fleet.tick = failing, ticking
    # fire 5: tick 2's second turn, replica 1 after its prefill and a
    # decode step (what the promoted replica has done when measured)
    with FaultPlan.at("serve.replica", [5]).armed():
        got = fleet.serve_trace(list(ASYNC_TRACE))
    assert fleet.failovers == 1 and seen["victim_decoded"]
    assert {r: c.tokens for r, c in got.items()} == {
        r: c.tokens for r, c in want.items()}
    crash, after = seen["at_crash"], seen["after"]
    assert after["tensors"] == crash["tensors"], seen
    assert abs(after["allocated"] - crash["allocated"]) < \
        chip_smoke.N_ALLOCATOR_SLACK, seen
    fleet.shutdown()


def _worker_k1(fleet, n_layers):
    """K1's launches the fleet's gracefully stopped workers report, each
    n_layers per decode step (one engine a process)."""
    total = 0
    for st in fleet.final_stats.values():
        n = {t: c for t, c in st["kernel_launches"]["paged_attention"]
             .items() if c}
        assert set(n) <= {1} and n.get(1, 0) == n_layers \
            * st["decode_steps"], st
        total += n.get(1, 0)
    return total


def test_process_fleet_on_the_card_tokens_equal_one_clients(cuda):
    """Two worker processes on the card, each with its own CUDA context:
    f32 tokens (greedy and sampled) equal one in-process client's, K1
    launched inside the workers, no worker left."""
    from ray_lightning_tpu_torch.serve import ReplicaFleet
    proto, sd = _fleet_models()
    client = ServeClient(proto, sd, device=cuda, **dict(FLEET_LAYOUT,
                                                        num_slots=8))
    want = client.serve_trace(list(ASYNC_TRACE))
    client.shutdown()
    fleet = ReplicaFleet(proto, sd, backend="process", num_replicas=2,
                         device=cuda, **FLEET_LAYOUT)
    try:
        # ticks as hundredths of a second: the process fleet's clock
        got = fleet.serve_trace([(t * 0.01, kw) for t, kw in ASYNC_TRACE])
    finally:
        backend = fleet.process_backend
        fleet.shutdown()
    assert backend.live_actor_count() == 0
    assert {r: c.tokens for r, c in got.items()} == {
        r: c.tokens for r, c in want.items()}
    assert sorted(fleet.final_stats) == [0, 1]
    assert _worker_k1(fleet, proto.cfg.n_layers) > 0


def test_process_fleet_contains_a_sticky_cuda_error(cuda):
    """A prompt id outside the vocab trips a device-side assert in the
    worker that seats it, a sticky error of that process's context: the
    worker reports the CUDA error, is killed and replaced, its request
    retires ``failed`` (one failover allowed); the other worker, decoding
    meanwhile, survives and serves its requests to one client's tokens."""
    from ray_lightning_tpu_torch.obs import Telemetry
    from ray_lightning_tpu_torch.serve import FleetConfig, ReplicaFleet
    proto, sd = _fleet_models()
    good = [dict(prompt=[5, 17, 3, 9], max_new_tokens=40),
            dict(prompt=[9, 2, 44], max_new_tokens=40)]
    client = ServeClient(proto, sd, device=cuda, **dict(FLEET_LAYOUT,
                                                        num_slots=8))
    want = client.serve_trace([(0, kw) for kw in good])
    client.shutdown()
    tel = Telemetry()
    fleet = ReplicaFleet(proto, sd, backend="process", num_replicas=2,
                         device=cuda, telemetry=tel,
                         fleet_config=FleetConfig(max_request_failovers=1),
                         **FLEET_LAYOUT)
    try:
        survivor = fleet._replicas[0]
        pid = survivor.actor._proc.pid
        ids = [fleet.submit(**good[0]),             # replica 0
               fleet.submit(prompt=[3, proto.cfg.vocab_size + 5, 1],
                            max_new_tokens=4),      # replica 1, alone
               fleet.submit(**good[1])]             # replica 0 (id tie)
        out = fleet.run_until_idle()
        assert survivor in fleet._replicas and \
            survivor.actor._proc.pid == pid and survivor.actor._proc.is_alive()
    finally:
        backend = fleet.process_backend
        fleet.shutdown()
    assert backend.live_actor_count() == 0
    assert out[ids[1]].finish_reason == "failed" and fleet.poison_failed == 1
    assert fleet.failovers == 1 and not tel.events("replica.dead")
    (err,) = tel.events("replica.error")
    assert err.payload["replica"] == 1
    assert "CUDA error" in err.payload["detail"], err.payload
    assert [out[ids[0]].tokens, out[ids[2]].tokens] == [
        want[0].tokens, want[1].tokens]
    assert survivor.id in fleet.final_stats
    assert _worker_k1(fleet, proto.cfg.n_layers) > 0
