"""The port's CUDA kernels on the card (skipped without one).

These tests import neither jax nor the JAX package, so they run where
only PyTorch is installed::

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Each kernel is held against its plain PyTorch version on the same
inputs. Paged attention: f32 to 1e-5 (only the order of the f32 sums
differs), bf16 to 2e-2 (both round the softmax weights and the output to
bf16 at the same points; a summation-order difference can flip one such
rounding, one bf16 ulp of an output below 4). Flash attention (K2-K4):
see ``FLASH_TOL``. ``chip_smoke.py`` repeats this at the serving and
training paths' full shapes.
"""
import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import GPTModule, RayStrategy, Trainer
from ray_lightning_tpu_torch.models import paged_attention as pa
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.ops import cuda_flash as cf
from ray_lightning_tpu_torch.models.quant import kv_quantize, kv_scales
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
def flash_tol(dtype, name: str, ref: torch.Tensor, grad: bool) -> float:
    """Bound on |kernel - plain| for one output.

    f32: the kernels sum in another order (tiles of 64, an online softmax
    whose running maximum rescales earlier tiles) -- 1e-5 for out and lse,
    1e-4 of the largest magnitude for a gradient summed over up to S or T
    terms. lse is f32 sums of exact products in both dtypes: 1e-5 (rows
    that admit no key are 1e30 in both, exactly). bf16: the softmax weights are rounded to bf16 relative to the
    running maximum in the kernel and to the final one in the plain
    version, p and ds are rounded before each product, and each output is
    rounded once: 2e-2 of max(1, largest magnitude) (one output rounding
    is at most 2**-8 of it, one flipped rounding 2**-7)."""
    if name == "lse":
        return 1e-5
    top = float(ref.float().abs().max())
    if dtype == torch.float32:
        return 1e-4 * max(top, 1e-30) if grad else 1e-5
    return 2e-2 * max(1.0, top)


def _flash_inputs(B, T, S, H, D, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    # q, k and v as views of one fused projection, the model's layout
    qkv = torch.randn(B, T, 3, H, D, generator=g)
    kv = torch.randn(B, S, 2, H, D, generator=g)
    do = torch.randn(B, T, H, D, generator=g)
    qkv, kv, do = (x.to(dtype).to(device) for x in (qkv, kv, do))
    return qkv[:, :, 0], kv[:, :, 0], kv[:, :, 1], do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T,S,D", [(64, 64, 64), (100, 100, 32),
                                   (96, 160, 128), (80, 48, 64)],
                         ids=["square", "ragged", "t<s", "empty-rows"])
def test_flash_kernels_match_plain(cuda, dtype, causal, T, S, D):
    q, k, v, do = _flash_inputs(2, T, S, 3, D, dtype, cuda)
    before = cf.kernel_launches()
    out, lse = cf.flash_fwd(q, k, v, causal)
    delta = cf.flash_delta(out, do)
    dk, dv = cf.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq = cf.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    after = cf.kernel_launches()
    assert all(after[n] == before[n] + 1 for n in cf.KERNELS)
    ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, causal)
    # the same inputs for both: the kernel's lse and delta
    ref_dk, ref_dv = cf.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                causal)
    ref_dq = cf.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    for name, got, ref, grad in (("out", out, ref_out, False),
                                 ("lse", lse, ref_lse, False),
                                 ("dq", dq, ref_dq, True),
                                 ("dk", dk, ref_dk, True),
                                 ("dv", dv, ref_dv, True)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert bool(torch.isfinite(got).all()), name
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=flash_tol(dtype, name, ref, grad),
                                   msg=name)
    if causal and T > S:
        # rows that admit no key: out 0, lse 1e30, no gradient
        empty = T - S
        assert torch.count_nonzero(out[:, :empty]) == 0
        assert bool((lse[:, :, :empty] == 1e30).all())
        assert torch.count_nonzero(dq[:, :empty]) == 0


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
    assert np.isfinite(trainer.callback_metrics["val_loss"])
