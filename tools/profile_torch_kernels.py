"""Time the port's K1-K5 kernels at the main paths' shapes, for one checkout.

    python3 tools/profile_torch_kernels.py [--tree DIR]

Needs one NVIDIA GPU. Imports ``ray_lightning_tpu_torch`` from ``--tree``
(default: this checkout), builds its kernels and times, with
``chip_smoke.py``'s cold-L2 timing (median of 50 launches, a 256 MB
memset and a device spin before each):

- K1, paged attention, at ``chip_smoke.py`` phase 1's bf16 T=1 shape
  (``attention_inputs``: 8 rows, 12 heads, D=64, 64 pages of 16 a slot,
  positions spread over 0..1000), with bf16 and with int8 pages;
- K5 at decode: one decode step's 49 calls at M=8 (12 x qkv, out, up,
  down and the tied head) with bf16 x, int8 and int4 codes, summed;
- K2, the flash forward, and K3 (dK/dV) and K4 (dQ), the flash
  backward, at the training path's shapes: bf16, B=8, T=S=1024, H=12,
  D=64, causal, q/k/v views of fused projections, dO and the forward's
  lse and delta;
- K5 at prefill: one forward's 49 calls at M=1024 (12 x qkv, out, up,
  down and the tied head) with bf16 x, int8 and int4 codes, summed.

The wrappers' Python API is the same in every checkout of the port, so
two versions compare on one card by running this once per tree in one
command, in turns -- parent, change, change, parent -- with the parent
unpacked by ``git archive`` into a directory ``.gitignore`` lists.
Prints one JSON line: the card, the tree, and the times.
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _chip_smoke():
    """This checkout's ``chip_smoke`` (its timing, shapes and inputs),
    whatever tree the port is imported from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose ray_lightning_tpu_torch is timed")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    from ray_lightning_tpu_torch import _build
    from ray_lightning_tpu_torch.models import paged_attention as pa
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    from ray_lightning_tpu_torch.models.quant import (matmul_view,
                                                      quantize_params)
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    if not os.path.abspath(_build.__file__).startswith(tree):
        raise RuntimeError(f"imported the port from {_build.__file__}, "
                           f"not from {tree}")
    _build.build(_build.SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    out = dict(card=cs.card_line(), tree=tree)
    gen = torch.Generator().manual_seed(0)
    for pages, quantized in (("bf16", False), ("int8", True)):
        args = cs.attention_inputs(torch.bfloat16, quantized, 1, gen)
        out[f"k1_{pages}_pages_ms"] = cs.time_ms(
            lambda: pa.paged_attention(*args), flush)
    q, k, v, do = cs.flash_inputs(torch.bfloat16, 8, 1024, 1024)
    o, lse = cf.flash_fwd(q, k, v, True)
    delta = cf.flash_delta(o, do)
    out.update(k2_path_ms=cs.time_ms(lambda: cf.flash_fwd(q, k, v, True),
                                     flush),
               k3_path_ms=cs.time_ms(lambda: cf.flash_bwd_dkv(
                   q, k, v, do, lse, delta, True), flush),
               k4_path_ms=cs.time_ms(lambda: cf.flash_bwd_dq(
                   q, k, v, do, lse, delta, True), flush))
    del q, k, v, do, o, lse, delta
    gen = torch.Generator(device="cuda").manual_seed(0)
    for weight_dtype in ("int8", "int4"):
        totals = {8: 0.0, 1024: 0.0}
        for label, shape, transpose in cs.PROJECTIONS:
            w = torch.randn(shape, generator=gen, device="cuda") * 0.02
            qt = quantize_params({"w": w}, weight_dtype)["w"]
            _, _, K, _ = matmul_view(qt, transpose)
            calls = 1 if label == "head" else 12
            for M in totals:
                x = torch.randn(M, K, generator=gen,
                                device="cuda").to(torch.bfloat16)
                totals[M] += calls * cs.time_ms(
                    lambda: qmm.quantized_matmul(x, qt, transpose), flush)
        out[f"k5_decode_step_{weight_dtype}_ms"] = totals[8]
        out[f"k5_prefill_forward_{weight_dtype}_ms"] = totals[1024]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
