"""Where a decode, prefill, chunk or spec dispatch of the PyTorch/CUDA port's serving path spends its time.

    python3 tools/profile_torch_serve.py [--kv-dtype int8] [--steps 20]
        [--weight-dtype int8|int4] [--matmul-kernel cuda|torch]
        [--phase decode|prefill|chunk|spec]

Needs one NVIDIA GPU. Builds the serving path of ``chip_smoke.py`` phase 2
(GPT-2-small at full width, random weights from
``np.random.default_rng(0)``, 8 slots, page_size 16, page-native,
``attention_kernel="cuda"``; ``--weight-dtype`` quantizes the weights and
``--matmul-kernel`` picks the quantized matmuls' path, the fused kernel
by default), admits the trace's first 8 requests, runs 5
decode dispatches to warm up, then times ``--steps`` dispatches twice:
once on the host clock alone, once under ``torch.profiler`` (CPU and CUDA
activity). ``--phase prefill`` times prefill dispatches instead: the
trace's first 8 prompts admitted together (one dispatch of 8 x 128
tokens, ending in the first tokens' host copy), then cancelled -- 3
times to warm up, then ``--steps`` times in each window, the cancels
outside the host timing. ``--phase chunk`` times chunk dispatches of
``chip_smoke.py`` phase L's engine (``prefill_chunk=128``, the prefix
cache off so nothing is adopted): the chunks of the phase's first
896-token prompt in turn (keys 128 to 896), each followed by a
synchronize inside the timing (a chunk that is not the last ends in no
host copy); the request is cancelled after its last chunk and admitted
again, outside the timing. ``--phase spec`` times speculative dispatches
of ``chip_smoke.py`` phase S's engine (its 2-layer draft cut from the
target, ``spec_k=4``, one round a dispatch; ``--weight-dtype`` quantizes
the draft too) over the same 8 admitted requests, as decode does (the
first dispatch's draft refills fall in the warm-up). Prints one JSON
line with the card, the host ms per dispatch, the device's busy ms per
dispatch (sum of kernel times in the profile), the device's idle share
(1 - busy / host ms of the unprofiled window), kernel launches per
dispatch and the kernels that take the most device time.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke  # noqa: E402
from ray_lightning_tpu_torch.interop import load_flax_params  # noqa: E402
from ray_lightning_tpu_torch.models import (TransformerLM,  # noqa: E402
                                            gpt2_config)
from ray_lightning_tpu_torch.serve import ServeEngine  # noqa: E402
from ray_lightning_tpu_torch.serve.request import Request  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kv-dtype", default=None, choices=[None, "int8"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--weight-dtype", default=None,
                    choices=[None, "int8", "int4"])
    ap.add_argument("--matmul-kernel", default=None,
                    choices=[None, "cuda", "torch"])
    ap.add_argument("--phase", default="decode",
                    choices=["decode", "prefill", "chunk", "spec"])
    args = ap.parse_args()
    matmul_kernel = args.matmul_kernel
    if args.weight_dtype is not None and matmul_kernel is None:
        matmul_kernel = "cuda"
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt2_config("small")
    rng = np.random.default_rng(0)
    sd = load_flax_params(TransformerLM(cfg, device="cpu"),
                          chip_smoke.random_flax_params(cfg, rng)
                          ).state_dict()
    trace = chip_smoke.make_trace(rng, cfg.vocab_size)
    serve = (dict(chip_smoke.L_SERVE, prefix_cache=False)
             if args.phase == "chunk" else chip_smoke.SERVE)
    spec = {}
    if args.phase == "spec":
        spec = dict(chip_smoke.spec_kw(
            gpt2_config("small", n_layers=chip_smoke.S_DRAFT_LAYERS),
            chip_smoke.draft_state(sd, chip_smoke.S_DRAFT_LAYERS)),
            draft_weight_dtype=args.weight_dtype)
    eng = ServeEngine(TransformerLM(cfg, device="meta"), sd,
                      device="cuda", attention_kernel="cuda",
                      kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype,
                      matmul_kernel=matmul_kernel, **serve, **spec)
    rounds = iter(range(1 << 30))

    def admit():
        """The trace's first 8 requests, under fresh ids, in one prefill
        dispatch (it ends in a host copy)."""
        base = 8 * next(rounds)
        reqs = [Request(id=base + i, prompt=kw["prompt"], max_new_tokens=64,
                        temperature=kw.get("temperature", 0.0),
                        top_k=kw.get("top_k"))
                for i, (_, kw) in enumerate(trace[:8])]
        eng.prefill(reqs)
        return reqs

    if args.phase in ("decode", "spec"):
        admit()

        def dispatch() -> float:
            t = time.perf_counter()
            eng.step()                  # ends in a host copy
            return time.perf_counter() - t
        warmup = 5
    elif args.phase == "chunk":
        long_trace, kinds = chip_smoke.make_long_trace(rng, cfg.vocab_size)
        prompt = long_trace[kinds.index("long")][1]["prompt"]
        held = []

        def dispatch() -> float:
            if not eng.chunk_pending:   # admit the prompt again, untimed
                for r in held:
                    eng.cancel(r.id)
                held[:] = [Request(id=next(rounds), prompt=prompt,
                                   max_new_tokens=64)]
                eng.prefill(held)
            t = time.perf_counter()
            eng.prefill_chunk_step()
            torch.cuda.synchronize()
            return time.perf_counter() - t
        warmup = 7
    else:
        def dispatch() -> float:
            t = time.perf_counter()
            reqs = admit()              # ends in the first tokens' copy
            spent = time.perf_counter() - t
            for r in reqs:              # free the slots, outside the timing
                eng.cancel(r.id)
            return spent
        warmup = 3
    for _ in range(warmup):
        dispatch()
    host_ms = 1e3 * sum(dispatch() for _ in range(args.steps)) / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            dispatch()
        torch.cuda.synchronize()
    kernels = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA]
    busy_us = sum(a.self_device_time_total for a in kernels)
    top = sorted(kernels, key=lambda a: -a.self_device_time_total)[:10]
    n = args.steps
    out = dict(
        card=chip_smoke.card_line(), phase=args.phase,
        kv_dtype=args.kv_dtype or "bf16",
        weight_dtype=args.weight_dtype or "f32", matmul_kernel=matmul_kernel,
        param_bytes=eng.param_bytes(),
        slots=8, dispatches=n, host_ms_per_dispatch=host_ms,
        device_busy_ms_per_dispatch=(busy_us / 1e3 / n if kernels
                                     else "not measured"),
        device_idle_share=(1 - busy_us / 1e3 / n / host_ms if kernels
                           else "not measured"),
        kernel_launches_per_dispatch=sum(a.count for a in kernels) / n,
        top_kernels=[dict(name=a.key[:80], ms_per_dispatch=(
            a.self_device_time_total / 1e3 / n),
            launches_per_dispatch=a.count / n) for a in top])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
