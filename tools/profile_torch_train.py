"""Where a training step of the PyTorch/CUDA port's training path spends its time.

    python3 tools/profile_torch_train.py [--steps 5] [--warmup 3]
        [--dropout 0.1] [--remat [--remat-policy NAME]] [--untied]
        [--seq-len 1024] [--batch 8] [--impl flash|dot]

Needs one NVIDIA GPU. Runs the training path of ``chip_smoke.py`` phase
T2 (GPT-2-small at full width, ``attention_impl="flash"``, batch 8 x 1024
tokens, bf16 compute over f32 master weights, AdamW, ``Trainer(seed=0)``,
no validation) for ``--warmup`` steps, then ``--steps`` steps timed on the
host clock alone (synchronized at both ends), then ``--steps`` more under
``torch.profiler`` (CPU and CUDA activity). Prints one JSON line with the
card, the host ms per step, the device's busy ms per step (sum of kernel
times in the profile), the device's idle share (1 - busy / host ms of the
unprofiled window), kernel launches per step, the flash-attention kernels'
device ms per step (all, the forward's and the backward's) and launches by
kernel,
and the kernels that take the most device time. ``--dropout``,
``--remat``, ``--remat-policy`` and ``--untied`` set the config's
``dropout``, ``remat``, ``remat_policy`` and ``tie_embeddings=False``;
the line then also gives the peak device memory. ``--seq-len`` (the
config's ``max_seq_len`` too), ``--batch`` and ``--impl``
(``attention_impl``: the flash kernels or the plain ``dot`` attention)
set the shape and the attention; a fit that runs out of device memory
prints one JSON line with ``out_of_memory`` true, the error and the peak
memory reached, and exits 0.
"""
import argparse
import json
import os
import re
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke  # noqa: E402
from ray_lightning_tpu_torch import (GPTModule, RayStrategy,  # noqa: E402
                                     Trainer, gpt2_config)
from ray_lightning_tpu_torch.core import LambdaCallback  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--untied", action="store_true")
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--impl", default="flash", choices=["flash", "dot"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    n = args.steps
    timed = (args.warmup, args.warmup + n)          # [start, stop) batches
    profiled = (args.warmup + n, args.warmup + 2 * n)
    marks = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    profiling = []                  # [True] while the window is open

    def on_start(trainer, module, batch, idx):
        if idx in (timed[0], profiled[0]):
            torch.cuda.synchronize()
            marks[idx] = time.perf_counter()
        if idx == profiled[0]:
            prof.start()
            profiling.append(True)

    def on_end(trainer, module, outputs, batch, idx):
        if idx + 1 in (timed[1], profiled[1]):
            torch.cuda.synchronize()
            marks[idx + 1] = time.perf_counter()
        if idx + 1 == profiled[1]:
            prof.stop()
            profiling.clear()

    cfg = gpt2_config("small", attention_impl=args.impl,
                      max_seq_len=args.seq_len, dropout=args.dropout,
                      remat=args.remat, remat_policy=args.remat_policy,
                      tie_embeddings=not args.untied)
    shape = dict(card=chip_smoke.card_line(), batch=args.batch,
                 seq_len=args.seq_len, impl=args.impl, steps=n,
                 dropout=args.dropout, remat=args.remat,
                 remat_policy=args.remat_policy, untied=args.untied)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(strategy=RayStrategy(num_workers=1), max_epochs=1,
                      limit_train_batches=profiled[1], limit_val_batches=0,
                      seed=0, callbacks=[LambdaCallback(
                          on_train_batch_start=on_start,
                          on_train_batch_end=on_end)])
    try:
        trainer.fit(GPTModule(config=cfg, batch_size=args.batch,
                              seq_len=args.seq_len))
    except torch.cuda.OutOfMemoryError as err:
        if profiling:
            prof.stop()
        print(json.dumps(dict(
            shape, out_of_memory=True, error=str(err).splitlines()[0],
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            steps_done=trainer.global_step)), flush=True)
        return 0

    host_ms = 1e3 * (marks[timed[1]] - marks[timed[0]]) / n
    # device kernels only: user annotations (e.g. the optimizer's
    # "Optimizer.step" range) also land on the CUDA timeline and would
    # count the kernels inside them twice
    kernels = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA
               and not getattr(a, "is_user_annotation", False)]
    busy_us = sum(a.self_device_time_total for a in kernels)
    # the flash kernels by their source names (flash_fwd_tc_kernel,
    # flash_fwd_kernel, flash_bwd_dkv_tc_kernel, flash_bwd_dkv_kernel,
    # flash_bwd_dq_tc_kernel, flash_bwd_dq_kernel)
    flash = [a for a in kernels if re.search(r"flash_\w*_kernel", a.key)]
    flash_us = sum(a.self_device_time_total for a in flash)
    fwd_us = sum(a.self_device_time_total for a in flash
                 if "flash_fwd" in a.key)
    flash_launches = {}
    for a in flash:
        name = re.search(r"flash_\w*_kernel", a.key).group(0)
        flash_launches[name] = flash_launches.get(name, 0) + a.count / n
    top = sorted(kernels, key=lambda a: -a.self_device_time_total)[:12]
    measured = bool(kernels)
    out = dict(
        shape, out_of_memory=False,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        host_ms_per_step=host_ms,
        profiled_host_ms_per_step=1e3 * (marks[profiled[1]]
                                         - marks[profiled[0]]) / n,
        device_busy_ms_per_step=(busy_us / 1e3 / n if measured
                                 else "not measured"),
        device_idle_share=(1 - busy_us / 1e3 / n / host_ms if measured
                           else "not measured"),
        kernel_launches_per_step=sum(a.count for a in kernels) / n,
        flash_kernels_ms_per_step=(flash_us / 1e3 / n if measured
                                   else "not measured"),
        flash_share_of_busy=(flash_us / busy_us if measured
                             else "not measured"),
        flash_fwd_ms_per_step=(fwd_us / 1e3 / n if measured
                               else "not measured"),
        flash_bwd_ms_per_step=((flash_us - fwd_us) / 1e3 / n if measured
                               else "not measured"),
        flash_launches_per_step=flash_launches,
        top_kernels=[dict(name=a.key[:90], ms_per_step=(
            a.self_device_time_total / 1e3 / n),
            launches_per_step=a.count / n) for a in top])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
