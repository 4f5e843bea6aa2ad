"""Data parallelism across the cards of one host: the port's four strategies against one card.

    python3 tools/profile_torch_dp.py [--workers 4] [--steps 8] [--batch-per-worker 8]
                                      [--optimizers adamw,adamw_bf16m,adafactor]
    python3 tools/profile_torch_dp.py --device cpu --size nano --workers 4

Trains ``chip_smoke.py`` phase T2's module (GPT-2-``--size`` on the
flash kernels, ``seq_len`` 1024 for ``small``, AdamW, ``seed=0``, no
validation) for ``--steps`` steps:

1. in this process on one device at ``--batch-per-worker`` rows a step
   (what one card trains alone: the per-card throughput to scale from);
2. in this process at the global batch, ``--workers`` x that (the
   losses the data-parallel fits are compared with);
3. under ``RayStrategy``, ``HorovodRayStrategy``, ``RayShardedStrategy``
   and ``FSDPStrategy`` with ``num_workers=--workers``: one spawned
   process per device (``ProcessRay``; NCCL between cards, gloo with
   ``--device cpu``), the same global batch, one world reused by every
   fit. Each further preset of ``--optimizers`` (``adamw_bf16m``,
   ``adafactor``) runs (1) and (2) and the ZeRO and FSDP2 fits again.

Prints one JSON line per fit and a summary: per-step losses and their
largest relative difference from (2), the median step ms of the steps
after the first three (host clock, each step synchronized), tokens a
second, the scaling efficiency against ``--workers`` x (1)'s tokens a
second, peak device memory and ``opt_state_bytes`` (rank 0's), and the
card's name and power limit. ``--device cpu`` rehearses the path on
CPU workers; its times are the CPU's, not a card's.
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from ray_lightning_tpu_torch import (FSDPStrategy, GPTModule,  # noqa: E402
                                     HorovodRayStrategy, RayShardedStrategy,
                                     RayStrategy, Trainer, gpt2_config)
from ray_lightning_tpu_torch.core import Callback  # noqa: E402
from ray_lightning_tpu_torch.core.optim import \
    opt_state_bytes  # noqa: E402
from ray_lightning_tpu_torch.launchers import (ExecutorBase,  # noqa: E402
                                               ProcessRay, RayLauncher)

STRATEGIES = {"ddp": RayStrategy, "allreduce": HorovodRayStrategy,
              "zero": RayShardedStrategy, "fsdp2": FSDPStrategy}
WARMUP = 3


class StepProbe(Callback):
    """Per-step end times and losses in the process that trains (back to
    the driver as this callback's state); peak memory and
    ``opt_state_bytes`` into ``callback_metrics``."""

    def __init__(self):
        self.ends, self.losses = [], []

    def _cuda(self, trainer) -> bool:
        return trainer.strategy.root_device.type == "cuda"

    def on_fit_start(self, trainer, module):
        if self._cuda(trainer):
            torch.cuda.reset_peak_memory_stats()

    def on_train_batch_end(self, trainer, module, outputs, batch, idx):
        if self._cuda(trainer):
            torch.cuda.synchronize()
        self.ends.append(time.perf_counter())
        self.losses.append(float(outputs["loss"]))

    def on_train_end(self, trainer, module):
        m = trainer.callback_metrics
        m["peak_memory_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                                if self._cuda(trainer) else 0.0)
        m["opt_state_bytes"] = opt_state_bytes(trainer.train_state.optimizer)

    def state_dict(self):
        return {"ends": self.ends, "losses": self.losses}

    def load_state_dict(self, state):
        self.ends, self.losses = state["ends"], state["losses"]


def module(size: str, batch: int, optimizer: str = "adamw") -> GPTModule:
    seq = 1024 if size == "small" else 64
    cfg = gpt2_config(size, attention_impl="flash", max_seq_len=seq,
                      **({} if size == "small" else {"vocab_size": 256}))
    return GPTModule(config=cfg, batch_size=batch, seq_len=seq,
                     num_samples=max(256, batch * 16), optimizer=optimizer)


def fit(strategy, size, batch, steps, launcher=None,
        optimizer: str = "adamw") -> dict:
    probe = StepProbe()
    trainer = Trainer(strategy=strategy, max_epochs=1,
                      limit_train_batches=steps, limit_val_batches=0,
                      seed=0, callbacks=[probe])
    if launcher is not None:
        trainer._launcher = launcher
    mod = module(size, batch, optimizer)
    t0 = time.perf_counter()
    trainer.fit(mod)
    step_s = float(np.median(np.diff(probe.ends)[WARMUP - 1:]))
    m = trainer.callback_metrics
    out = dict(losses=probe.losses, step_ms=1e3 * step_s,
               tokens_per_s=batch * mod.seq_len / step_s,
               peak_memory_gib=m["peak_memory_gib"],
               opt_state_bytes=int(m["opt_state_bytes"]),
               fit_s=time.perf_counter() - t0)
    # a trainer and its module refer to each other: free the device
    # memory of an in-process fit before the workers need the card
    del trainer, mod
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.CalledProcessError):
        return "no card"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch-per-worker", type=int, default=8)
    ap.add_argument("--size", default="small")
    ap.add_argument("--device", default=None,
                    help="'cpu' for CPU workers (gloo); default: one card "
                         "per worker")
    ap.add_argument("--strategies", default=",".join(STRATEGIES))
    ap.add_argument("--optimizers", default="adamw",
                    help="presets; those past adamw run under zero and "
                         "fsdp2 only")
    args = ap.parse_args()
    if args.device is None and not torch.cuda.is_available():
        print("profile_torch_dp: no CUDA device (pass --device cpu to "
              "rehearse on CPU workers)", file=sys.stderr)
        return 2
    if args.device is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n, b = args.workers, args.batch_per_worker
    card = card_line()
    print(card, flush=True)
    res = {"card": card, "workers": n, "steps": args.steps,
           "batch_per_worker": b, "size": args.size, "fits": {}}
    optimizers = args.optimizers.split(",")
    one, ref = {}, {}
    for opt in optimizers:
        tag = "" if opt == "adamw" else f"/{opt}"
        one[opt] = fit(RayStrategy(device=args.device), args.size, b,
                       args.steps, optimizer=opt)
        res["fits"][f"one_device_batch_per_worker{tag}"] = one[opt]
        print("one device, batch", b, opt, json.dumps(one[opt]), flush=True)
        ref[opt] = fit(RayStrategy(device=args.device), args.size, n * b,
                       args.steps, optimizer=opt)
        res["fits"][f"one_device_global_batch{tag}"] = ref[opt]
        print("one device, batch", n * b, opt, json.dumps(ref[opt]),
              flush=True)
    ray = ProcessRay(num_threads=1 if args.device == "cpu" else None)
    ray.init()
    try:
        t0 = time.perf_counter()
        workers = [ray.remote(ExecutorBase).options(
            construct_timeout=300).remote() for _ in range(n)]
        res["spawn_s"] = time.perf_counter() - t0
        for name in args.strategies.split(","):
            for opt in optimizers:
                if opt != "adamw" and name not in ("zero", "fsdp2"):
                    continue
                key = name if opt == "adamw" else f"{name}/{opt}"
                strategy = STRATEGIES[name](num_workers=n,
                                            device=args.device)
                out = fit(strategy, args.size, n * b, args.steps,
                          RayLauncher(strategy, ray_module=ray,
                                      workers=workers), optimizer=opt)
                out["max_rel_loss_diff"] = max(
                    abs(a - r) / abs(r) for a, r in zip(out["losses"],
                                                        ref[opt]["losses"]))
                out["scaling_efficiency"] = out["tokens_per_s"] / (
                    n * one[opt]["tokens_per_s"])
                res["fits"][key] = out
                print(key, json.dumps(out), flush=True)
                if not (np.all(np.isfinite(out["losses"]))
                        and out["max_rel_loss_diff"] <= 1e-2):
                    print(f"profile_torch_dp: {key} losses {out['losses']} "
                          f"vs {ref[opt]['losses']}", file=sys.stderr)
                    return 1
    finally:
        ray.shutdown()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
