"""Sharded large-model training example, on the PyTorch/CUDA port.

The port's twin of ``examples/gpt_sharded_example.py`` (the reference's
``examples/ray_ddp_sharded_example.py``: a GPT with ``RayShardedStrategy``
and an epoch-time/peak-memory callback): a GPT-2 model trained with
ZeRO's split of the optimizer state (or FSDP2 with ``--fsdp``), one
worker process per card, reporting per-epoch wall time and device
memory. Runs on the card by default; ``--cpu`` runs on the CPU:

    python examples/gpt_sharded_example_torch.py --num-workers 8 --size nano
    python examples/gpt_sharded_example_torch.py --cpu --fsdp \\
        --num-workers 2 --smoke-test --generate 4
"""
import argparse
import dataclasses

import numpy as np

from ray_lightning_tpu_torch import (FSDPStrategy, GPTModule,
                                     RayShardedStrategy, Trainer,
                                     TransformerLM, resolve_device)
from ray_lightning_tpu_torch.core.callbacks import EpochStatsCallback
from ray_lightning_tpu_torch.models.generate import generate


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-workers", type=int, default=2)
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="Run on the CPU (gloo between workers); "
                             "without it the script needs a card.")
    parser.add_argument("--use-gpu", action="store_true", default=False,
                        help="The card (the default; kept for the "
                             "reference's flag).")
    parser.add_argument("--size", default="nano",
                        choices=["nano", "small", "medium", "large", "xl"])
    parser.add_argument("--fsdp", action="store_true", default=False,
                        help="Fully-sharded params (ZeRO-3) instead of "
                             "optimizer-state-only (ZeRO-1)")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--max-epochs", type=int, default=2)
    parser.add_argument("--generate", type=int, default=0, metavar="N",
                        help="after training, decode N tokens from the "
                             "trained weights with the KV-cache sampler")
    parser.add_argument("--optimizer", default="adamw",
                        choices=["adamw", "adamw_bf16m", "adafactor"],
                        help="memory-efficient presets free optimizer-"
                             "state memory for bigger batches/models on "
                             "a card (core/optim.py)")
    parser.add_argument("--smoke-test", action="store_true", default=False)
    return parser.parse_args(argv)


def build(args):
    """The module the flags ask for."""
    return GPTModule(size=args.size, batch_size=args.batch_size,
                     seq_len=args.seq_len, optimizer=args.optimizer,
                     num_samples=4 * args.batch_size if args.smoke_test
                     else 64 * args.batch_size)


def trained_params(trainer):
    """The fitted weights as a state dict: the live module's after an
    in-process fit, the state rank 0 returned after a launched one."""
    if trainer.train_state is not None:
        return trainer.model.state_dict()
    return trainer.train_state_dict["params"]


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    resolve_device(device)      # the card unless --cpu: never a fallback

    strategy_cls = FSDPStrategy if args.fsdp else RayShardedStrategy
    model = build(args)
    trainer = Trainer(
        strategy=strategy_cls(num_workers=args.num_workers, device=device),
        max_epochs=1 if args.smoke_test else args.max_epochs,
        callbacks=[EpochStatsCallback()],
        enable_progress_bar=True,
        seed=42)
    trainer.fit(model)
    print("callback_metrics:",
          {k: round(float(v), 4) for k, v in trainer.callback_metrics.items()})

    if args.generate:
        # decode needs no remat (single-token steps store no
        # activations); the port's layers are unrolled already, so the
        # training weights load as they are. generate() runs the
        # prefill/decode split: the prompt fills the KV cache in one
        # forward, then cached single-token steps sample.
        dec_cfg = dataclasses.replace(model.cfg, decode=True, remat=False,
                                      remat_policy=None)
        dec = TransformerLM(dec_cfg, device=device)
        dec.load_state_dict(trained_params(trainer))
        prompt = np.asarray([[1, 2, 3, 4]], dtype=np.int32)
        out = generate(dec, None, prompt, max_new_tokens=args.generate,
                       rng=0, temperature=0.8, top_k=40)
        print("generated:", out[0].tolist())
    return trainer


if __name__ == "__main__":
    main()
