"""BERT-base fine-tune over data parallelism, on the PyTorch/CUDA port.

The port's twin of ``examples/bert_finetune_example.py``, the BASELINE
"BERT-base fine-tune, RayStrategy multi-host" configuration: the same
user surface (``Trainer(strategy=RayStrategy(...)).fit(model)``), one
worker process per card, gradients averaged by DDP over NCCL (gloo
between CPU workers). Runs on the card by default; ``--cpu`` runs on the
CPU:

    python examples/bert_finetune_example_torch.py --num-workers 4
    python examples/bert_finetune_example_torch.py --cpu --smoke-test
"""
import argparse

import torch

from ray_lightning_tpu_torch import (BertModule, RayStrategy, Trainer,
                                     bert_config, resolve_device)
from ray_lightning_tpu_torch.core.callbacks import EpochStatsCallback


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-workers", type=int, default=None,
                        help="worker processes, a card each; defaults to "
                        "4, or 2 with --smoke-test")
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="Run on the CPU (gloo between workers); "
                             "without it the script needs a card.")
    parser.add_argument("--use-gpu", action="store_true", default=False,
                        help="The card (the default; kept for the "
                             "reference's flag).")
    parser.add_argument("--max-epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=128,
                        help="global batch, split across the workers")
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--lr", type=float, default=5e-5)
    parser.add_argument("--smoke-test", action="store_true", default=False)
    return parser.parse_args(argv)


def build(args):
    """The module, the epochs and the worker count the flags ask for."""
    if args.smoke_test:
        cfg = bert_config("tiny", vocab_size=1024, max_seq_len=64)
        module = BertModule(config=cfg, batch_size=32, seq_len=64,
                            num_samples=128, lr=args.lr)
        return module, 1, args.num_workers or 2
    # bf16 activations + remat, the JAX example's configuration: f32
    # master weights in the optimizer state
    cfg = bert_config("base", vocab_size=30522,
                      max_seq_len=args.seq_len, dtype=torch.bfloat16,
                      remat=True, remat_policy="dots_with_no_batch_dims")
    module = BertModule(config=cfg, batch_size=args.batch_size,
                        seq_len=args.seq_len, num_samples=4096, lr=args.lr)
    return module, args.max_epochs, args.num_workers or 4


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    resolve_device(device)      # the card unless --cpu: never a fallback

    module, epochs, workers = build(args)
    trainer = Trainer(
        strategy=RayStrategy(num_workers=workers, device=device),
        max_epochs=epochs,
        callbacks=[EpochStatsCallback()],
        enable_progress_bar=True,
        seed=42)
    trainer.fit(module)
    acc = trainer.callback_metrics.get("val_acc")
    print("final val_accuracy:", None if acc is None else float(acc))
    return trainer


if __name__ == "__main__":
    main()
