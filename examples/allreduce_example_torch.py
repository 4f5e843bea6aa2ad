"""Explicit-allreduce (Horovod-parity) training example, on the PyTorch/CUDA port.

The port's twin of ``examples/allreduce_example.py``: the MNIST
classifier trained with ``HorovodRayStrategy`` -- each rank's gradients
all-reduced explicitly after ``backward`` (the seat of
``hvd.DistributedOptimizer``) instead of inside a DDP wrapper. Runs on
the card by default; ``--cpu`` runs on the CPU:

    python examples/allreduce_example_torch.py --num-workers 2 --smoke-test
"""
import argparse

from ray_lightning_tpu_torch import (HorovodRayStrategy,
                                     LightningMNISTClassifier, Trainer,
                                     resolve_device)
from ray_lightning_tpu_torch.core.callbacks import EpochStatsCallback


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-workers", type=int, default=1,
                        help="Number of allreduce ranks (a process and a "
                             "card each).")
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="Run on the CPU (gloo between workers); "
                             "without it the script needs a card.")
    parser.add_argument("--use-gpu", action="store_true", default=False,
                        help="The card (the default; kept for the "
                             "reference's flag).")
    parser.add_argument("--max-epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--smoke-test", action="store_true", default=False)
    return parser.parse_args(argv)


def build(args):
    """The module the flags ask for."""
    return LightningMNISTClassifier(
        config={"lr": args.lr, "batch_size": args.batch_size},
        num_samples=1024 if args.smoke_test else 8192)


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    resolve_device(device)      # the card unless --cpu: never a fallback

    model = build(args)
    trainer = Trainer(
        strategy=HorovodRayStrategy(num_workers=args.num_workers,
                                    device=device),
        max_epochs=1 if args.smoke_test else args.max_epochs,
        callbacks=[EpochStatsCallback()],
        enable_progress_bar=True,
        seed=42)
    trainer.fit(model)
    print("callback_metrics:",
          {k: round(float(v), 4) for k, v in trainer.callback_metrics.items()})
    results = trainer.test(model)
    print("test results:", results)
    return trainer


if __name__ == "__main__":
    main()
