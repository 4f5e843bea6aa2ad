"""ResNet/CIFAR-style data-parallel training example, on the PyTorch/CUDA port.

The port's twin of ``examples/resnet_example.py``, BASELINE.json's
"ResNet-18/CIFAR-10, RayStrategy num_workers=8" configuration: a
residual CNN whose BatchNorm running statistics are the module's buffers
(the JAX package's mutable ``model_state``), trained data-parallel with
one process per card. Runs on the card by default; ``--cpu`` runs on the
CPU:

    python examples/resnet_example_torch.py --num-workers 8 --depth 18
    python examples/resnet_example_torch.py --cpu --num-workers 1 --smoke-test
"""
import argparse

from ray_lightning_tpu_torch import (RayStrategy, ResNetModule, Trainer,
                                     resolve_device)
from ray_lightning_tpu_torch.core.callbacks import EpochStatsCallback


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="Run on the CPU (gloo between workers); "
                             "without it the script needs a card.")
    parser.add_argument("--use-gpu", action="store_true", default=False,
                        help="The card (the default; kept for the "
                             "reference's flag).")
    parser.add_argument("--depth", type=int, default=18, choices=[18, 50])
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--max-epochs", type=int, default=5)
    parser.add_argument("--smoke-test", action="store_true", default=False)
    return parser.parse_args(argv)


def build(args):
    """The module the flags ask for."""
    return ResNetModule(
        depth=args.depth,
        batch_size=32 if args.smoke_test else args.batch_size,
        num_samples=128 if args.smoke_test else 4096,
        lr=args.lr)


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    resolve_device(device)      # the card unless --cpu: never a fallback

    model = build(args)
    trainer = Trainer(
        strategy=RayStrategy(num_workers=args.num_workers, device=device),
        max_epochs=1 if args.smoke_test else args.max_epochs,
        callbacks=[EpochStatsCallback()],
        enable_progress_bar=True,
        seed=42)
    trainer.fit(model)
    results = trainer.test(model)
    print("callback_metrics:",
          {k: round(float(v), 4) for k, v in trainer.callback_metrics.items()})
    print("test results:", results)
    return trainer


if __name__ == "__main__":
    main()
