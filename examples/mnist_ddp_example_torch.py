"""MNIST data-parallel training example, on the PyTorch/CUDA port.

The port's twin of ``examples/mnist_ddp_example.py``: the same flags,
printouts and model, through ``ray_lightning_tpu_torch``. Runs on the
card by default (``RuntimeError`` without one); ``--cpu`` runs on the
CPU. ``--num-workers N`` spawns N worker processes, one per card (gloo
between CPU workers):

    python examples/mnist_ddp_example_torch.py --num-workers 2 --smoke-test
    python examples/mnist_ddp_example_torch.py --cpu --num-workers 2 \\
        --data-workers 1 --smoke-test
"""
import argparse

from ray_lightning_tpu_torch import (LightningMNISTClassifier,
                                     MultiprocessDataLoader, RayStrategy,
                                     Trainer, resolve_device)
from ray_lightning_tpu_torch.core.callbacks import EpochStatsCallback


class MNISTWithLoaderWorkers(LightningMNISTClassifier):
    """MNIST classifier feeding training through the native shm-ring
    multiprocess loader: N producer processes assemble batches while the
    device steps -- the seat of the reference example's torch
    ``DataLoader(num_workers=N)``. At the module's top level, so a
    spawned worker unpickles it: by this file's name when the script is
    imported, and as ``__main__`` when it runs as a script (the spawn
    start method imports the script again as the worker's main
    module)."""

    def __init__(self, config=None, num_samples=8192, data_workers=2):
        super().__init__(config=config, num_samples=num_samples)
        self.data_workers = data_workers

    def train_dataloader(self):
        return MultiprocessDataLoader(super().train_dataloader(),
                                      num_workers=self.data_workers)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-workers", type=int, default=1,
                        help="Number of data-parallel ranks (a process "
                             "and a card each).")
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="Run on the CPU (gloo between workers); "
                             "without it the script needs a card.")
    parser.add_argument("--use-gpu", action="store_true", default=False,
                        help="The card (the default; kept for the "
                             "reference's flag).")
    parser.add_argument("--max-epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--data-workers", type=int, default=0,
                        help="Multiprocess data-loader producers (0 = load "
                             "inline on the training process).")
    parser.add_argument("--use-ray", action="store_true", default=False,
                        help="Attach to (or start) a Ray cluster and run "
                             "workers as Ray actors -- the reference's "
                             "deployment shape (ray_ddp_example.py).")
    parser.add_argument("--smoke-test", action="store_true", default=False)
    return parser.parse_args(argv)


def build(args):
    """The module the flags ask for."""
    num_samples = 1024 if args.smoke_test else 8192
    config = {"lr": args.lr, "batch_size": args.batch_size}
    if args.data_workers > 0:
        return MNISTWithLoaderWorkers(
            config=config, num_samples=num_samples,
            data_workers=args.data_workers)
    return LightningMNISTClassifier(config=config, num_samples=num_samples)


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    resolve_device(device)      # the card unless --cpu: never a fallback

    if args.use_ray:
        import ray
        if not ray.is_initialized():
            ray.init()

    model = build(args)
    trainer = Trainer(
        strategy=RayStrategy(num_workers=args.num_workers, device=device,
                             use_ray=args.use_ray or None),
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
