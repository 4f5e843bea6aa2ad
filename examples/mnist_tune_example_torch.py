"""MNIST + Ray Tune hyperparameter search example, on the PyTorch/CUDA port.

The port's twin of ``examples/mnist_tune_example.py`` (the reference's
``examples/ray_ddp_tune.py``: MNIST with an ``init_hook`` for per-worker
data download plus ``tune.run`` over lr and batch size). With Ray
installed:

    python examples/mnist_tune_example_torch.py --num-workers 2 --num-samples 4

Without Ray (or with ``--smoke-test``) the script runs a sequential
sweep through the same trainable:

    python examples/mnist_tune_example_torch.py --cpu --smoke-test

Runs on the card by default (``RuntimeError`` without one); ``--cpu``
runs on the CPU.
"""
import argparse

from ray_lightning_tpu_torch import (LightningMNISTClassifier, RayStrategy,
                                     Trainer, resolve_device)
from ray_lightning_tpu_torch.tune import (TUNE_INSTALLED, TuneReportCallback,
                                          get_tune_resources)


def download_data():
    """Runs on every worker before training (``init_hook`` parity:
    the reference pre-downloads MNIST per node, ``ray_ddp_tune.py``)."""
    # synthetic data needs no download; real datasets would fetch here.


def train_mnist(config, num_workers=1, device=None, num_epochs=2,
                num_samples_data=2048, callbacks=None):
    """The Tune trainable: a full strategy-launched fit per trial."""
    model = LightningMNISTClassifier(config=config,
                                     num_samples=num_samples_data)
    trainer = Trainer(
        strategy=RayStrategy(num_workers=num_workers, device=device,
                             init_hook=download_data),
        max_epochs=num_epochs,
        callbacks=list(callbacks or []),
        seed=42)
    trainer.fit(model)
    return trainer


def tune_mnist(args, device):
    from ray import tune
    callbacks = [TuneReportCallback({"loss": "ptl/val_loss",
                                     "acc": "ptl/val_accuracy"},
                                    on="validation_epoch_end")]
    config = {
        "lr": tune.loguniform(1e-4, 1e-1),
        "batch_size": tune.choice([32, 64, 128]),
    }
    analysis = tune.run(
        tune.with_parameters(
            lambda cfg: train_mnist(cfg, args.num_workers, device,
                                    args.max_epochs, callbacks=callbacks)),
        resources_per_trial=get_tune_resources(
            num_workers=args.num_workers, device=device),
        metric="acc", mode="max", config=config,
        num_samples=args.num_samples, name="tune_mnist_gpu")
    print("Best hyperparameters:", analysis.best_config)


def sweep_mnist(args, device):
    """Ray-less fallback: sequential sweep over a small grid."""
    best = (None, -1.0)
    for lr in ([1e-3] if args.smoke_test else [1e-2, 1e-3]):
        for bs in ([64] if args.smoke_test else [32, 64]):
            trainer = train_mnist({"lr": lr, "batch_size": bs},
                                  args.num_workers, device,
                                  1 if args.smoke_test else args.max_epochs)
            acc = float(trainer.callback_metrics.get("ptl/val_accuracy", 0))
            print(f"lr={lr} batch_size={bs} → val_acc={acc:.4f}")
            if acc > best[1]:
                best = ({"lr": lr, "batch_size": bs}, acc)
    print("Best hyperparameters:", best[0], "val_acc:", best[1])
    return best


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-workers", type=int, default=1)
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="Run on the CPU (gloo between workers); "
                             "without it the script needs a card.")
    parser.add_argument("--use-gpu", action="store_true", default=False,
                        help="The card (the default; kept for the "
                             "reference's flag).")
    parser.add_argument("--max-epochs", type=int, default=2)
    parser.add_argument("--num-samples", type=int, default=4,
                        help="Tune trials to run")
    parser.add_argument("--smoke-test", action="store_true", default=False)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    resolve_device(device)      # the card unless --cpu: never a fallback

    if TUNE_INSTALLED and not args.smoke_test:
        return tune_mnist(args, device)
    return sweep_mnist(args, device)


if __name__ == "__main__":
    main()
