"""ResNet-50 + Ray Tune population-based training, on the PyTorch/CUDA port.

The port's twin of ``examples/resnet_pbt_example.py``, the BASELINE
"ResNet-50 + Ray Tune PBT sweep" configuration. Every trial checkpoints
through the session queue, and the exploit step clones a stronger
trial's checkpoint into a weaker one with perturbed hyperparameters,
which the trainable resumes through
:func:`ray_lightning_tpu_torch.tune.resume_ckpt_path`. With Ray
installed:

    python examples/resnet_pbt_example_torch.py --num-workers 4 --num-samples 8

Without Ray (or with ``--smoke-test``), a sequential 2-member mini-PBT
runs the same exploit/explore loop through the real checkpoint
machinery:

    python examples/resnet_pbt_example_torch.py --cpu --smoke-test

Runs on the card by default (``RuntimeError`` without one); ``--cpu``
runs on the CPU.
"""
import argparse
import os
import random
import tempfile

from ray_lightning_tpu_torch import (ModelCheckpoint, RayStrategy,
                                     ResNetModule, Trainer, resolve_device)
from ray_lightning_tpu_torch.tune import (TUNE_INSTALLED,
                                          TuneReportCheckpointCallback,
                                          get_tune_resources,
                                          resume_ckpt_path)


def build(config, args, smoke):
    # ResNetModule applies config overrides (lr/momentum/batch_size)
    # itself; the kwargs below are only the non-swept defaults
    return ResNetModule(
        depth=18 if smoke else 50,
        batch_size=128,
        num_samples=256 if smoke else 4096,
        image_size=32,
        config=config)


def device_of(args):
    return "cpu" if args.cpu else None


def train_resnet(config, args, checkpoint_dir=None, callbacks=None,
                 smoke=False, max_epochs=None):
    """The PBT trainable: resume-aware strategy-launched fit."""
    module = build(config, args, smoke)
    trainer = Trainer(
        strategy=RayStrategy(num_workers=args.num_workers,
                             device=device_of(args)),
        max_epochs=max_epochs or args.max_epochs,
        callbacks=list(callbacks or []),
        seed=42)
    # PBT exploit: Tune hands the trial a cloned checkpoint to continue
    # from (possibly another member's weights under new hparams)
    ckpt = resume_ckpt_path(checkpoint_dir)
    trainer.fit(module, ckpt_path=ckpt)
    return trainer


def tune_pbt(args):
    from ray import tune
    from ray.tune.schedulers import PopulationBasedTraining

    pbt = PopulationBasedTraining(
        time_attr="training_iteration",
        perturbation_interval=2,
        hyperparam_mutations={
            "lr": tune.loguniform(1e-3, 1.0),
            "momentum": [0.8, 0.9, 0.99],
        })
    callbacks = [TuneReportCheckpointCallback(
        {"acc": "val_acc", "loss": "val_loss"}, on="validation_end")]
    # no checkpoint_dir parameter: Ray >= 2.7 rejects it on function
    # trainables, and resume_ckpt_path() reaches the 2.x checkpoint via
    # tune.get_checkpoint(); on legacy Ray add `checkpoint_dir=None` to
    # the lambda and forward it to train_resnet
    analysis = tune.run(
        lambda cfg: train_resnet(cfg, args, callbacks=callbacks),
        resources_per_trial=get_tune_resources(
            num_workers=args.num_workers, device=device_of(args)),
        scheduler=pbt, metric="acc", mode="max",
        config={"lr": tune.loguniform(1e-2, 0.5),
                "momentum": 0.9,
                "batch_size": 128},
        num_samples=args.num_samples, name="resnet50_pbt_gpu")
    print("Best hyperparameters:", analysis.best_config)


def mini_pbt(args):
    """Ray-less fallback: 2 members, sequential generations, the same
    checkpoint-clone exploit/explore step PBT performs. Returns the
    final members and the exploits, ``(generation, worst, best)``."""
    rng = random.Random(0)
    members = [{"lr": 0.2, "momentum": 0.9, "batch_size": 64},
               {"lr": 0.02, "momentum": 0.9, "batch_size": 64}]
    root = tempfile.mkdtemp(prefix="mini_pbt_")
    paths = [None, None]
    exploits = []
    for gen in range(2):
        scores = []
        for i, cfg in enumerate(members):
            ckpt_cb = ModelCheckpoint(
                dirpath=os.path.join(root, f"m{i}"), monitor=None,
                filename=f"gen{gen}")
            module = build(cfg, args, smoke=True)
            # resume restarts at the checkpoint's next epoch, so the
            # horizon must grow one epoch per generation
            trainer = Trainer(
                strategy=RayStrategy(num_workers=args.num_workers,
                                     device=device_of(args)),
                max_epochs=gen + 1, callbacks=[ckpt_cb], seed=42)
            trainer.fit(module, ckpt_path=paths[i])
            acc = float(trainer.callback_metrics.get("val_acc", 0.0))
            scores.append(acc)
            paths[i] = ckpt_cb.best_model_path
            print(f"gen {gen} member {i} cfg={cfg} val_acc={acc:.4f}")
        # exploit: worst member clones the best member's checkpoint;
        # explore: perturb its lr by 0.8x / 1.25x
        best, worst = (0, 1) if scores[0] >= scores[1] else (1, 0)
        paths[worst] = paths[best]
        members[worst] = dict(members[best])
        members[worst]["lr"] *= rng.choice([0.8, 1.25])
        exploits.append((gen, worst, best))
        print(f"gen {gen}: member {worst} exploits member {best}, "
              f"new lr={members[worst]['lr']:.4f}")
    print("final members:", members)
    return members, exploits


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-workers", type=int, default=1)
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="Run on the CPU (gloo between workers); "
                             "without it the script needs a card.")
    parser.add_argument("--use-gpu", action="store_true", default=False,
                        help="The card (the default; kept for the "
                             "reference's flag).")
    parser.add_argument("--max-epochs", type=int, default=10)
    parser.add_argument("--num-samples", type=int, default=4,
                        help="PBT population size")
    parser.add_argument("--smoke-test", action="store_true", default=False)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    resolve_device(device_of(args))  # the card unless --cpu: no fallback

    if TUNE_INSTALLED and not args.smoke_test:
        return tune_pbt(args)
    return mini_pbt(args)


if __name__ == "__main__":
    main()
