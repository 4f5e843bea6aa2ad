"""Vision Transformer classification example, on the PyTorch/CUDA port.

The port's twin of ``examples/vit_example.py``: a ViT classifier on the
shared transformer stack, data-parallel with one process per card, with
the JAX package's default of remat under the
``dots_with_no_batch_dims_save_attn`` policy (``--no-remat`` opts out).
Runs on the card by default; ``--cpu`` runs on the CPU:

    python examples/vit_example_torch.py --num-workers 4 --max-epochs 3
    python examples/vit_example_torch.py --cpu --num-workers 1 --smoke-test
"""
import argparse

from ray_lightning_tpu_torch import (RayStrategy, Trainer, ViTModule,
                                     resolve_device, vit_config)
from ray_lightning_tpu_torch.core.callbacks import EpochStatsCallback


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-workers", type=int, default=2)
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="Run on the CPU (gloo between workers); "
                             "without it the script needs a card.")
    parser.add_argument("--use-gpu", action="store_true", default=False,
                        help="The card (the default; kept for the "
                             "reference's flag).")
    parser.add_argument("--size", default="tiny",
                        choices=["tiny", "small", "base"])
    parser.add_argument("--image-size", type=int, default=32)
    parser.add_argument("--patch-size", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--max-epochs", type=int, default=3)
    parser.add_argument("--no-remat", action="store_true", default=False,
                        help="Opt out of the remat default (the replay "
                             "costs a second forward a step).")
    parser.add_argument("--smoke-test", action="store_true", default=False)
    return parser.parse_args(argv)


def build(args):
    """The module the flags ask for."""
    cfg = vit_config(args.size, image_size=args.image_size,
                     patch_size=args.patch_size,
                     **({"remat": False} if args.no_remat else {}))
    return ViTModule(size=args.size, image_size=args.image_size,
                     patch_size=args.patch_size, config=cfg,
                     batch_size=args.batch_size,
                     num_samples=4 * args.batch_size if args.smoke_test
                     else 16 * args.batch_size)


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
    print("callback_metrics:",
          {k: round(float(v), 4) for k, v in trainer.callback_metrics.items()})
    return trainer


if __name__ == "__main__":
    main()
