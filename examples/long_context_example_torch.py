"""Long-context training example, on the PyTorch/CUDA port.

The port's twin of ``examples/long_context_example.py``. Its
single-card path, ``--impl flash``, is ported: a GPT trained on one card
through the hand-written flash-attention kernels (forward, dK/dV and dQ,
``csrc/flash_attention.cu``), which never hold the T x T score matrix,
so the whole sequence stays on the card:

    python examples/long_context_example_torch.py --impl flash \\
        --size small --seq-len 16384 --batch-size 1 --max-epochs 1

The sequence-parallel branches, ``--impl ring`` (K/V shards rotated
around a ring of cards) and ``--impl ulysses`` (an all-to-all that
shards the heads), need a mesh with a sequence axis, which the port does
not have yet: they raise ``NotImplementedError`` naming ``ROADMAP.md`` A,
item 9 (multi-axis meshes). ``ring`` stays the default, as in the JAX
script, so the flag must be given.

``--generate N`` runs the serving side after training: the trained
weights drive the prefill/decode split (``models/generate.py``) on a
long prompt (capped at 2k): the whole prompt fills the KV cache in ONE
forward instead of per-token steps. The serving path uses the plain dot
attention, whose prefill holds the P x P score tensor, hence the cap.

Runs on the card by default (``RuntimeError`` without one); ``--cpu``
runs on the CPU.
"""
import argparse
import dataclasses
import time

import numpy as np

from ray_lightning_tpu_torch import (GPTModule, RayStrategy, Trainer,
                                     TransformerLM, gpt2_config,
                                     resolve_device)
from ray_lightning_tpu_torch.core.callbacks import EpochStatsCallback
from ray_lightning_tpu_torch.models.generate import generate

#: the multi-axis mesh item that the sequence-parallel branches wait for
MESH_ITEM = "ROADMAP.md A, item 9: multi-axis meshes"


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dp", type=int, default=None,
                        help="Data-parallel size (batch split); defaults "
                             "to 2, or 1 in --impl flash (single card).")
    parser.add_argument("--sp", type=int, default=4,
                        help="Sequence-parallel size (sequence split).")
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="Run on the CPU; without it the script needs "
                             "a card.")
    parser.add_argument("--use-gpu", action="store_true", default=False,
                        help="The card (the default; kept for the "
                             "reference's flag).")
    parser.add_argument("--size", default="nano",
                        choices=["nano", "small", "medium", "large", "xl"])
    parser.add_argument("--impl", default="ring",
                        choices=["ring", "ulysses", "flash"],
                        help="Sequence-parallel attention variant, or "
                             "'flash' for single-card long context "
                             "through the flash-attention kernels (no "
                             "sequence sharding; --sp is ignored). "
                             "'ring' and 'ulysses' are not ported yet.")
    parser.add_argument("--seq-len", type=int, default=2048)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--max-epochs", type=int, default=2)
    parser.add_argument("--generate", type=int, default=0, metavar="N",
                        help="After training, prefill a long prompt in "
                             "one pass and decode N new tokens with the "
                             "trained weights (single-card demo of the "
                             "prefill/decode serving split).")
    parser.add_argument("--smoke-test", action="store_true", default=False)
    return parser.parse_args(argv)


def seq_len_of(args) -> int:
    return 256 if args.smoke_test else args.seq_len


def build(args):
    """The module the flags ask for; the sequence-parallel branches
    raise ``NotImplementedError`` (item 9)."""
    if args.impl != "flash":
        raise NotImplementedError(
            f"--impl {args.impl} (sequence-parallel attention over an sp "
            f"mesh axis) is not ported yet ({MESH_ITEM}); --impl flash "
            "is the single-card long-context path")
    seq_len = seq_len_of(args)
    cfg = gpt2_config(args.size, max_seq_len=seq_len,
                      attention_impl=args.impl)
    return GPTModule(config=cfg, batch_size=args.batch_size,
                     seq_len=seq_len,
                     num_samples=4 * args.batch_size if args.smoke_test
                     else 32 * args.batch_size)


def trained_params(trainer):
    """The fitted weights as a state dict: the live module's after an
    in-process fit, the state rank 0 returned after a launched one."""
    if trainer.train_state is not None:
        return trainer.model.state_dict()
    return trainer.train_state_dict["params"]


def main(argv=None, callbacks=()):
    """Run the example; ``callbacks`` are added to the trainer's (a
    caller's instruments)."""
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    model = build(args)
    resolve_device(device)      # the card unless --cpu: never a fallback
    if args.dp is None:
        # flash is the single-card long-context path (the whole sequence
        # stays on each card, tiled through shared memory by the
        # kernels), so its default world is one worker
        args.dp = 1
    trainer = Trainer(
        strategy=RayStrategy(num_workers=args.dp, device=device),
        max_epochs=1 if args.smoke_test else args.max_epochs,
        callbacks=[EpochStatsCallback(), *callbacks],
        enable_progress_bar=True,
        seed=42)
    trainer.fit(model)
    print("callback_metrics:",
          {k: round(float(v), 4) for k, v in trainer.callback_metrics.items()})

    if args.generate:
        # serving config: the cached dot attention (decode attends a KV
        # cache) and no remat (single-token steps store no activations)
        dec_cfg = dataclasses.replace(
            model.cfg, decode=True, remat=False, remat_policy=None,
            attention_impl="dot")
        dec = TransformerLM(dec_cfg, device=device)
        dec.load_state_dict(trained_params(trainer))
        # a long prompt is exactly where the prefill split pays: the
        # whole prompt is ONE forward into the KV cache instead of
        # prompt_len sequential single-token steps. Capped at 2k: the
        # plain dot attention's prefill holds the O(P^2) score tensor
        seq_len = seq_len_of(args)
        prompt_len = max(8, min(seq_len, 2048) - args.generate)
        prompt = np.asarray(
            np.arange(prompt_len)[None, :] % model.cfg.vocab_size,
            dtype=np.int32)
        t0 = time.perf_counter()
        out = generate(dec, None, prompt, max_new_tokens=args.generate,
                       rng=0, temperature=0.0)
        tail = out[0, prompt_len:].tolist()
        dt = time.perf_counter() - t0
        print(f"prefilled {prompt_len} prompt tokens in one pass + "
              f"decoded {args.generate} tokens in {dt:.2f}s: "
              f"{tail[:16]}...")
    return trainer


if __name__ == "__main__":
    main()
