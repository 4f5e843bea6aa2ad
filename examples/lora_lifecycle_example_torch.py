"""The train -> serve LoRA adapter lifecycle, end to end, on the PyTorch/CUDA port.

The port's twin of ``examples/lora_lifecycle_example.py``:

1. **Train** a LoRA adapter with the trainer: a nano GPT built with
   ``lora=LoraConfig(rank, num_adapters=1)`` fine-tunes on a
   successor-token task (``next = (tok + 1) % vocab``) with the base
   weights FROZEN: the base parameters take no gradient and stay out of
   the optimizer entirely (AdamW's weight decay would move them
   otherwise), so the artifact of training is the adapter alone.
2. **Publish** it through the checkpoint layer:
   :func:`~ray_lightning_tpu_torch.models.lora.extract_adapter` slices
   the trained ``(A, B)`` pairs out of the bank and
   ``save_sharded_checkpoint`` commits them like any other artifact (the
   meta records rank and targets for the load-side check).
3. **Hot-load** it into a RUNNING engine next to the base model: a
   :class:`~ray_lightning_tpu_torch.serve.ServeClient` armed with an
   empty two-slot bank serves base traffic, ``load_adapter()`` writes the
   published adapter into a bank slot, and adapter-bound requests batch
   in the same dispatches as base rows.

Self-checks (all hard failures):

- the base weights are bitwise untouched by fine-tuning;
- hot-loading the adapter into a running engine is token-identical to
  building an engine with it resident from the start;
- the null-adapter row is token-identical to a bankless engine.

``lora_A`` starts from N(0, 0.02) drawn from an explicit
``torch.Generator`` (the JAX script's per-path threefry keys have no
torch counterpart); ``lora_B`` starts at zero, so step 0 is the base
model. Runs on the card by default (``RuntimeError`` without one);
``--cpu`` runs on the CPU:

    python examples/lora_lifecycle_example_torch.py --cpu
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from ray_lightning_tpu_torch import (GPTModule, RayStrategy, ServeClient,
                                     Trainer, TransformerLM, gpt2_config,
                                     resolve_device)
from ray_lightning_tpu_torch.core.checkpoint import (load_sharded_checkpoint,
                                                     save_sharded_checkpoint)
from ray_lightning_tpu_torch.data.loader import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.models.lora import LoraConfig, extract_adapter

VOCAB, SEQ_LEN = 64, 32
#: the seed of lora_A's draws
ADAPTER_SEED = 99


def is_lora(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("lora_A", "lora_B")


def strip_lora(state):
    """The base-weights view of a LoRA-armed state dict (what the serve
    engine takes: it grafts its own bank)."""
    return {k: v for k, v in state.items() if not is_lora(k)}


class LoraGPT(GPTModule):
    """GPTModule fine-tuning ONLY the adapter.

    The successor-token stream is the 'domain' being adapted to; the
    frozen base (random init here -- in production, a trained
    checkpoint) is what every other adapter and the null row keep
    sharing.
    """

    def _loader(self, seed: int, shuffle: bool = False):
        rng = np.random.default_rng(seed)
        starts = rng.integers(0, VOCAB, size=self.num_samples)
        toks = (starts[:, None]
                + np.arange(SEQ_LEN + 1)[None, :]) % VOCAB
        toks = toks.astype(np.int32)
        return DataLoader(ArrayDataset((toks[:, :-1], toks[:, 1:])),
                          batch_size=self.batch_size, shuffle=shuffle)

    def init_variables(self, model, generator, batch):
        super().init_variables(model, generator, batch)
        # standard LoRA init: A ~ N(0, 0.02), B = 0 -- the delta starts
        # at exactly zero (step 0 IS the base model) but gradients flow,
        # unlike the bank's unloaded-slot zero/zero
        gen = torch.Generator().manual_seed(ADAPTER_SEED)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("lora_A"):
                    p.copy_(0.02 * torch.randn(p.shape, generator=gen))
                # the freeze: the base takes no gradient
                p.requires_grad_(is_lora(name))

    def configure_optimizers(self):
        adapter_only = super().configure_optimizers()
        return lambda params: adapter_only(
            [p for p in params if p.requires_grad])


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, default=8,
                        help="LoRA rank r: the adapter is one (in, r) + "
                             "(r, out) pair per targeted projection.")
    parser.add_argument("--max-epochs", type=int, default=8,
                        help="adapter fine-tune epochs (8 is enough for "
                             "the successor rule to dominate the tuned "
                             "row's greedy continuation).")
    parser.add_argument("--publish-dir", default=None,
                        help="where to publish the adapter checkpoint "
                             "(default: a temp directory).")
    parser.add_argument("--max-new", type=int, default=16)
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="Run on the CPU; without it the script needs "
                             "a card.")
    parser.add_argument("--use-gpu", action="store_true", default=False,
                        help="The card (the default).")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    resolve_device(device)      # the card unless --cpu: never a fallback

    lora = LoraConfig(rank=args.rank, num_adapters=1)
    cfg = gpt2_config("nano", vocab_size=VOCAB, max_seq_len=SEQ_LEN,
                      scan_layers=False, lora=lora)

    # 1) train: only the lora leaves move
    def fit(epochs):
        module = LoraGPT(config=cfg, batch_size=8, seq_len=SEQ_LEN,
                         num_samples=64, lr=2e-2, vocab_size=VOCAB)
        trainer = Trainer(strategy=RayStrategy(num_workers=1, device=device),
                          max_epochs=epochs, enable_progress_bar=False,
                          enable_checkpointing=False, seed=0)
        trainer.fit(module)
        state = {k: v.detach().cpu().clone()
                 for k, v in trainer.model.state_dict().items()}
        return state, trainer

    trained, trainer = fit(args.max_epochs)

    # the freeze self-check: two fits of different lengths share the
    # same seeded init, so a real freeze means bitwise-identical base
    # weights -- while the adapter leaves keep moving with more steps
    short, _ = fit(1)
    frozen_ok = all(torch.equal(v, short[k])
                    for k, v in strip_lora(trained).items())
    adapter_moved = any(not torch.equal(v, short[k])
                        for k, v in trained.items() if is_lora(k))
    plain_cfg = dataclasses.replace(cfg, lora=None)
    print(f"base weights bitwise frozen through fine-tune: {frozen_ok} "
          f"(adapter kept training: {adapter_moved})")
    if not frozen_ok or not adapter_moved:
        raise SystemExit("optimizer mask leaked into base weights")

    # 2) publish: slice the adapter out of the bank, commit it through
    #    the checkpoint layer like any other artifact
    adapter = extract_adapter(trainer.model, 0)
    publish_dir = args.publish_dir or os.path.join(
        tempfile.mkdtemp(prefix="lora_publish_"), "tuned")
    save_sharded_checkpoint(
        publish_dir,
        {"step": trainer.global_step, "lora_rank": args.rank,
         "lora_targets": list(lora.targets), "state": adapter})
    ckpt = load_sharded_checkpoint(publish_dir)
    assert ckpt["lora_rank"] == args.rank
    published = ckpt["state"]
    n_leaves = sum(len(pair) for pair in _pairs(published))
    print(f"published adapter -> {publish_dir} "
          f"({n_leaves} low-rank leaves, rank {args.rank})")

    # 3) hot-load into a running engine next to the base model
    dec = TransformerLM(dataclasses.replace(plain_cfg, decode=True),
                        device="meta")
    base_params = strip_lora(trained)
    prompt = [3, 4, 5, 6]
    kw = dict(max_new_tokens=args.max_new, seed=7)

    client = ServeClient(dec, base_params, num_slots=4, prefill_len=8,
                         max_resident_adapters=2, lora_rank=args.rank,
                         device=device)
    rid_base = client.submit(prompt, **kw)            # base traffic...
    base_tok = client.run_until_idle()[rid_base].tokens
    client.load_adapter("tuned", published)           # ...then hot load
    rid_mix_b = client.submit(prompt, **kw)           # mixed batch:
    rid_mix_t = client.submit(prompt, adapter="tuned", **kw)
    mixed = client.run_until_idle()
    client.shutdown()
    tuned_tok = mixed[rid_mix_t].tokens

    hits = sum(t == (p + 1) % VOCAB for t, p in zip(
        tuned_tok, prompt[-1:] + tuned_tok[:-1]))
    print(f"base row: {base_tok}\ntuned row: {tuned_tok} "
          f"({hits}/{len(tuned_tok)} successor-rule tokens)")

    # identity self-checks: hot load == build-time residency, and the
    # null row == a bankless engine
    ref = ServeClient(dec, base_params, num_slots=4, prefill_len=8,
                      adapters={"tuned": published},
                      max_resident_adapters=2, lora_rank=args.rank,
                      device=device)
    r0 = ref.submit(prompt, **kw)
    r1 = ref.submit(prompt, adapter="tuned", **kw)
    ref_out = ref.run_until_idle()
    ref.shutdown()
    bare = ServeClient(dec, base_params, num_slots=4, prefill_len=8,
                       device=device)
    r2 = bare.submit(prompt, **kw)
    bare_tok = bare.run_until_idle()[r2].tokens
    bare.shutdown()

    ok = (mixed[rid_mix_t].tokens == ref_out[r1].tokens
          and mixed[rid_mix_b].tokens == ref_out[r0].tokens
          and base_tok == bare_tok == mixed[rid_mix_b].tokens)
    print(f"hot-load ≡ build-time residency, null row ≡ bankless: {ok}")
    if not ok:
        raise SystemExit("adapter lifecycle identity check failed")
    return dict(frozen=frozen_ok, adapter_moved=adapter_moved,
                identical=ok, hits=hits, tuned=tuned_tok, base=base_tok)


def _pairs(tree):
    """The ``{"lora_A", "lora_B"}`` pairs of an adapter tree."""
    if "lora_A" in tree and "lora_B" in tree:
        yield tree
        return
    for value in tree.values():
        yield from _pairs(value)


if __name__ == "__main__":
    main()
