"""Continuous-batching serving example, on the PyTorch/CUDA port.

The port's twin of ``examples/serve_example.py``. Trains a tiny GPT on
the synthetic token stream, then drives the
:mod:`ray_lightning_tpu_torch.serve` engine with a staggered arrival
trace: requests with different prompt lengths, budgets and sampling
params join MID-FLIGHT while earlier requests are still decoding, and
finished requests hand their KV slot to the next one.

    python examples/serve_example_torch.py --num-slots 4 --requests 12
    python examples/serve_example_torch.py --attention-kernel cuda
        # page-native KV with the hand-written paged-attention kernel
    python examples/serve_example_torch.py --weight-dtype int8 \\
        --matmul-kernel cuda  # the fused dequant-matmul kernel
    python examples/serve_example_torch.py --fleet-replicas 2 \\
        --fleet-backend process   # one dispatch process per replica
    python examples/serve_example_torch.py --adapter tuned=/path/to/publish \\
        --tenant-classes 'fast:interactive@tuned,bulk:batch'
        # batched multi-LoRA: adapter rows + base rows in one dispatch,
        # class 'fast' bound to the adapter with no per-request flag
    python examples/serve_example_torch.py --fleet-replicas 2 \\
        --trace-out trace.json   # per-request latency decomposition +
        # a stitched multi-track Chrome trace (open in Perfetto)
    python examples/serve_example_torch.py --journal /tmp/serve.wal
        # driver-death survival: write-ahead journal, a simulated
        # mid-decode driver kill, warm restart + token-exact replay

The same trace is replayed as a static batch (one-shot ``generate()``
that must wait for the LAST arrival before starting) as the check:
greedy requests must be token-identical to ``generate()``.

Runs on the card by default (``RuntimeError`` without one); ``--cpu``
runs on the CPU. The kernel choices are the port's names: ``torch`` for
the plain PyTorch versions (the JAX script's ``xla``), ``cuda`` for the
hand-written kernels (its ``pallas``).
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from ray_lightning_tpu_torch import resolve_device


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-slots", type=int, default=4,
                        help="KV slot pool size = max in-flight requests.")
    parser.add_argument("--requests", type=int, default=12)
    parser.add_argument("--prefill-len", type=int, default=16,
                        help="Prompt-fill width (max prompt).")
    parser.add_argument("--max-new", type=int, default=24)
    parser.add_argument("--gap", type=int, default=3,
                        help="Arrival gap between requests, in engine "
                             "dispatches (tick clock).")
    parser.add_argument("--prefill-priority", type=float, default=1.0,
                        help="1.0 = inject arrivals eagerly (best TTFT), "
                             "0.0 = batch prefills (best throughput).")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="K decode steps per dispatch (multi-step "
                             "scheduling: amortizes fixed dispatch cost; "
                             "joins/retires every K tokens).")
    parser.add_argument("--attention-kernel", default=None,
                        choices=["torch", "cuda"],
                        help="page-native attention read-side kernel "
                             "(implies a paged page-native engine): "
                             "'cuda' runs the hand-written paged-"
                             "attention kernel (its plain version on "
                             "the CPU), 'torch' the plain PyTorch "
                             "path. Greedy rows stay verified against "
                             "generate() either way.")
    parser.add_argument("--async-dispatch", action="store_true",
                        help="depth-2 pipelined dispatch: enqueue the "
                             "next decode dispatch before syncing the "
                             "previous one's tokens -- host work "
                             "overlaps the in-flight dispatch, tokens "
                             "stay identical to the sync driver.")
    parser.add_argument("--weight-dtype", default=None,
                        choices=["int8", "int4"],
                        help="weight-only quantization: store params "
                             "as int8/int4 codes + f32 scales "
                             "(storage-only -- compute stays the model "
                             "dtype; logits shift by one bounded "
                             "rounding per weight, so greedy rows are "
                             "no longer verified against generate()'s "
                             "full-precision reference).")
    parser.add_argument("--weight-group-size", type=int, default=None,
                        help="int4 group length along each leaf's last "
                             "axis (default 64 -- must divide every "
                             "feature dim; this nano model's head_dim "
                             "is 32, so pass 32 or 16 with "
                             "--weight-dtype int4).")
    parser.add_argument("--matmul-kernel", default=None,
                        choices=["torch", "cuda"],
                        help="how quantized weights reach the matmuls "
                             "(needs --weight-dtype): 'torch' "
                             "dequantizes in plain PyTorch (default), "
                             "'cuda' streams the codes + scales "
                             "straight into the hand-written fused "
                             "dequant-matmul kernel (its plain version "
                             "on the CPU).")
    parser.add_argument("--adapter", action="append", default=[],
                        metavar="NAME=PATH",
                        help="hot-serve a published LoRA adapter "
                             "(repeatable): NAME binds requests, PATH "
                             "is a checkpoint directory written by "
                             "extract_adapter + save_sharded_checkpoint "
                             "(e.g. examples/lora_lifecycle_example_"
                             "torch.py --publish-dir). Adapters are "
                             "assigned round-robin across the trace "
                             "(every cycle keeps one base row), rows "
                             "with different adapters batch in the SAME "
                             "dispatches, and each adapter-bound greedy "
                             "row is verified token-identical to a solo "
                             "single-adapter engine.")
    parser.add_argument("--tenant-classes", default=None,
                        help="arm multi-tenant SLO-aware scheduling: "
                             "comma-separated 'name:tier[:weight][@"
                             "adapter]' entries, tier in "
                             "{interactive,batch} "
                             "(e.g. 'fast:interactive:4,bulk:batch:1' "
                             "-- interactive drains first, weights set "
                             "fair share within a tier, batch is "
                             "starvation-bounded). Scheduling is "
                             "ordering-only: tokens are identical to "
                             "the untenanted run, so the greedy "
                             "generate() check still holds.")
    parser.add_argument("--tenant", default=None,
                        help="comma-separated class-name cycle assigned "
                             "round-robin across the trace (needs "
                             "--tenant-classes; default: cycle every "
                             "declared class, a mixed "
                             "interactive+batch trace). A trailing "
                             "'@adapter' on a class binds that LoRA "
                             "as the class default (needs --adapter "
                             "NAME=PATH): the class's rows decode "
                             "under it with no per-request adapter= "
                             "at all -- the tenant-to-adapter binding.")
    parser.add_argument("--fleet-replicas", type=int, default=0,
                        help="serve the trace through an N-replica "
                             "ReplicaFleet instead of one ServeClient "
                             "(0 = off). Greedy rows stay verified "
                             "against generate() -- the router changes "
                             "placement, never tokens.")
    parser.add_argument("--fleet-backend", default="inproc",
                        choices=["inproc", "process"],
                        help="with --fleet-replicas: 'inproc' drives "
                             "every replica on this thread (tick "
                             "clock); 'process' gives each replica its "
                             "own dispatch process (wall clock, "
                             "queue-transport results).")
    parser.add_argument("--journal", default=None, metavar="PATH",
                        help="arm the write-ahead request journal and "
                             "demonstrate driver-death survival: serve "
                             "the trace until a few requests have "
                             "retired and the rest are mid-decode, "
                             "abandon the client WITHOUT shutdown (the "
                             "simulated driver kill -- the journal at "
                             "PATH is all that survives), then "
                             "ServeClient.restore() rebuilds cold and "
                             "replays every unretired request from its "
                             "journaled token frontier. The greedy "
                             "generate() identity check runs on the "
                             "merged pre-kill + post-restore output. "
                             "Standalone client only.")
    parser.add_argument("--trace-out", default=None, metavar="PATH",
                        help="arm telemetry and export the stitched "
                             "Chrome trace of the serve run to PATH "
                             "(request latency segments + engine spans; "
                             "multi-track pid=replica seat / tid=KV "
                             "slot with --fleet-replicas; open in "
                             "chrome://tracing or Perfetto). Also "
                             "prints the per-request latency "
                             "decomposition.")
    parser.add_argument("--max-epochs", type=int, default=1)
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="Run on the CPU; without it the script needs "
                             "a card.")
    parser.add_argument("--use-gpu", action="store_true", default=False,
                        help="The card (the default).")
    return parser


def _pairs(tree):
    """The ``{"lora_A", "lora_B"}`` pairs of an adapter tree."""
    if "lora_A" in tree and "lora_B" in tree:
        yield tree
        return
    for value in tree.values():
        yield from _pairs(value)


def main(argv=None, *, dtype=None):
    """Run the example. ``dtype`` overrides the model's compute dtype
    (bf16 by default): a caller that needs greedy identity on the card
    past bf16's thin margins on a briefly trained model passes
    ``torch.float32``. Returns the completions, the greedy check's
    verdict and the engine's counters."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.fleet_backend == "process" and not args.fleet_replicas:
        parser.error("--fleet-backend process needs --fleet-replicas N")
    if args.journal and args.fleet_replicas:
        parser.error("--journal demos the standalone-client restart "
                     "(fleet warm restarts: tests/test_torch_process_"
                     "journal.py)")
    if args.matmul_kernel == "cuda" and args.weight_dtype is None:
        parser.error("--matmul-kernel cuda needs --weight-dtype "
                     "(the fused kernel consumes quantized codes)")
    if args.tenant is not None and args.tenant_classes is None:
        parser.error("--tenant needs --tenant-classes (it names "
                     "classes that flag declares)")
    adapter_specs = {}
    for spec in args.adapter:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            parser.error(f"bad --adapter entry {spec!r}: expected "
                         "NAME=PATH")
        if name in adapter_specs:
            parser.error(f"duplicate --adapter name {name!r}")
        adapter_specs[name] = path
    tenant_classes = None
    tenant_cycle = []
    if args.tenant_classes is not None:
        from ray_lightning_tpu_torch.serve import TenantClass
        tenant_classes = []
        for spec in args.tenant_classes.split(","):
            spec, _, bound = spec.strip().partition("@")
            parts = spec.split(":")
            if len(parts) not in (2, 3):
                parser.error(f"bad --tenant-classes entry {spec!r}: "
                             "expected name:tier[:weight][@adapter]")
            if bound and bound not in adapter_specs:
                parser.error(f"--tenant-classes binds adapter "
                             f"{bound!r} which no --adapter NAME=PATH "
                             "declares")
            try:
                tenant_classes.append(TenantClass(
                    parts[0], tier=parts[1],
                    weight=float(parts[2]) if len(parts) == 3 else 1.0,
                    adapter=bound or None))
            except ValueError as exc:
                parser.error(f"bad --tenant-classes entry {spec!r}: "
                             f"{exc}")
        tenant_cycle = (args.tenant.split(",") if args.tenant
                        else [c.name for c in tenant_classes])
        declared = {c.name for c in tenant_classes} | {"default"}
        unknown = [t for t in tenant_cycle if t not in declared]
        if unknown:
            parser.error(f"--tenant names undeclared classes {unknown} "
                         f"(declared: {sorted(declared)})")
    device = "cpu" if args.cpu else None
    resolve_device(device)      # the card unless --cpu: never a fallback

    from ray_lightning_tpu_torch import (GPTModule, RayStrategy, Trainer,
                                         TransformerLM)
    from ray_lightning_tpu_torch.models.generate import generate
    from ray_lightning_tpu_torch.serve import SchedulerConfig, ServeClient

    # 1) train the tiny GPT
    seq_len = 64
    module = GPTModule(size="nano", batch_size=8, seq_len=seq_len,
                       num_samples=128, vocab_size=256)
    if dtype is not None:
        module.cfg = dataclasses.replace(module.cfg, dtype=dtype)
    trainer = Trainer(strategy=RayStrategy(num_workers=1, device=device),
                      max_epochs=args.max_epochs, enable_progress_bar=False,
                      enable_checkpointing=False, seed=0)
    trainer.fit(module)
    params = {k: v.detach().cpu().clone()
              for k, v in trainer.model.state_dict().items()}

    # 2) serving layout: the engines take a meta-device model and a host
    #    state dict, and place both on the device themselves
    dec_cfg = dataclasses.replace(module.cfg, decode=True)
    dec = TransformerLM(dec_cfg, device="meta")

    # published LoRA adapters: load each NAME=PATH checkpoint (the
    # lifecycle example's publish format -- meta carries the rank, the
    # state is the extract_adapter tree) and arm a resident bank sized
    # to hold them all: rows bound to different adapters batch in the
    # same dispatches.
    adapters = {}
    lora_rank = None
    if adapter_specs:
        from ray_lightning_tpu_torch.core.checkpoint import \
            load_sharded_checkpoint
        for name, path in adapter_specs.items():
            ckpt = load_sharded_checkpoint(path)
            adapters[name] = ckpt["state"]
            rank = ckpt.get("lora_rank")
            if rank is None:  # older publishes: read it off a slice
                rank = int(next(_pairs(ckpt["state"]))["lora_A"].shape[-1])
            if lora_rank not in (None, rank):
                parser.error(f"adapter {name!r} has rank {rank} but an "
                             f"earlier one has {lora_rank}: one bank "
                             "holds one rank")
            lora_rank = rank
        print(f"serving {len(adapters)} LoRA adapter(s) "
              f"{sorted(adapters)} (rank {lora_rank}) from one "
              "resident bank")

    # 3) a deterministic staggered trace: ragged prompts, mixed budgets
    #    and sampling params (greedy rows are verified against generate())
    rng = np.random.default_rng(0)
    trace = []
    for i in range(args.requests):
        plen = int(rng.integers(2, args.prefill_len + 1))
        prompt = [int(t) for t in rng.integers(0, 256, size=plen)]
        greedy = i % 2 == 0
        kw = dict(prompt=prompt, max_new_tokens=args.max_new,
                  temperature=0.0 if greedy else 0.8,
                  top_k=None if greedy else 20)
        if tenant_cycle:
            # round-robin class assignment: a mixed interactive+batch
            # trace by default, or whatever cycle --tenant names
            kw["tenant"] = tenant_cycle[i % len(tenant_cycle)]
        if adapters:
            # rows whose tenant class binds a default adapter carry no
            # adapter= at all -- the engine resolves the class default
            # at admission (the tenant-to-adapter binding); everything
            # else cycles [base, *adapters] explicitly so every batch
            # mixes adapted and base rows
            bound = {c.name for c in (tenant_classes or [])
                     if c.adapter is not None}
            if kw.get("tenant") not in bound:
                # i//2 keeps the cycle out of phase with the
                # greedy/sampled alternation: each adapter (and the
                # base) gets one greedy AND one sampled row per cycle
                acycle = [None] + sorted(adapters)
                name = acycle[(i // 2) % len(acycle)]
                if name is not None:
                    kw["adapter"] = name
        trace.append((i * args.gap, kw))

    # --attention-kernel selects the page-native read-side kernel; the
    # page-native layout it rides on needs a paged arena, so the flag
    # implies page_size/page_native (16-token pages divide the example
    # model's 64-token max_seq_len)
    paged_kw = {}
    if args.attention_kernel is not None:
        paged_kw = dict(page_size=16, page_native=True,
                        attention_kernel=args.attention_kernel)
    engine_kw = dict(
        num_slots=args.num_slots,
        prefill_len=args.prefill_len,
        steps_per_dispatch=args.steps_per_dispatch,
        async_dispatch=args.async_dispatch,
        weight_dtype=args.weight_dtype,
        weight_group_size=args.weight_group_size,
        matmul_kernel=args.matmul_kernel, **paged_kw,
        tenant_classes=tenant_classes,
        **(dict(adapters=adapters,
                max_resident_adapters=len(adapters),
                lora_rank=lora_rank) if adapters else {}),
        scheduler_config=SchedulerConfig(
            prefill_priority=args.prefill_priority),
        device=device)
    # --trace-out arms telemetry: events assemble into per-request span
    # trees and the whole run exports as one Chrome trace
    tel = None
    if args.trace_out:
        from ray_lightning_tpu_torch.obs import Telemetry
        tel = Telemetry()
    unit, ufmt = "ticks", ".0f"
    counters = {}
    if args.fleet_replicas:
        from ray_lightning_tpu_torch.serve import ReplicaFleet
        wall = args.fleet_backend == "process"
        if wall:
            # process replicas run on a wall clock: reinterpret the
            # tick gaps as 20 ms each so arrivals still stagger
            trace = [(t * 0.02, kw) for t, kw in trace]
            unit, ufmt = "s", ".2f"
        fleet = ReplicaFleet(dec, params, backend=args.fleet_backend,
                             num_replicas=args.fleet_replicas,
                             telemetry=tel, **engine_kw)
        t0 = time.perf_counter()
        out = fleet.serve_trace(trace)
        serve_wall = time.perf_counter() - t0
        detail = (f"{args.fleet_replicas} {args.fleet_backend} replicas"
                  + (f", dispatch turns {fleet.replica_steps}" if wall
                     else ""))
        if tel is not None:
            fleet.export_fleet_trace(args.trace_out)
        fleet.shutdown()
    elif args.journal:
        from ray_lightning_tpu_torch.serve import Journal, read_journal
        # every possible kill-point frontier must fit the replay window
        # (prompt + already-emitted tokens re-feed through ONE prefill
        # pass), so widen the prefill to prompt + full budget
        jkw = dict(engine_kw,
                   prefill_len=args.prefill_len + args.max_new)
        client = ServeClient(dec, params, telemetry=tel,
                             journal=Journal(args.journal, sync_every=1),
                             **jkw)
        t0 = time.perf_counter()
        arrivals = list(trace)
        tick = submitted = 0
        while True:
            while arrivals and arrivals[0][0] <= tick:
                client.submit(**arrivals.pop(0)[1])
                submitted += 1
            client.tick()
            tick += 1
            done = len(client.completions)
            if done >= 2 and done < submitted:
                break  # some retired, some mid-decode: kill NOW
            if submitted == len(trace) and done == submitted:
                break  # trace drained before the kill point (tiny run)
        # the "kill": walk away mid-decode -- no drain, no shutdown.
        # Completions already delivered stay in the caller's hands;
        # the journal on disk is everything the restart gets.
        pre = dict(client.completions)
        st = read_journal(args.journal)
        n_replay = len(st.pending())
        print(f"\ndriver killed at tick {tick}: {len(pre)} retired, "
              f"{n_replay} mid-flight, {len(arrivals)} not yet arrived")
        print("(replayed rows keep their journaled arrival stamps while "
              "the restarted driver's tick clock restarts at 0, so "
              "their latency/ttft readouts below can go negative -- "
              "tokens, not clocks, are the identity contract)")
        restored = ServeClient.restore(args.journal, dec, params,
                                       telemetry=tel, **jkw)
        for _, kw in arrivals:  # arrivals the dead driver never saw
            restored.submit(**kw)
        out = dict(pre)
        out.update(restored.run_until_idle())
        serve_wall = time.perf_counter() - t0
        counters = dict(replayed=n_replay, killed_at_tick=tick,
                        retired_before_kill=len(pre))
        detail = (f"driver killed + warm restart replayed {n_replay} "
                  f"mid-flight requests from {args.journal}")
        if tel is not None:
            from ray_lightning_tpu_torch.obs.tracing import \
                export_fleet_chrome_trace
            export_fleet_chrome_trace(args.trace_out, tel)
    else:
        client = ServeClient(dec, params, telemetry=tel, **engine_kw)
        t0 = time.perf_counter()
        out = client.serve_trace(trace)
        serve_wall = time.perf_counter() - t0
        counters = dict(prefills=client.engine.prefills,
                        steps=client.engine.steps,
                        decode_steps=client.engine.decode_substeps)
        detail = (f"{client.engine.prefills} prefills, "
                  f"{client.engine.steps} decode steps")
        if tel is not None:
            from ray_lightning_tpu_torch.obs.tracing import \
                export_fleet_chrome_trace
            export_fleet_chrome_trace(args.trace_out, tel)
    total_tokens = sum(len(c.tokens) for c in out.values())
    result = dict(completions=out, serve_s=serve_wall,
                  tokens=total_tokens, identical=None, **counters)

    print(f"\nserved {len(out)} requests / {total_tokens} tokens in "
          f"{serve_wall:.2f}s wall ({detail})")
    for rid in sorted(out):
        c = out[rid]
        cls = f" [{c.tenant}]" if tenant_classes else ""
        ad = f" <{c.adapter}>" if c.adapter else ""
        print(f"  req {rid:2d}: prompt {len(c.prompt):2d} toks -> "
              f"{len(c.tokens):2d} generated ({c.finish_reason}), "
              f"latency {c.latency:{ufmt}} {unit}, "
              f"ttft {c.time_to_first_token:{ufmt}} {unit}{cls}{ad}")

    if tel is not None:
        from ray_lightning_tpu_torch.obs.tracing import format_decomposition
        print(f"\nper-request latency decomposition ({unit}) -- Chrome "
              f"trace exported to {args.trace_out}:")
        print(format_decomposition(tel.request_traces()))

    if tenant_classes:
        # per-class rollup: interactive classes should show the lower
        # TTFTs -- that ordering is what the tiers buy
        print("\nper-tenant (tier/weight -> served, mean ttft):")
        for cls in tenant_classes:
            comps = [c for c in out.values() if c.tenant == cls.name]
            ttfts = [c.time_to_first_token for c in comps
                     if c.time_to_first_token is not None]
            mean = (sum(ttfts) / len(ttfts)) if ttfts else float("nan")
            print(f"  {cls.name:>8s} ({cls.tier}, w={cls.weight:g}): "
                  f"{len(comps):2d} served, mean ttft {mean:.1f} {unit}")

    # 4a) the multi-LoRA identity contract, driven end to end: every
    #     adapter-bound greedy row in the MIXED batch must be
    #     token-identical to a solo engine holding only that adapter
    #     (same bank capacity). Holds under quantization too -- the LoRA
    #     delta rides outside the quantized base matmul.
    if adapters:
        groups = {}
        for i in range(len(trace)):
            if trace[i][1]["temperature"] == 0.0 and out[i].adapter:
                groups.setdefault(out[i].adapter, []).append(i)
        solo_kw = dict(engine_kw)
        solo_kw.pop("tenant_classes", None)
        mism = 0
        for name, rids in sorted(groups.items()):
            solo_kw["adapters"] = {name: adapters[name]}
            solo = ServeClient(dec, params, **solo_kw)
            sids = [solo.submit(trace[rid][1]["prompt"],
                                max_new_tokens=args.max_new,
                                adapter=name) for rid in rids]
            comps = solo.run_until_idle()
            solo.shutdown()
            mism += sum(out[rid].tokens != comps[sid].tokens
                        for rid, sid in zip(rids, sids))
        n = sum(len(v) for v in groups.values())
        result["adapter_rows"] = n
        print(f"\nadapter-bound greedy rows token-identical to solo "
              f"single-adapter engines: {mism == 0} ({n} rows)")
        if mism:
            raise SystemExit("mixed-adapter batch diverged from solo "
                             "engines")

    # 4b) verify base greedy rows against one-shot generate(), and show
    #    what the static batch costs: it cannot start before the LAST
    #    arrival. (Quantized weights perturb logits by design -- the
    #    identity check only holds at full precision.)
    if args.weight_dtype is not None:
        print("\nweight_dtype set: skipping the full-precision "
              "generate() identity check (quantization perturbs "
              "logits; determinism, not logit-identity, is the "
              "quantized contract)")
        return result
    greedy_ids = [i for i, (_, kw) in enumerate(trace)
                  if kw["temperature"] == 0.0 and out[i].adapter is None]
    if not greedy_ids:
        print("\nno base greedy rows in this trace: skipping the "
              "generate() identity check")
        return result
    prompts = [trace[i][1]["prompt"] for i in greedy_ids]
    P = max(len(p) for p in prompts)
    batch = np.zeros((len(prompts), P), np.int32)
    lengths = np.array([len(p) for p in prompts], np.int32)
    for r, p in enumerate(prompts):
        batch[r, :len(p)] = p
    gen_model = TransformerLM(dec_cfg, device=device)
    gen_model.load_state_dict(params)
    ref = generate(gen_model, None, batch, max_new_tokens=args.max_new,
                   rng=0, temperature=0.0,
                   prompt_lengths=lengths).cpu().numpy()
    ok = all(out[rid].tokens == [int(t) for t in ref[r, L:L + args.max_new]]
             for r, (rid, L) in enumerate(zip(greedy_ids, lengths)))
    result.update(identical=ok, greedy_rows=len(greedy_ids))
    print(f"\ngreedy rows token-identical to one-shot generate(): {ok}")
    if not ok:
        raise SystemExit("engine/generate mismatch")
    return result


if __name__ == "__main__":
    main()
