"""Drive the PyTorch/CUDA port (``ray_lightning_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing its result line:

0. Require a CUDA device; print the card's name and power limit; start
   the fork server phase X's workers fork from (it imports torch while
   the kernels build); build every kernel from
   ``ray_lightning_tpu_torch/csrc`` (one ``nvcc`` per source, all started
   together); check with ``cuobjdump -sass`` that
   every tensor-core kernel (``*tc_kernel``) holds ``HGMMA`` instructions
   (``wgmma``); turn TF32 off.
1. The paged-attention kernel (K1) against its plain PyTorch version at
   the shapes of the GPT-2-small serving path (B=8 slots, H=12, D=64,
   page_size 16, pages_per_slot 64, ragged positions 0..1000, unmapped −1
   page-table entries, one row with every key masked): f32, bf16 and int8
   pages, T=1 and T=4. Prints each case's max abs error against its
   stated bound, the kernel's launch geometry (grid, cluster size,
   shared memory, clusters the card holds at once), the kernel's time, the
   plain version's time, the time of one PyTorch library call of the same
   function, and the least time the card could take (bytes over 3.35 TB/s
   or operations over the peak rate of their type, whichever is larger).
   A second call of each case must give the same bits.
T1. The flash-attention kernels (K2 forward, K3 dK/dV, K4 dQ -- each on
   the tensor cores in bf16 and the CUDA cores in f32, every call's route
   checked) against their plain versions at the training path's shapes
   (B=8, T=S=1024, H=12, D=64, causal) in bf16 and f32, and on a ragged
   length (T=S=1000), end-aligned T=512 < S=1024, non-causal, and T=64 >
   S=32 (rows that admit no key): the max abs error of out, lse, dq, dk
   and dv against stated bounds (bf16 out and gradients element by
   element) and the share of each bound used. At the path shapes, each
   kernel's time on a cold L2 beside its bound, its plain version's time
   and the library's (``F.scaled_dot_product_attention`` under each
   backend that runs these inputs -- flash, efficient, cuDNN --, the
   fastest forward; its fastest backward for K3+K4).
2. The serving path: GPT-2-small at full width (random weights from
   ``np.random.default_rng(0)``, a flax-layout tree carried across by
   ``interop.load_flax_params``) served by ``ServeClient(...,
   page_native=True, attention_kernel="cuda")`` over a trace of 12
   requests, some arriving mid-flight, greedy and sampled. Every request
   must finish with its full budget, and K1 must have launched
   ``n_layers`` times per decode step. Repeated with ``kv_dtype="int8"``.
3. Serving, kernel path against plain path end to end, in f32: the first
   decode step after prefill from the same arena, logits held to 1e-3;
   then the share of greedy tokens the two paths agree on over the trace.
Q1. The fused dequant-matmul kernel (K5) against its plain PyTorch
   version at the quantized serving path's shapes: GPT-2-small's five
   projections (qkv 768 -> 3x12x64, out 768 -> 768, up 768 -> 3072, down
   3072 -> 768, and the tied head 768 -> 50257, transposed) at M=8 (a
   decode step) and M=1024 (a prefill dispatch), int8 and int4 codes
   (group 64), bf16 and f32 x, plus a ragged M=7 and, for bf16 x, M=128
   (a chunk dispatch of phase L); bounds f32 1e-5 and
   bf16 2**-7 of max(1, max|ref|); a second call of each case must give
   the same bits, and each M=8 case prints its GEMV's launch geometry
   (grid, cluster size that splits K, columns a block, bytes per code
   load, clusters the card holds at once). Each path case prints its cold-L2
   time, its bound and what bounds it, the plain version's time and the
   time of ``torch.matmul`` by the weight already dequantized to x's dtype
   (cuBLAS, no dequant in the timed call). M=8 runs the decode GEMVs,
   M=1024, M=128, M=40 and M=7 the tensor-core kernel (bf16) or the tiled
   one (f32). Then three rows each for bf16 x with int8 and int4 codes: a
   forward's 49 calls (n_layers x qkv, out, up, down, and the head) at
   M=1024 (a prefill), at M=128 (a chunk) and at M=40 (a verify), times,
   cuBLAS times and bounds summed.
Q2. Quantized serving: phase 2's trace served by ``ServeClient(...,
   page_native=True, attention_kernel="cuda", matmul_kernel="cuda")``
   with ``weight_dtype="int8"`` and again with ``"int4"``. Every request
   finishes with its full budget, K5 launches 4·n_layers + 1 times per
   forward (decode steps and prefill dispatches) -- every prefill call on
   the tensor-core route, every decode call on a GEMV, none on the tiled
   one -- and the engine's param bytes are at most 0.26x (int8) and 0.15x
   (int4) of the f32 model's.
Q3. As phase 3, in f32 with int8 weights: kernel path (K1 and K5) against
   plain path, the first decode step's logits to 1e-3, then the share of
   greedy tokens the two agree on (information only).
L. Long prompts and shared prefixes: GPT-2-small (phase 2's weights)
   served by ``ServeClient(..., page_size=16, num_pages=512,
   num_slots=8, prefill_len=128, prefill_chunk=128, prefix_cache=True,
   page_native=True, attention_kernel="cuda")`` over a trace of 12
   requests from the same generator: 8 share a 512-token system prompt
   (each with a suffix of its own, 32..256 tokens), 2 have 896-token
   prompts, 2 short ones (16..64); budgets 32..64; 4 arrive while others
   decode; 2 sample. Three runs: bf16 KV, int8 KV, and int8 weights
   (``matmul_kernel="cuda"``). Every request finishes with its budget;
   every prompt goes through chunks (no batched prefill); K2 launches
   n_layers times per chunk dispatch, all on ``tc``; K1 n_layers per
   decode step; with int8 weights K5 4 x n_layers + 1 times per chunk on
   ``tc`` and per decode step on the GEMVs, none on ``tiled_f32``; the
   pages each request adopts equal the count worked out from the order
   of admissions and the first shared prompt's publish (32 for a shared
   request admitted after it, else 0); no two chunk dispatches back to
   back while a row decodes. Printed per run: TTFT (submit to the end of
   the final chunk; median, max) of the long and the shared requests,
   ms per chunk dispatch (host; synchronized), the decode stall (gaps
   between decode dispatches while a prompt streams; p50, max), decode
   tokens/s, prefix hit rate and pages saved. In f32, the logits after
   the final chunk of a publishing, a long and an adopting prompt: kernel
   path against plain path and against an unchunked prefill, each to
   1e-3; the greedy share over the trace for information. K2 alone at
   the chunk's shape (B=1, T=128, bf16, q a fused-qkv view, end-aligned)
   for S = 128, 512 and 1024 keys, held by ``cf.flash_out_bound``: its
   time, bound, plain version's time and the fastest SDPA forward's.
S. Speculative decoding: phase 2's weights and trace through
   ``ServeClient(..., page_size=16, num_slots=8, page_native=True,
   attention_kernel="cuda", draft_model=..., draft_params=..., spec_k=4)``.
   (a) The draft is a 2-layer sibling cut from the target (its
   embeddings, final LayerNorm and first two blocks, by name); bf16 KV,
   then int8 KV. Every request finishes with its budget; K1 launches
   n_layers times per verify round, every launch at T = 5. Printed: the
   accept rate (accepted over judged drafts), committed tokens per
   dispatch, ms per spec dispatch (draft refills included), decode
   tokens/s, the refills and their ms, beside phase 2's non-spec figures,
   and how many greedy requests equal phase 2's tokens (bf16:
   information only). (b) f32 with the kernels: the spec engine's greedy
   tokens equal the non-spec engine's, request by request. (c) The
   target as its own draft, f32: at least 0.99 of judged drafts
   accepted, and every round that does not finish a row commits k+1
   tokens. (d) ``weight_dtype="int8", draft_weight_dtype="int8",
   matmul_kernel="cuda"`` with (a)'s draft: K5 on ``tc`` for the verify
   (M = 40), the target's prefills and the draft's refills (M = 1024), on
   the GEMVs for the draft's feeds (M = 8), never on ``tiled_f32``; the
   engine's param bytes are Q2's int8 target plus the draft's codes.
G. The dense KV layouts and decode outside the engine, phase 2's weights,
   trace and 8 slots: (a) the default layout, ``ServeClient(...,
   num_slots=8, prefill_len=128)`` (the dense slot pool), and (b) the
   dense-view paged path (``page_size=16, num_pages=512,
   page_native=False``), each with bf16 and int8 KV: every request runs
   its budget, no launch of K1 or K2 (the reference's dense layouts
   never reach them); printed per run: decode tokens/s, ms per decode
   dispatch, TTFT (median, max) beside phase 2's, and from one profiled
   decode dispatch of the trace's first 8 prompts (phase 2's page-native
   layout too; the window padded on both sides and taken again while
   the device's records and the host's launch calls differ in number):
   kernel launches (the device's records, or the host's launch calls
   where more, held to ``G_DECODE_LAUNCHES`` within
   ``G_LAUNCH_SPREAD``, the profiler's spread between calls; on a miss
   every kernel's count goes to stderr), the host's launch calls, device
   busy ms and idle share, the top kernels, and the KV storage's bytes.
   (c) ``weight_dtype="int8", matmul_kernel="cuda"``
   on the dense pool: K5 on the GEMVs 49 times a decode step, on ``tc``
   49 times a prefill, never on ``tiled_f32``; in f32 the first decode
   step's logits of the kernel path against the plain path within
   ``E2E_LOGITS_TOL`` and every request's greedy tokens equal. (d)
   ``generate()`` on the trace's first 8 greedy prompts (ragged, padded
   to 128) for 64 tokens: in f32 its tokens equal ``generate_full_scan``'s
   and those of the dense, the dense-view and the page-native engines;
   tokens/s in bf16,
   and with int8 weights, K5 on the GEMVs 49 times a step and on ``tc``
   49 times for the prefill. (e) phase S's draft (``spec_k=4``) on both
   dense layouts: f32 greedy tokens equal the non-spec engine's of the
   layout; with int8 weights for both models, K5's verify (M = 40) and
   prefills on ``tc``, the draft's feeds on the GEMVs.
P. Async dispatch, phase 2's weights and trace (greedy and sampled rows),
   8 slots, on four engines: page-native (K1), int8 weights (K5),
   chunked with the prefix cache (phase L's layout, K2) and spec at k = 4
   (phase S's draft). (a) Each in bf16 and in f32 through
   ``ServeClient(async_dispatch=True)`` and the sync client: tokens and
   finish reasons bitwise equal. (b) Every steady-state ``step_enqueue``
   (one chaining on an outstanding carry) of the bf16 runs, and of a
   greedy-only spec run, under ``torch.cuda.set_sync_debug_mode("error")``:
   no synchronizing call, and at least one such enqueue checked. (c) Per
   engine, sync beside async: host ms a step tick, the ms a sync waits on
   its event, decode tokens/s (decode tokens over the step ticks' and the
   pipeline drains' host time) and their ratio, and for the page-native
   engine one profiled decode tick (``p_profile``): launches, device busy
   ms and idle share.
A. Multi-LoRA and tenancy, phase 2's weights, a page-native engine with
   ``max_resident_adapters=4, lora_rank=16`` and three random adapters
   (N(0, 0.1) entries). (a) f32, a mixed batch of 8 requests (two under
   each adapter, two base): adapted rows equal a bankless engine with
   merged weights W + A @ B, and differ from the base model's stream;
   base rows equal the bankless engine; each request equals its solo run.
   (b) bf16 with int8 weights (K5): the bankless and the armed engine on
   the trace, K5's routes exactly 4 x n_layers GEMVs and one head GEMV a
   decode step and 49 ``tc`` calls a prefill (the bank adds no K5
   launch), K1 n_layers a decode step, ``param_bytes()`` and
   ``adapter_bank_bytes()`` equal to the bytes worked out from the
   shapes; a decode tick's launches and device busy ms armed beside
   bankless; the trace with adapters through chunks (phase L's layout):
   K2 n_layers a chunk on ``tc``, K5 49 ``tc`` calls a chunk. (c) Hot
   load during a trace on the async client, LRU eviction of the least
   recently bound adapter, a pinned adapter that refuses to unload, an
   ``UnknownAdapter`` shed, and the hot-loaded adapter's tokens equal a
   fresh engine's. (d) Two tenant classes (weights 3:1, the heavier with
   a default adapter): the first 8 admissions 6 : 2, and every request's
   tokens equal its solo run's. (e) Spec (phase S's draft) with adapters,
   f32: (a)'s tokens. (f) The async client with adapters: (b)'s sync
   tokens.
F. Faults and telemetry, phase 2's weights (each run through a fresh
   ``ServeClient(retry_policy=RetryPolicy(max_attempts=3, base_delay=0))``,
   its recoveries, host ms and the card's allocated bytes after every
   rebuild recorded). (a) Phase 2's page-native engine and trace, f32:
   ``serve.dispatch`` crashes at the first prefill, the first decode
   dispatch (8 rows in flight) and the first later decode dispatch where
   some row's prompt + emitted tokens exceed ``max_replay_len`` (128),
   the ticks worked out from the fault-free run's dispatches: every
   replayed request's tokens, greedy and sampled, equal the fault-free
   run's, the over-long rows retire ``"failed"`` with a prefix of theirs
   and are exactly those the third recovery's snapshot predicts, 3
   rebuilds and recoveries; K1 launches after the first rebuild; bf16
   with the same crashes, its tokens against phase 2's (information).
   (b) Phase L's layout on a long trace from ``make_long_trace``
   (``default_rng(15)``): a crash mid-chunk, a second on the first
   replay's first re-fed chunk (a failed recovery attempt, in bf16 first,
   K2 on ``tc``: it also counts the ticks that recovery adds), a third
   mid-decode; f32: tokens equal, 3 rebuilds in 2 recoveries, K2
   launched inside each recovery. (c) Phase S's spec engine (k = 4), f32,
   two ``serve.verify`` crashes: tokens equal, K1 at T = 5 after the
   rebuilds. (d) int8 weights through K5 on the async client, f32: a
   crash at a steady-state enqueue; the in-flight handle is discarded
   (kept until its copy's event completes), never synced; tokens equal;
   K5 after the rebuild. (e) A journal (``sync_every=8``) on phase 2's
   engine with ``prefill_chunk=128``: the ``serve.driver`` site kills
   the driver at tick F_DRIVER_KILL; ``ServeClient.restore`` finishes
   the trace with (a)'s fault-free tokens, re-emitting no retired
   request; the journal's bytes, records, fsyncs and ms per fsync. (f)
   Phase 2's bf16 trace with ``Telemetry(clock=time.perf_counter,
   jsonl_path=...)`` armed beside disarmed: tokens equal; a profiled
   decode dispatch's launches armed and disarmed within G_LAUNCH_SPREAD
   of phase G's 749; the armed async client's steady-state enqueues under
   ``set_sync_debug_mode("error")``; the Chrome trace parses with the
   JAX span names; host ms a tick armed and disarmed, events by name.
   (g) The allocated bytes equal after every rebuild of a run (no second
   engine on the card); recovery ms per crash of each run.
T2. The training path: ``Trainer(strategy=RayStrategy(num_workers=1),
   max_epochs=1, limit_train_batches=20, limit_val_batches=2,
   seed=0).fit(GPTModule(config=gpt2_config("small",
   attention_impl="flash"), batch_size=8, seq_len=1024))`` -- full width,
   bf16 compute over f32 master weights, AdamW (lr 3e-4, b2 0.95, weight
   decay 0.1). Every loss finite, the last 5 steps' mean below the first
   step's, K2 launched n_layers x (train steps + validation batches)
   times and K3 and K4 n_layers x train steps, every launch of the three
   on the tensor-core route. Prints the median step,
   tokens/s, the share of bf16 peak, peak memory and the attention
   kernels' share of a step.
T3. Training, kernel path against plain path end to end, in f32: one
   step's loss and gradients of GPT-2-small (B=2, T=1024, the same
   weights) through the kernels (``attention_impl="flash"``) and through
   plain PyTorch attention differentiated by autograd
   (``attention_impl="dot"``); loss to 1e-5 relative, every gradient to
   its stated bound.
M. The model core's training options at GPT-2-small width (bf16 compute
   over f32 weights, batch 8 x 1024, ``Trainer(strategy=RayStrategy(
   num_workers=1), seed=0)``). (a) ``dropout=0.1`` on the flash config,
   T2's steps and validation batches: no training step launches K2-K4
   (the reference routes dropout to the dense attention), validation
   launches K2 n_layers times a batch; the loss falls; step ms, tokens/s
   and peak memory beside T2's. (b) ``remat=True`` under each of the five
   policies and the same fit without remat, a few steps each: K2 twice a
   layer a step (forward and replay), K3 and K4 once, all on ``tc``; the
   bytes autograd keeps in the first step (``models/remat.py:
   count_saved``) rise ``None`` < ``dots_with_no_batch_dims`` <
   ``..._save_attn`` < ``..._save_attn_mlp`` <= no remat; step ms and
   peak memory. (c) One f32 step with dropout 0.1 (B=2), remat against
   no remat on the same seed: loss and gradients within
   ``M_REPLAY_*_RTOL`` (the masks replay). (d) ``lm_head_xent`` and
   ``chunked_lm_head_xent`` on the model's hidden states and tied table
   against the materialized f32 loss: loss and both gradients within
   ``M_XENT_*_RTOL``, each path's ms and the peak memory of its forward
   and backward. (e) ``tie_embeddings=False``: a few training steps;
   K5 at the untied head (int8, N = 50257) against its plain version at
   M = 8, 128 and 1024, all on ``tc``, timed beside its bound and cuBLAS
   (int4 cannot group this head and is refused); phase 2's trace served
   by an untied model from phase 2's generator with int8 weights: the
   head on ``tc`` at every forward, none on ``tiled_f32``; in f32 the
   kernel path's logits and greedy tokens equal the plain path's. (f)
   ``attention_impl="dot"`` with ``attention_softmax_dtype`` bf16 beside
   f32: finite losses, step ms.
R. Checkpoint and resume on the card, at T2's configuration (12 steps,
   no validation): (a) uninterrupted, saving a stream checkpoint at step
   8; (b) the same run with ``ModelCheckpoint(every_n_train_steps=4,
   save_format="orbax", keep_last_n=1)``, killed by
   ``FaultPlan.at("train.step", [9])``; (c) a new
   ``Trainer(resume="auto")``, which restores step 8 and finishes: its
   final params and optimizer state equal (a)'s bitwise, so do its losses
   for steps 9-12, and K2-K4 ran on the tensor cores for every resumed
   step; (d) ``fit(ckpt_path=)`` of (a)'s stream checkpoint, bitwise (a)
   again; (e) (b) and (c) again with ``async_save=True`` (the one-process
   asynchronous directory save: host copies on the step's thread, the
   write on the commit thread): the resume bitwise (a) as well, and each
   save's ms until it returns beside the synchronous one's. A directory
   save killed at ``ckpt.save`` leaves nothing resume picks up. Prints
   each format's checkpoint bytes, save and load ms and GB/s.
   Checkpoints live in a temporary directory the phase removes.
O. The optimizer presets, predict and the guard on the card, at T2's
   shapes: 10 steps each with ``adamw``, ``adamw_bf16m`` and
   ``adafactor`` -- every loss finite, the last 5 steps' mean below the
   first, K2-K4 on the tensor cores -- with each preset's
   ``opt_state_bytes`` (adafactor's must be the JAX preset's,
   ``ADAFACTOR_STATE_BYTES``), peak device memory and median step ms;
   ``Trainer.predict`` over 2 validation batches, its logits equal to the
   ``model.eval()`` forward bitwise, K2 launched n_layers times a batch;
   ``nonfinite_action="skip_batch"`` over 6 batches of a loss-weighted
   module with one batch NaN-poisoned by ``FaultPlan.at("loader.next",
   [2], mode="nan")``: one skipped batch, every param finite, one AdamW
   step fewer than batches.
D. Data parallelism, one process per device: T2's module and optimizer
   (``limit_val_batches=0``, seed 0) for 6 steps under each of
   ``RayStrategy`` (DDP), ``HorovodRayStrategy`` (explicit all-reduce),
   ``RayShardedStrategy`` (ZeRO-1) and ``FSDPStrategy`` (FSDP2), each fit
   launched by a ``RayLauncher`` over ``ProcessRay`` on one spawned worker
   that owns the card, in an NCCL process group of world size 1 (the
   script needs one card; NCCL refuses two ranks on one device), all four
   reusing that worker (``workers=``). DDP's and the all-reduce's losses
   must equal T2's first 6 bitwise (an all-reduce of one rank is a copy,
   and dividing by 1 is exact); ZeRO's and FSDP2's must lie within
   ``D_LOSS_RTOL`` of them (whether they are bitwise is printed). In the
   worker, K2 launches 12 x 6 times per fit and K3 and K4 12 x 6 each, all
   on ``tc``. Printed per strategy: the median step ms beside T2's, peak
   device memory, ``opt_state_bytes``, the spawn and launch-to-first-hook
   seconds, and the bytes and seconds of rank 0's ``state_stream``
   return. First, ``RayStrategy(num_workers=2)`` must raise ``ValueError``
   before anything is spawned. Then the memory presets on the same
   worker, 6 steps each: ``adamw_bf16m`` and ``adafactor`` under
   ``RayShardedStrategy`` (ZeRO by the JAX package's split of the
   optimizer state) and ``FSDPStrategy``: their losses equal phase O's
   one-process losses for the preset bitwise under ZeRO (at world size 1
   every param is one rank's whole shard), within ``D_LOSS_RTOL`` under
   FSDP2 (whether bitwise is printed), ``opt_state_bytes`` equal to phase
   O's, K2-K4 on ``tc`` in the worker; peak memory printed. No step ms
   from these 3-step medians is a finding (their spread is +-25 ms).
U. A Ray Tune trial on the card, with a fake Tune installed in this
   process (the driver) only: T2's module launched as phase D launches
   its fits, under ``RayStrategy`` with
   ``TuneReportCheckpointCallback(metrics={"loss": "val_loss"},
   on="validation_end")`` over two epochs of U_STEPS steps and one
   validation batch each, after a one-batch sanity check, and a
   ``TuneReportCallback`` of ``train_loss`` at each epoch's end. Exactly
   two validation reports (none from the sanity check), each equal
   bitwise to the worker's ``val_loss`` at that hook, and two
   ``train_loss`` reports equal to the worker's; two checkpoint files in the
   trial's directory, each 1.49 GB +- 1%; K2-K4 on ``tc`` for every
   step. ``resume_ckpt_path`` of the last -> ``fit(ckpt_path=)`` for a
   third epoch equals an uninterrupted three-epoch fit bitwise in params
   and losses. A second trial under ``FSDPStrategy`` with ``adafactor``
   reports through Ray 2.x's API (one report carrying its checkpoint);
   its last checkpoint, found by ``resume_ckpt_path()``, loads into a
   one-process trainer with the same params bitwise. Printed per
   checkpoint: bytes, serialize seconds in the worker, put to the end of
   the driver's drain, the driver's write; per report: hook to delivery.
C. The command line on the card, flags only: ``python -m
   ray_lightning_tpu_torch.cli --model-class
   ray_lightning_tpu_torch.models.GPTModule fit --strategy ddp_sharded
   --strategy.num_workers 1 --model.size small --model.optimizer
   adafactor ...`` (vocab 50257, 1024 tokens, batch 8, 3 steps, one
   validation batch) in a subprocess: its printed ``callback_metrics``
   (``train_loss``, the mean of its steps' losses, and ``val_loss``)
   equal the same fit built by hand in this process, bitwise.
H. The health of a fit, at T2's configuration (GPT-2-small, flash,
   batch 8 x 1024, AdamW, seed 0). (a) T2's 20 steps and 2 validation
   batches with ``Telemetry(clock=time.perf_counter)``,
   ``StepStatsCallback(tel, block=True)`` and ``profiler="simple"``: the
   lifecycle events in order from ``launch.start`` to ``launch.done``,
   ``train_step_ms`` with 20 observations, the ``profile_*_s`` gauges,
   K2-K4 launched 264, 240 and 240 times as in T2's disarmed fit, the
   median ``step_time_ms`` (steps 4-20) against the same fit's
   synchronized step (``block=True`` must cover the device work) and
   T2's, and the synchronized step's ms armed against T2's disarmed one.
   (b) ``FitSupervisor`` over a one-process fit of 12 steps with
   directory saves every 4 and ``FaultPlan.at("train.step", [9])``: two
   attempts (9 steps, then the 4 after the step-8 save), the final params
   and optimizer state bitwise phase R (a)'s.
   (c)-(e) one fit under ``GangSupervisor`` over a ``RayLauncher`` on
   ``ProcessRay``, each attempt one spawned worker owning the card in an
   NCCL group of world size 1, armed with a ``GangConfig``, a
   ``MemoryCheckpointStore`` installed, 8 steps with a periodic stream
   save every 4, a ``StandbyPool(num_standby=1)`` warming on the card
   from the start and attached from the third attempt: (c) attempt 1
   ends by ``FaultPlan.at("worker.exit", [5], mode="exit")`` (a real
   ``os._exit``) and restarts cold; (d) attempt 2, resumed from the
   memory tier (step 4), wedges on ``worker.stall`` before step 7; (e)
   its restart promotes the standby and finishes. The events in order
   (``worker.dead``, ``gang.teardown``, ``gang.restart``,
   ``worker.heartbeat_missed``, ``gang.teardown``, ``gang.restart``,
   ``standby.promoted``), each failure's postmortem, the resume from
   ``<memory:step=4>`` ahead of the disk, the final state bitwise the
   same fit run in this process without faults (a DDP world of one is
   the one-process fit), the card's free memory at the cold restart's
   first step within H_MEM_SLACK of the fresh worker's (one rank's
   memory, not two), the stall's detection within 10 s past
   ``heartbeat_timeout``. Printed: ms from each fault to its detection
   and to ``gang.teardown``, s from each restart to its first step (cold
   against warm), the memory tier's bytes and ms per put.
I. The input pipeline, run after T2 at T2's configuration: 8 steps fed
   by ``MultiprocessDataLoader(num_workers=2, auto_fallback=False)``
   (producers spawned: CUDA is live) and ``DevicePrefetcher(depth=2)``
   against the same 8 steps fed in-process. ``uses_ring`` and spawn;
   every batch equal on the host; the final params and optimizer state
   bitwise equal (the same token batches reach the same deterministic
   steps); one step's kernel launches and copies equal under
   ``torch.profiler`` (the host's calls; the prefetcher's two pinned
   copies take the place of ``_to_device``'s two); K2-K4 on ``tc``.
   Printed: the step ms of each, the producers' seconds to the first
   batch, the ring's bytes per second in its pops, the prefetcher's
   copies and bytes.
N. The in-process replica fleet, run after phase F on phase 2's weights
   and trace, page-native (``page_size=16, num_pages=512, num_slots=8,
   prefill_len=128, attention_kernel="cuda"``). (a) bf16, 2 replicas and
   a warm standby: the requests per replica, the fleet's tokens/s and ms
   a fleet tick beside a single client of the layout (and phase 2's
   figures), the card's bytes per client. (b) f32, a ``serve.replica``
   raise while 8 rows decode (4 on the victim): every token equal to the
   fault-free single client's, ``fleet.failover`` -> 4
   ``recovery.replay`` -> ``fleet.replica_promoted``, the bytes of the
   card's live tensors at the crash equal to those once the promoted
   replica has decoded, and its allocated bytes within
   N_ALLOCATOR_SLACK of them (the standby refilled, the dead replica
   released), ms a failover, ``request_traces()`` telescoping exactly
   on the tick clock, the Chrome trace written. (c) int8 weights on K5:
   codes and scales byte-equal across the replicas and the standby, K5
   on the GEMVs and ``tc``. (d) phase L's layout and trace on 2 replicas
   with prefix affinity: the 8 shared-prefix requests on one replica,
   pages saved and hit rates beside phase L's single client, K2 on
   ``tc`` for every chunk. Each phase prints its seconds.
X. The process replica fleet, run after phase N on phase 2's weights,
   trace and phase N's layout: ``ReplicaFleet(backend="process")``, one
   worker process per replica on this card, phase 2's trace on the wall
   clock (a tick is phase 2's median step). (a) bf16, 2 workers, each
   warmed by a greedy and a sampled request first: the requests per
   replica, each worker's seconds from spawn to ``set_replica`` and its
   bytes on the card (the free memory it took), the fleet's tokens/s and
   ms a pump tick beside phase 2's single client and phase N (a)'s
   in-process fleet. Then one f32 fleet of 2 workers and a warm standby
   (refilled on the driver's thread, so no spawn lands inside another
   measurement) under ``FleetConfig(max_request_failovers=3,
   probation_after=2)``: (b) ``inject("exit")`` into replica 0 once rows
   of both have flushed tokens: every token, sampled rows included,
   equal to the fault-free f32 single client's, the verdict
   ``replica.dead``, the card's free memory back (within
   ``X_MEM_SLACK`` of what the worker took) after the reap, ms from the
   kill to the verdict and to the re-admissions. (c) phase 2's trace
   with explicit seeds after a request whose prompt holds an id >=
   vocab_size: a device-side assert (a sticky CUDA error) in every
   worker that seats it; it retires ``failed``, ``poison_failed == 1``,
   every other request's tokens equal the fault-free single client's,
   every crash message names a CUDA error, every crashed worker held the
   poison row, the free memory back after each reap; the failovers and
   the episode's seconds. After each fleet no worker is alive and the
   free memory is back to its level before it. K1's launches in the
   workers (their ``stop()`` stats) equal n_layers per decode step the
   worker reports. Prints its seconds and the script's; every phase
   prints the script's seconds at its end.
4. A ``{"kernels": [...]}`` line, the card line again, and the result
   line ``{"ok": true, "device": {...}}``. K1 has two entries:
   ``paged_attention`` at T=1 with phase 2's, phase L's, phase P's and
   phase A's bf16 runs' launches, every phase F run's, phase N's and
   phase X's workers',
   ``paged_attention_verify`` at T=5 with phase S (a)'s, phase P's spec
   bf16 runs' and phase F (c)'s. K2 has two entries:
   ``flash_fwd`` at the training shape with T2's launches,
   ``flash_fwd_chunk`` at the chunk's shape (S=1024) with phase L's,
   phase P's chunked, phase A's chunked, phase F (b)'s bf16 and phase N
   (d)'s ``tc`` launches. K2-K4's
   training entries count T2's launches, phase I's two fits', phase M's
   (a), (b) and (e) fits' and phase H (a)'s and (b)'s. K5 has five entries, each one forward's 49 calls, bf16 x,
   int8 codes (times and bound their sums, the error the largest of
   them): ``quantized_matmul`` at
   M=8 (a decode step, the GEMVs; Q2's, phase L's, phase S (d)'s, phase
   G (c), (d) and (e)'s, phase P's int8-weights bf16 runs', phase A
   (b), (f) and its chunked run's, phase F (d)'s and phase N (c)'s int8
   launches on those routes),
   ``quantized_matmul_prefill`` at M=1024 (a prefill, the tensor-core
   kernel; Q2's, phase G (c) and (d)'s, phase P's, phase A (b) and
   (f)'s and phase N (c)'s ``tc`` launches),
   ``quantized_matmul_chunk`` at M=128 (a chunk dispatch, the
   tensor-core kernel; phase L's and phase A's chunked ``tc`` launches) and
   ``quantized_matmul_verify`` at M=40 (a spec verify, the tensor-core
   kernel; phase S (d)'s and phase G (e)'s verify launches), and
   ``quantized_matmul_untied_head``, one call of the untied head at M=8
   (phase M (e)'s serving run's head launches, every M).
"""
import contextlib
import dataclasses
import gc
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the spawned workers of phase D import this script to unpickle its
# callback, so the port is imported here, not only inside the phases
from ray_lightning_tpu_torch.core.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.models import GPTModule
from ray_lightning_tpu_torch.reliability import GangSupervisor

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # f32 outside the tensor cores
FLUSH_BYTES = 256 << 20              # > the 50 MB L2: every launch runs cold
SPIN_CYCLES = 1_000_000              # ~0.5 ms of device spin before a call
TIMED_LAUNCHES = 25                  # the script's time limit: was 50
DEVICE = "cuda"

# phase-1 tolerances against the plain version, in f32 units of the output
TOL = {
    # f32 q and pages (int8 codes dequantize to the same f32 values in
    # both): the kernel sums scores and V products in another order
    torch.float32: 1e-5,
    # bf16: both round the softmax weights and the output to bf16 at the
    # same points; a summation-order difference can flip one of those
    # roundings, i.e. one bf16 ulp of an output below 4 (2**-6 = 1.6e-2)
    torch.bfloat16: 2e-2,
}
E2E_LOGITS_TOL = 1e-3   # f32 logits through 12 layers and the tied head


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# ---------------------------------------------------------------- timing
def time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over TIMED_LAUNCHES calls, each on a
    cold L2 (a 256 MB memset runs before it), timed with CUDA events. A
    device spin before each call lets the host enqueue all of ``fn``'s
    launches ahead of the device, so host launch time stays out."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# every tensor-core kernel of the port (K2-K4, and K5 at prefill)
TC_KERNELS = {"flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
              "flash_bwd_dq_tc_kernel", "tc_kernel"}


def hgmma_counts() -> dict:
    """``HGMMA`` (``wgmma``) instructions in each kernel of the built
    libraries, by ``cuobjdump -sass``: ``{kernel: [n for each template
    instantiation]}``."""
    from ray_lightning_tpu_torch import _build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    counts = {}
    for name in _build.SOURCES:
        sass = subprocess.run([tool, "-sass", str(_build._target(name))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        found = None
        for line in sass.splitlines():
            if "Function : " in line:
                kernel = re.search(r"(?<=\d)([a-z][a-z_]*_kernel)",
                                   line).group(1)
                found = counts.setdefault(kernel, [])
                found.append(0)
            elif found is not None and "HGMMA" in line:
                found[-1] += 1
    return counts


# --------------------------------------------------------------- phase 1
def attention_inputs(dtype, quantized, T, gen, B=8, H=12, D=64, ps=16,
                     pp=64):
    """One serving-shaped call of the paged-attention read side: every
    row owns the pages through its last position (other entries −1), rows
    sit at positions spread over 0..1000, and the last row admits no key."""
    from ray_lightning_tpu_torch.models.quant import kv_quantize, kv_scales
    P = B * pp
    q = torch.randn(B, T, H, D, generator=gen).to(dtype)
    kp = torch.randn(P, ps, H, D, generator=gen)
    vp = torch.randn(P, ps, H, D, generator=gen)
    ks = vs = None
    if quantized:
        ks, vs = kv_scales(kp, (1, 3)), kv_scales(vp, (1, 3))
        kp, vp = kv_quantize(kp, ks), kv_quantize(vp, vs)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    start = np.linspace(0, 1000 - (T - 1), B).astype(np.int32)
    pos = torch.from_numpy(start[:, None] + np.arange(T, dtype=np.int32))
    pos[-1] = -1
    pt = torch.full((B, pp), -1, dtype=torch.int32)
    perm = torch.randperm(P, generator=gen).to(torch.int32)
    for b in range(B):
        n = int(pos[b].max()) // ps + 1 if int(pos[b].max()) >= 0 else 0
        pt[b, :n] = perm[b * pp:b * pp + n]
    return [None if x is None else x.to(DEVICE).contiguous()
            for x in (q, kp, vp, ks, vs, pos, pt)]


def attention_bound(q, k_pages, v_pages, k_scales, v_scales, pos, pt):
    """Least time for this call, as ``(ms, "bytes" | "operations")``:
    the K/V pages (and scales) holding admitted keys read once, q,
    positions and page table read once and the output written once, over
    3.35 TB/s; or 4·D operations per (row, head, query, admitted key)
    over the peak rate of q's type -- whichever is larger."""
    B, T, H, D = q.shape
    ps = k_pages.shape[1]
    last = pos.max(dim=1).values
    pages = int(torch.where(last >= 0, last // ps + 1, 0).sum())
    nbytes = 2 * pages * ps * H * D * k_pages.element_size()
    if k_scales is not None:
        nbytes += 2 * pages * H * k_scales.element_size()
    nbytes += 2 * q.numel() * q.element_size() + 4 * (pos.numel()
                                                      + pt.numel())
    keys = int((pos.long() + 1).clamp(min=0).sum())
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = 4 * D * H * keys / PEAK_OPS_PER_S[q.dtype]
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def library_call(q, k_pages, v_pages, k_scales, v_scales, pos, pt):
    """The same function through PyTorch's own attention: pages gathered
    to a dense (B, S) view (int8 dequantized), then
    ``F.scaled_dot_product_attention`` with the block-causal mask. The
    port never calls this; it is the yardstick beside the kernel."""
    B, T, H, D = q.shape
    P = k_pages.shape[0]
    idx = pt.long().clamp(0, P - 1)

    def dense(pages, scales):
        blk = pages[idx]
        if scales is not None:
            blk = (blk.float() * scales[idx]).to(q.dtype)
        return blk.reshape(B, -1, H, D).transpose(1, 2)

    S = pt.shape[1] * k_pages.shape[1]
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            <= pos[:, None, :, None])
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), dense(k_pages, k_scales),
        dense(v_pages, v_scales), attn_mask=mask).transpose(1, 2)


def phase1_kernel_vs_plain(flush):
    from ray_lightning_tpu_torch.models import paged_attention as pa
    gen = torch.Generator().manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for quantized in (False, True):
            for T in (1, 4, S_K + 1):
                args = attention_inputs(dtype, quantized, T, gen)
                out = pa.paged_attention(*args)
                again = pa.paged_attention(*args)
                torch.cuda.synchronize()
                check(torch.equal(out, again),
                      "K1: a second call must give the same bits")
                geometry = pa.launch_geometry(args[0], args[1], args[6])
                ref = pa.paged_attention_reference(*args)
                check(out.shape == ref.shape and out.dtype == ref.dtype,
                      f"kernel output {out.shape} {out.dtype}")
                check(bool(torch.isfinite(out).all()), "non-finite output")
                err = (out.float() - ref.float()).abs().max().item()
                tol = TOL[dtype]
                check(float(out[-1].abs().max()) == 0.0,
                      "the all-masked row must emit 0")
                bound_ms, bound_by = attention_bound(*args)
                row = dict(
                    q=str(dtype).split(".")[-1],
                    pages="int8" if quantized else str(dtype).split(".")[-1],
                    T=T, geometry=geometry, max_abs_err=err, tol=tol,
                    ms=time_ms(lambda: pa.paged_attention(*args), flush),
                    plain_ms=time_ms(
                        lambda: pa.paged_attention_reference(*args), flush),
                    library_ms=time_ms(lambda: library_call(*args), flush),
                    bound_ms=bound_ms, bound_by=bound_by)
                rows.append(row)
                print("phase1 paged_attention", json.dumps(row), flush=True)
                check(err <= tol, f"kernel vs plain {err} > {tol} ({row})")
    return rows


# --------------------------------------------------------------- phase 2
def random_flax_params(cfg, rng):
    """A flax ``TransformerLM`` param tree of numpy arrays in the scanned
    layout (``stack/layers/block`` with a leading layer axis), drawn from
    ``rng``: N(0, 0.02) kernels, embeddings and biases, LayerNorm scales
    near 1."""
    L, d, H, hd, ff = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.head_dim, cfg.d_ff)

    def n(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    def ln(*lead):
        return {"scale": 1.0 + 5.0 * n(*lead, d), "bias": n(*lead, d)}

    block = {
        "ln1": ln(L), "ln2": ln(L),
        "attn": {"qkv": {"kernel": n(L, d, 3, H, hd), "bias": n(L, 3, H, hd)},
                 "out": {"kernel": n(L, H * hd, d), "bias": n(L, d)}},
        "mlp": {"up": {"kernel": n(L, d, ff), "bias": n(L, ff)},
                "down": {"kernel": n(L, ff, d), "bias": n(L, d)}},
    }
    return {"wte": {"embedding": n(cfg.vocab_size, d)},
            "wpe": {"embedding": n(cfg.max_seq_len, d)},
            "stack": {"layers": {"block": block}},
            "ln_f": ln()}


def make_trace(rng, vocab):
    """12 requests: 8 at tick 0, then one every 6 ticks (mid-flight);
    prompts of 16..128 tokens, budgets of 32..64; requests 3 and 9 sample
    (temperature 0.8, top_k 40), the rest are greedy. No eos: every
    request runs its whole budget."""
    trace = []
    for i in range(12):
        kw = dict(prompt=rng.integers(0, vocab, int(rng.integers(16, 129))
                                      ).tolist(),
                  max_new_tokens=int(rng.integers(32, 65)))
        if i in (3, 9):
            kw.update(temperature=0.8, top_k=40)
        trace.append((0 if i < 8 else 6 * (i - 7), kw))
    return trace


SERVE = dict(num_slots=8, prefill_len=128, page_size=16, page_native=True)
# a greedy and a sampled request, served before a measured run: CUDA
# modules load lazily at first use (cuBLAS, the sort and random kernels of
# sampling, the int8 write path), and that one-time cost would otherwise
# land in the first measured TTFT
WARM = [(0, dict(prompt=[1, 2, 3], max_new_tokens=4)),
        (0, dict(prompt=[4, 5], max_new_tokens=4, temperature=0.8,
                 top_k=40))]


def serve(model, sd, trace, observe=None, layout=SERVE, **kw):
    """Replay ``trace`` through a fresh ``ServeClient`` (tick clock) of
    the KV ``layout`` (phase 2's by default), with host wall stamps around
    every engine dispatch; ``observe(engine)`` runs before the first.
    Returns the completions, the engine, and the timings."""
    from ray_lightning_tpu_torch.serve import ServeClient
    client = ServeClient(model, sd, device=DEVICE, **layout, **kw)
    eng = client.engine
    if observe is not None:
        observe(eng)
    stamps = {"submit": {}, "first": {}, "prefill_s": [], "step_s": []}
    submit, prefill, step = client.submit, eng.prefill, eng.step

    def timed_submit(*a, **k):
        rid = submit(*a, **k)
        stamps["submit"][rid] = time.perf_counter()
        return rid

    def timed_prefill(reqs):
        t0 = time.perf_counter()
        out = prefill(reqs)          # ends in a host copy: synchronized
        t1 = time.perf_counter()
        stamps["prefill_s"].append(t1 - t0)
        for r in reqs:
            stamps["first"][r.id] = t1
        return out

    def timed_step():
        t0 = time.perf_counter()
        out = step()                 # ends in a host copy: synchronized
        stamps["step_s"].append(time.perf_counter() - t0)
        return out

    client.submit, eng.prefill, eng.step = (timed_submit, timed_prefill,
                                            timed_step)
    done = client.serve_trace(list(trace))
    client.shutdown()
    return done, eng, stamps


def check_completions(done, trace, vocab, label):
    check(sorted(done) == list(range(len(trace))),
          f"{label}: completions {sorted(done)}")
    for rid, (_, kw) in enumerate(trace):
        c = done[rid]
        check(c.finish_reason == "length"
              and len(c.tokens) == kw["max_new_tokens"],
              f"{label}: request {rid} finished {c.finish_reason} with "
              f"{len(c.tokens)}/{kw['max_new_tokens']} tokens")
        check(all(0 <= t < vocab for t in c.tokens),
              f"{label}: request {rid} emitted a token outside the vocab")


def serving_times(done, stamps):
    """Decode tokens/s (tokens of step dispatches over their host time),
    ms per step and per prefill dispatch, and TTFT (submit to the end of
    the first token's prefill), median and max."""
    decode_tokens = sum(len(c.tokens) - 1 for c in done.values())
    ttft = [stamps["first"][r] - stamps["submit"][r] for r in done]
    return dict(
        decode_tokens=decode_tokens,
        decode_tokens_per_s=decode_tokens / sum(stamps["step_s"]),
        step_ms_median=1e3 * statistics.median(stamps["step_s"]),
        prefill_ms_median=1e3 * statistics.median(stamps["prefill_s"]),
        ttft_ms_median=1e3 * statistics.median(ttft),
        ttft_ms_max=1e3 * max(ttft))


def phase2_main_path(cfg, sd, trace, card):
    from ray_lightning_tpu_torch.models import paged_attention as pa
    from ray_lightning_tpu_torch.models import TransformerLM
    proto = TransformerLM(cfg, device="meta")
    results = {}
    for kv_dtype in (None, "int8"):
        label = f"main path kv_dtype={kv_dtype}"
        serve(proto, sd, WARM, attention_kernel="cuda", kv_dtype=kv_dtype)
        pa.reset_kernel_launches()
        done, eng, st = serve(proto, sd, trace, attention_kernel="cuda",
                              kv_dtype=kv_dtype)
        launches = pa.kernel_launches()
        check_completions(done, trace, cfg.vocab_size, label)
        expect = cfg.n_layers * eng.decode_substeps
        check(eng.decode_substeps > 0 and launches == expect,
              f"{label}: {launches} kernel launches, expected n_layers x "
              f"decode steps = {expect}")
        res = dict(kv_dtype=kv_dtype or "bf16", requests=len(done),
                   decode_steps=eng.decode_substeps,
                   kernel_launches=launches,
                   **serving_times(done, st), card=card)
        print("phase2", json.dumps(res), flush=True)
        results[res["kv_dtype"]] = dict(
            res, tokens={rid: c.tokens for rid, c in done.items()})
    return results


# --------------------------------------------------------------- phase 3
PATHS_ATTENTION = {"cuda": dict(attention_kernel="cuda"),
                   "torch": dict(attention_kernel="torch")}
PATHS_QUANTIZED = {"cuda": dict(attention_kernel="cuda", matmul_kernel="cuda"),
                   "torch": dict(attention_kernel="torch",
                                 matmul_kernel="torch")}


def phase3_kernel_vs_plain_path(cfg, sd, trace, tag="phase3",
                                paths=PATHS_ATTENTION, weight_dtype=None):
    """Serving in f32, the kernel path (``paths["cuda"]``) against the
    plain path (``paths["torch"]``), with weights quantized to
    ``weight_dtype`` when it is set: the first decode step's logits from
    the same arena, then the share of greedy tokens over the trace."""
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.models.generate import (_prefill_impl,
                                                        decode_step_paged)
    from ray_lightning_tpu_torch.models.transformer import PagedKV
    from ray_lightning_tpu_torch.serve.pages import PagePool, scatter_pages
    from ray_lightning_tpu_torch.serve.request import Request
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def model(kw):
        m = TransformerLM(dataclasses.replace(cfg32, **kw),
                          device="meta").to_empty(device=DEVICE)
        m.load_state_dict(sd)
        if weight_dtype is not None:
            m.quantize_weights(weight_dtype)
        return m.requires_grad_(False).eval()

    models = {k: model(kw) for k, kw in paths.items()}
    reqs = [Request(id=i, prompt=kw["prompt"],
                    max_new_tokens=kw["max_new_tokens"])
            for i, (_, kw) in enumerate(trace[:8])]
    pool = PagePool(cfg32, 8, 16, device=DEVICE)
    for r in reqs:
        pool.acquire(r)
    tokens = torch.zeros((8, 128), dtype=torch.long)
    for i, r in enumerate(reqs):
        tokens[i, :r.prompt_len] = torch.tensor(r.prompt)
    lengths = torch.tensor([r.prompt_len for r in reqs])
    pt = torch.from_numpy(pool.page_table).to(DEVICE)
    logits = {}
    with torch.inference_mode():
        cache, last = _prefill_impl(models["cuda"], tokens.to(DEVICE),
                                    lengths.to(DEVICE))
        scatter_pages(pool.arena, cache, pt)
        cur = last.argmax(-1)[:, None]
        pos = lengths.to(DEVICE, torch.int32)[:, None]
        for kernel, m in models.items():
            arena = [PagedKV(kv.k.clone(), kv.v.clone()) for kv in pool.arena]
            logits[kernel] = decode_step_paged(m, arena, cur, pos, pt)
    a, b = logits["cuda"], logits["torch"]
    check(a.shape == (8, cfg.vocab_size) and bool(torch.isfinite(a).all()),
          f"decode logits {tuple(a.shape)} not finite")
    err = (a - b).abs().max().item()
    print(f"{tag} first decode step f32 logits kernel vs plain: max abs "
          f"{err:.3e} (bound {E2E_LOGITS_TOL})", flush=True)
    check(err <= E2E_LOGITS_TOL, f"end-to-end logits differ by {err}")
    del models, pool, cache

    greedy = [(t, dict(kw, temperature=0.0, top_k=None)) for t, kw in trace]
    proto = TransformerLM(cfg32, device="meta")
    runs = {k: serve(proto, sd, greedy, weight_dtype=weight_dtype, **kw)[0]
            for k, kw in paths.items()}
    same = total = 0
    for rid in runs["cuda"]:
        x, y = runs["cuda"][rid].tokens, runs["torch"][rid].tokens
        total += len(x)
        same += sum(int(i == j) for i, j in zip(x, y))
    share = same / total
    print(f"{tag} greedy tokens equal on the kernel and plain paths (f32, "
          f"information only): {same}/{total} = {share:.4f}", flush=True)
    return err, share


# -------------------------------------------------------------- phase Q1
# GPT-2-small's projections as stored (flax-layout) leaves: (label, leaf
# shape, transpose); the tied head contracts the table's last axis
PROJECTIONS = [("qkv", (768, 3, 12, 64), False), ("out", (768, 768), False),
               ("up", (768, 3072), False), ("down", (3072, 768), False),
               ("head", (50257, 768), True)]
QMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def matmul_bound(x, qt, N):
    """Least time of one K5 call, as ``(ms, "bytes" | "operations")``:
    codes, scales and x read once and the output written once over 3.35
    TB/s, or 2·M·K·N operations over the peak rate of x's type."""
    M, K = x.shape
    nbytes = qt.nbytes + (x.numel() + M * N) * x.element_size()
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = 2 * M * K * N / PEAK_OPS_PER_S[x.dtype]
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def phase_q1_matmul_vs_plain(flush):
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    from ray_lightning_tpu_torch.models.quant import (matmul_view,
                                                      quantize_params)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for label, shape, transpose in PROJECTIONS:
        w = torch.randn(shape, generator=gen, device=DEVICE) * 0.02
        for weight_dtype in ("int8", "int4"):
            qt = quantize_params({"w": w}, weight_dtype)["w"]
            _, _, K, N = matmul_view(qt, transpose)
            for dtype in (torch.bfloat16, torch.float32):
                wd = qt.dequantize().to(dtype)
                w2d = wd.reshape(N, K).T if transpose else wd.reshape(K, N)
                # decode, prefill, ragged; bf16 x also a chunk's M and
                # a spec verify's
                Ms = (8, 1024, 7) + ((L_CHUNK, S_VERIFY_M)
                                     if dtype == torch.bfloat16 else ())
                for M in Ms:
                    x = torch.randn(M, K, generator=gen,
                                    device=DEVICE).to(dtype)
                    out = qmm.quantized_matmul(x, qt, transpose)
                    again = qmm.quantized_matmul(x, qt, transpose)
                    torch.cuda.synchronize()
                    check(torch.equal(out, again),
                          "K5: a second call must give the same bits")
                    ref = qmm.quantized_matmul_reference(x, qt, transpose)
                    check(out.shape == ref.shape and out.dtype == ref.dtype,
                          f"K5 output {out.shape} {out.dtype}")
                    check(bool(torch.isfinite(out).all()),
                          "K5 output not finite")
                    err = (out.float() - ref.float()).abs().max().item()
                    tol = QMM_TOL[dtype] * max(
                        1.0, float(ref.float().abs().max()))
                    row = dict(proj=label, weights=weight_dtype,
                               x=str(dtype).split(".")[-1], M=M, K=K, N=N,
                               max_abs_err=err, tol=tol)
                    if M == 8:      # a decode step: the GEMVs' launch
                        row["geometry"] = qmm.launch_geometry(x, qt,
                                                              transpose)
                    if M != 7:      # the ragged case is checked, not timed
                        bound_ms, bound_by = matmul_bound(x, qt, N)
                        row.update(
                            ms=time_ms(lambda: qmm.quantized_matmul(
                                x, qt, transpose), flush),
                            plain_ms=time_ms(
                                lambda: qmm.quantized_matmul_reference(
                                    x, qt, transpose), flush),
                            library_ms=time_ms(
                                lambda: torch.matmul(x, w2d), flush),
                            bound_ms=bound_ms, bound_by=bound_by)
                    rows.append(row)
                    print("phaseQ1 quantized_matmul", json.dumps(row),
                          flush=True)
                    check(err <= tol, f"K5 vs plain {err} > {tol} ({row})")
                del wd, w2d
        del w
    for weight_dtype in ("int8", "int4"):
        for what, M in (("prefill", 1024), ("chunk", L_CHUNK),
                        ("verify", S_VERIFY_M)):
            fwd = forward_sum(rows, weight_dtype, M)
            print(f"phaseQ1 {what} forward", json.dumps(fwd), flush=True)
    return rows


def forward_sum(rows, weight_dtype: str, M: int, n_layers: int = 12):
    """One forward's 49 K5 calls at M rows, bf16 x: n_layers x (qkv, out,
    up, down) and the head, from Q1's rows; times, cuBLAS times and
    bounds summed, the error the largest."""
    calls = {r["proj"]: r for r in rows
             if (r["weights"], r["x"], r["M"]) == (weight_dtype,
                                                    "bfloat16", M)}
    n = {p: (1 if p == "head" else n_layers) for p in calls}
    out = dict(weights=weight_dtype, x="bfloat16", M=M, calls=sum(n.values()),
               max_abs_err=max(r["max_abs_err"] for r in calls.values()),
               **{k: sum(n[p] * calls[p][k] for p in calls)
                  for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
               # what bounds the call with the largest bound
               bound_by=max(calls.values(), key=lambda r: r["bound_ms"])[
                   "bound_by"])
    return out


# -------------------------------------------------------------- phase Q2
Q2_BYTES = {"int8": 0.26, "int4": 0.15}   # of the f32 model's param bytes


def phase_q2_quantized_serving(cfg, sd, trace, card):
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    from ray_lightning_tpu_torch.models.quant import param_bytes
    proto = TransformerLM(cfg, device="meta")
    plain_bytes = param_bytes(sd)
    per_forward = 4 * cfg.n_layers + 1
    results = {}
    for weight_dtype, limit in Q2_BYTES.items():
        label = f"quantized path weight_dtype={weight_dtype}"
        kw = dict(attention_kernel="cuda", matmul_kernel="cuda",
                  weight_dtype=weight_dtype)
        serve(proto, sd, WARM, **kw)
        qmm.reset_kernel_launches()
        done, eng, st = serve(proto, sd, trace, **kw)
        launches, routes = qmm.kernel_launches(), qmm.route_launches()
        check_completions(done, trace, cfg.vocab_size, label)
        expect = per_forward * (eng.decode_substeps + eng.prefills)
        check(eng.decode_substeps > 0 and launches == expect,
              f"{label}: {launches} K5 launches, expected (4 x n_layers + 1)"
              f" x (decode steps + prefills) = {expect}")
        # bf16 compute: prefill (M = 8 x 128) on the tensor cores, decode
        # (M = 8) on the GEMVs -- the layers dense, the tied head attend
        want = {"gemv_dense": 4 * cfg.n_layers * eng.decode_substeps,
                "gemv_attend": eng.decode_substeps,
                "tc": per_forward * eng.prefills, "tiled_f32": 0}
        check(routes == want, f"{label}: K5 routes {routes}, expected {want}")
        share = eng.param_bytes() / plain_bytes
        check(share <= limit, f"{label}: param bytes {eng.param_bytes()} = "
              f"{share:.4f} of the f32 model's, over {limit}")
        res = dict(weight_dtype=weight_dtype, requests=len(done),
                   decode_steps=eng.decode_substeps, prefills=eng.prefills,
                   kernel_launches=launches, route_launches=routes,
                   param_bytes=eng.param_bytes(),
                   f32_param_bytes=plain_bytes, param_bytes_share=share,
                   **serving_times(done, st), card=card)
        print("phaseQ2", json.dumps(res), flush=True)
        results[weight_dtype] = res
    return results


# -------------------------------------------------------------- phase L
L_SYS, L_LONG = 512, 896        # the shared system prompt; a long prompt
L_CHUNK, L_PAGE = 128, 16
L_SERVE = dict(num_slots=8, prefill_len=128, page_size=L_PAGE,
               num_pages=512, prefill_chunk=L_CHUNK, prefix_cache=True,
               page_native=True)
L_KINDS = ("shared",) * 4 + ("long", "long", "short", "short")
# the shared-prefix requests that arrive while others decode, and when
L_LATE = (40, 60, 80, 100)
L_CHUNK_SHAPES = (128, 512, 1024)    # S of K2's timed B=1, T=128 calls


def make_long_trace(rng, vocab):
    """12 requests from ``rng``: 8 share a 512-token system prompt, each
    followed by a suffix of its own of 32..256 tokens; 2 have prompts of
    896 tokens of their own; 2 have short prompts of 16..64 tokens.
    Budgets 32..64. 8 arrive at tick 0 (a shared one first), the other 4
    (shared) while others decode; requests 5 and 9 sample (temperature
    0.8, top_k 40). Returns ``(trace, kinds)``."""
    sys_prompt = rng.integers(0, vocab, L_SYS).tolist()
    order = ["shared", "long", "short", "shared", "long", "short",
             "shared", "shared", "shared", "shared", "shared", "shared"]
    trace = []
    for i, kind in enumerate(order):
        if kind == "shared":
            prompt = sys_prompt + rng.integers(
                0, vocab, int(rng.integers(32, 257))).tolist()
        elif kind == "long":
            prompt = rng.integers(0, vocab, L_LONG).tolist()
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(16, 65))
                                  ).tolist()
        kw = dict(prompt=prompt, max_new_tokens=int(rng.integers(32, 65)))
        if i in (5, 9):
            kw.update(temperature=0.8, top_k=40)
        trace.append((0 if i < 8 else L_LATE[i - 8], kw))
    return trace, order


def serve_chunked(model, sd, trace, **kw):
    """Replay ``trace`` through a fresh chunked ``ServeClient`` (tick
    clock) with wall stamps: each request's submit and first token (the
    end of its final chunk), each chunk dispatch (host ms until it
    returned, ms until the card finished it), each decode step, each
    admission. Returns the completions, the engine and the stamps."""
    from ray_lightning_tpu_torch.serve import ServeClient
    client = ServeClient(model, sd, device=DEVICE, **L_SERVE, **kw)
    eng = client.engine
    st = {"submit": {}, "first": {}, "admitted": {}, "chunk_host_s": [],
          "chunk_s": [], "steps": [], "sequence": [], "published": {}}
    submit, prefill = client.submit, eng.prefill
    chunk, step = eng.prefill_chunk_step, eng.step

    def timed_submit(*a, **k):
        rid = submit(*a, **k)
        st["submit"][rid] = time.perf_counter()
        return rid

    def timed_prefill(reqs):
        for r in reqs:
            st["admitted"][r.id] = len(st["sequence"])
        st["sequence"].append(("prefill", eng.active_count))
        return prefill(reqs)

    def timed_chunk():
        head = eng._chunk_queue[0].request.id
        st["sequence"].append(("chunk", eng.active_count))
        t0 = time.perf_counter()
        out = chunk()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        st["chunk_host_s"].append(t1 - t0)
        st["chunk_s"].append(t2 - t0)
        if head not in eng.chunk_pending_ids:      # its final chunk
            st["first"][head] = t2
            st["published"][head] = len(st["sequence"])
        return out

    def timed_step():
        st["sequence"].append(("step", eng.chunk_pending))
        t0 = time.perf_counter()
        out = step()                 # ends in a host copy: synchronized
        st["steps"].append((t0, time.perf_counter(), eng.chunk_pending))
        return out

    client.submit, eng.prefill = timed_submit, timed_prefill
    eng.prefill_chunk_step, eng.step = timed_chunk, timed_step
    done = client.serve_trace(list(trace))
    return done, client, st


def expected_adoption(kinds, st):
    """Pages each request adopts, worked out from the order of events: a
    shared-prefix request admitted after the first shared request's
    final chunk (its publish) adopts the system prompt's 32 pages (whole
    chunks, one token short of its prompt); every other request none."""
    first = min(r for r, k in enumerate(kinds) if k == "shared")
    out = {}
    for rid, kind in enumerate(kinds):
        late = st["admitted"][rid] >= st["published"][first]
        out[rid] = L_SYS // L_PAGE if kind == "shared" and late else 0
    return out


def long_prompt_times(done, st, kinds):
    """TTFT (submit to the end of the final chunk; median, max) of the
    long and of the shared-prefix requests, ms per chunk dispatch (host
    until it returned; synchronized), the decode stall (gaps between
    consecutive decode dispatches while a prompt streams: p50, max),
    decode tokens/s."""
    def ttft(kind):
        t = [1e3 * (st["first"][r] - st["submit"][r])
             for r in done if kinds[r] == kind]
        return dict(median=statistics.median(t), max=max(t))
    steps = st["steps"]
    gaps = [1e3 * (b[0] - a[1]) for a, b in zip(steps, steps[1:])
            if a[2] or b[2]]
    decode_tokens = sum(len(c.tokens) - 1 for c in done.values())
    return dict(
        ttft_ms_long=ttft("long"), ttft_ms_shared=ttft("shared"),
        chunk_host_ms_median=1e3 * statistics.median(st["chunk_host_s"]),
        chunk_ms_median=1e3 * statistics.median(st["chunk_s"]),
        chunk_ms_max=1e3 * max(st["chunk_s"]),
        decode_stall_ms_p50=statistics.median(gaps) if gaps else None,
        decode_stall_ms_max=max(gaps) if gaps else None,
        decode_stall_gaps=len(gaps),
        decode_tokens_per_s=decode_tokens / sum(b - a for a, b, _ in steps))


def phase_l_long_prompts(cfg, sd, rng, card):
    """Long prompts and shared prefixes through chunked prefill and the
    prefix cache (see the module docstring)."""
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.models import paged_attention as pa
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    trace, kinds = make_long_trace(rng, cfg.vocab_size)
    proto = TransformerLM(cfg, device="meta")
    per_forward = 4 * cfg.n_layers + 1
    warm = [(0, dict(prompt=list(range(200)), max_new_tokens=4)),
            (0, dict(prompt=[4, 5], max_new_tokens=4, temperature=0.8,
                     top_k=40))]
    runs = {"bf16": dict(attention_kernel="cuda"),
            "int8-kv": dict(attention_kernel="cuda", kv_dtype="int8"),
            "int8-weights": dict(attention_kernel="cuda",
                                 weight_dtype="int8", matmul_kernel="cuda")}
    res = {"card": card, "runs": {}}
    for label, kw in runs.items():
        serve_chunked(proto, sd, warm, **kw)[1].shutdown()
        pa.reset_kernel_launches()
        cf.reset_kernel_launches()
        qmm.reset_kernel_launches()
        done, client, st = serve_chunked(proto, sd, trace, **kw)
        eng = client.engine
        k1, k2 = pa.kernel_launches(), cf.route_launches("flash_fwd")
        k5 = qmm.route_launches()
        what = f"L {label}"
        check_completions(done, trace, cfg.vocab_size, what)
        n = eng.chunk_dispatches
        check(eng.prefills == 0 and n > 0,
              f"{what}: {eng.prefills} batched prefills, {n} chunks")
        check(k2 == {"simt": 0, "tc": cfg.n_layers * n},
              f"{what}: K2 routes {k2}, expected {cfg.n_layers} x {n} on tc")
        check(k1 == cfg.n_layers * eng.decode_substeps,
              f"{what}: K1 {k1} launches for {eng.decode_substeps} steps")
        want5 = {"gemv_dense": 0, "gemv_attend": 0, "tc": 0, "tiled_f32": 0}
        if "weight_dtype" in kw:
            want5 = {"gemv_dense": 4 * cfg.n_layers * eng.decode_substeps,
                     "gemv_attend": eng.decode_substeps,
                     "tc": per_forward * n, "tiled_f32": 0}
        check(k5 == want5, f"{what}: K5 routes {k5}, expected {want5}")
        adopted = {r: done[r].prefix_hit_tokens // L_PAGE for r in done}
        want = expected_adoption(kinds, st)
        check(adopted == want, f"{what}: pages adopted {adopted}, counted "
              f"from the trace {want}")
        check(any(want.values()) and eng.prefix.hits == sum(want.values()),
              f"{what}: prefix hits {eng.prefix.hits}")
        seq = st["sequence"]
        back = [i for i in range(1, len(seq))
                if seq[i][0] == seq[i - 1][0] == "chunk" and seq[i][1] > 0]
        check(not back, f"{what}: chunk dispatches back to back while rows "
              f"decode at {back}")
        row = dict(requests=len(done), chunk_dispatches=n,
                   decode_steps=eng.decode_substeps, k1_launches=k1,
                   k2_routes=k2, k5_routes=k5, pages_adopted=adopted,
                   prefix_hit_rate=eng.prefix.hit_rate,
                   pages_saved=eng.prefix.hits,
                   **long_prompt_times(done, st, kinds), card=card)
        print(f"phaseL {label}", json.dumps(row), flush=True)
        res["runs"][label] = row
        client.shutdown()
    res["f32"] = phase_l_f32(cfg, sd, trace, kinds)
    res["trace"] = (trace, kinds)       # phase N (d) serves it again
    return res


def phase_l_f32(cfg, sd, trace, kinds):
    """In f32: the logits after each final chunk of three prompts -- the
    first shared one (publishing), a long one, a shared one adopting the
    system prompt's pages -- through the kernel path against the plain
    path (``attention_kernel`` "cuda" / "torch"), and against an
    unchunked prefill of the same prompt, each to 1e-3; then the share of
    greedy tokens the two paths agree on over the trace (information
    only)."""
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.models.generate import _prefill_impl
    from ray_lightning_tpu_torch.serve import ServeEngine
    from ray_lightning_tpu_torch.serve.request import Request
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    proto = TransformerLM(cfg32, device="meta")
    picks = [kinds.index("shared"), kinds.index("long"),
             len(kinds) - 1]                      # the last: adopts
    reqs = [Request(id=i, prompt=trace[i][1]["prompt"],
                    max_new_tokens=trace[i][1]["max_new_tokens"])
            for i in picks]
    logits, hits = {}, {}
    for kernel in ("cuda", "torch"):
        eng = ServeEngine(proto, sd, device=DEVICE,
                          attention_kernel=kernel, **L_SERVE)
        for r in reqs:
            eng.prefill([Request(**vars(r))])
            while eng.chunk_pending:
                eng.prefill_chunk_step()
            logits[kernel, r.id] = eng.chunk_logits.clone()
        hits[kernel] = eng.prefix.hits
        if kernel == "cuda":
            model = eng.model
        else:
            eng.shutdown()
    check(hits["cuda"] == hits["torch"] == L_SYS // L_PAGE,
          f"L f32: pages adopted {hits}")
    out = {}
    for r in reqs:
        a, b = logits["cuda", r.id], logits["torch", r.id]
        check(a.shape == (1, cfg.vocab_size)
              and bool(torch.isfinite(a).all()), "L f32 logits not finite")
        with torch.inference_mode():
            tokens = torch.tensor([r.prompt], device=DEVICE)
            _, whole = _prefill_impl(model, tokens, None)
        kv = (a - b).abs().max().item()
        vs_whole = (a - whole).abs().max().item()
        out[r.id] = dict(prompt_len=r.prompt_len, kernel_vs_plain=kv,
                         chunked_vs_unchunked=vs_whole)
        print(f"phaseL f32 request {r.id} ({r.prompt_len} tokens) final "
              f"chunk logits: kernel vs plain {kv:.3e}, chunked vs "
              f"unchunked {vs_whole:.3e} (bound {E2E_LOGITS_TOL})",
              flush=True)
        check(kv <= E2E_LOGITS_TOL and vs_whole <= E2E_LOGITS_TOL,
              f"L f32 request {r.id}: {out[r.id]}")
    greedy = [(t, dict(kw, temperature=0.0, top_k=None)) for t, kw in trace]
    runs = {}
    for kernel in ("cuda", "torch"):
        done, client, _ = serve_chunked(proto, sd, greedy,
                                        attention_kernel=kernel)
        client.shutdown()
        runs[kernel] = done
    same = total = 0
    for rid in runs["cuda"]:
        x, y = runs["cuda"][rid].tokens, runs["torch"][rid].tokens
        total += len(x)
        same += sum(int(i == j) for i, j in zip(x, y))
    out["greedy_share"] = same / total
    print(f"phaseL greedy tokens equal on the kernel and plain paths (f32, "
          f"information only): {same}/{total} = {same / total:.4f}",
          flush=True)
    return out


def phase_l_k2_chunk_shapes(flush):
    """K2 as a chunk dispatch calls it (B=1, T=128, H=12, D=64, bf16, q a
    fused-qkv view, causal, end-aligned) at S = 128, 512 and 1024 keys:
    error against the plain version by ``cf.flash_out_bound``, the
    route, cold-L2 time beside its bound, the plain version's and the
    fastest SDPA forward's."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    rows = []
    for S in L_CHUNK_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(S)
        qkv = torch.randn(1, L_CHUNK, 3, 12, 64, generator=g,
                          device=DEVICE).to(torch.bfloat16)
        k, v = (torch.randn(1, S, 12, 64, generator=g, device=DEVICE)
                .to(torch.bfloat16) for _ in range(2))
        q = qkv[:, :, 0]
        cf.reset_kernel_launches()
        out, _ = cf.flash_fwd(q, k, v, True)
        torch.cuda.synchronize()
        check(cf.route_launches() == {"simt": 0, "tc": 1},
              f"L K2 S={S}: routes {cf.route_launches()}")
        ref, _ = cf.flash_fwd_reference(q, k, v, True)
        used = bound_used(out, ref, cf.flash_out_bound(q, k, v, True, ref))
        check(used <= 1.0, f"L K2 S={S}: {used} of the bound")
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        # end-aligned causal: query i admits keys <= i + S - T
        mask = torch.ones(L_CHUNK, S, dtype=torch.bool,
                          device=DEVICE).tril(S - L_CHUNK)

        def fn():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask)
        lib = {}
        for name in SDPA_BACKENDS:
            with sdpa_kernel(getattr(SDPBackend, name)):
                try:
                    fn()
                    torch.cuda.synchronize()
                except RuntimeError:
                    continue
                lib[name] = time_ms(fn, flush)
        bound_ms, bound_by = flash_bound("fwd", q, k, True)
        row = dict(B=1, T=L_CHUNK, S=S, route="tc",
                   max_abs_err=(out.float() - ref.float()).abs().max().item(),
                   bound_used=used,
                   ms=time_ms(lambda: cf.flash_fwd(q, k, v, True), flush),
                   plain_ms=time_ms(lambda: cf.flash_fwd_reference(
                       q, k, v, True), flush),
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=min(lib.values()) if lib else None,
                   library_ms_by_backend=lib)
        print("phaseL flash_fwd chunk shape", json.dumps(row), flush=True)
        rows.append(row)
    return rows


# -------------------------------------------------------------- phase S
S_K = 4                          # draft tokens a round: the verify's T = 5
S_VERIFY_M = SERVE["num_slots"] * (S_K + 1)   # the verify's K5 rows: 40
S_DRAFT_LAYERS = 2
# the identical draft (the target itself, f32): the share of judged
# drafts it must have accepted
S_ACCEPT_IDENTICAL = 0.99


def draft_state(sd, n_layers):
    """The draft's state dict cut from the target's: the token and position
    embeddings, the final LayerNorm and the first ``n_layers`` blocks, by
    name."""
    keep = tuple(f"stack.blocks.{i}." for i in range(n_layers))
    return {k: v for k, v in sd.items()
            if not k.startswith("stack.blocks.") or k.startswith(keep)}


def spec_kw(dcfg, dsd):
    from ray_lightning_tpu_torch.models import TransformerLM
    return dict(draft_model=TransformerLM(dcfg, device="meta"),
                draft_params=dsd, spec_k=S_K)


def record_spec(eng, seen):
    """Wrap a spec engine's draft refills with host timing (synchronized)
    and keep its draft's param bytes; ``seen`` collects both."""
    spec = eng.spec
    seen["draft_param_bytes"] = spec.param_bytes()
    seen["param_bytes"] = eng.param_bytes()
    seen["refill_s"] = []
    refill = spec.refill

    def timed(slot, context):
        t0 = time.perf_counter()
        refill(slot, context)
        torch.cuda.synchronize()
        seen["refill_s"].append(time.perf_counter() - t0)
    spec.refill = timed


def spec_figures(done, eng, st, seen):
    """Phase S's end-to-end figures of one run: the accept rate (accepted
    over judged drafts), committed tokens per spec dispatch, ms per spec
    dispatch (draft refills included) and decode tokens/s, and the
    refills' count and ms."""
    judged = eng.spec_accepted_tokens + eng.spec_rejected_tokens
    t = serving_times(done, st)
    refill_s = seen["refill_s"]
    return dict(
        spec_dispatches=eng.steps, spec_rounds=eng.spec_rounds,
        draft_steps=eng.spec_draft_steps,
        accepted=eng.spec_accepted_tokens,
        rejected=eng.spec_rejected_tokens,
        accept_rate=eng.spec_accepted_tokens / judged if judged else None,
        committed_per_dispatch=t["decode_tokens"] / eng.steps,
        spec_dispatch_ms_median=t["step_ms_median"],
        decode_tokens_per_s=t["decode_tokens_per_s"],
        refills=len(refill_s),
        refill_ms_median=1e3 * statistics.median(refill_s),
        refill_ms_total=1e3 * sum(refill_s),
        ttft_ms_median=t["ttft_ms_median"], decode_tokens=t["decode_tokens"])


def greedy_ids(trace):
    return [rid for rid, (_, kw) in enumerate(trace)
            if not kw.get("temperature")]


def phase_s_speculative(cfg, sd, trace, served, quantized, card):
    """Speculative decoding at GPT-2-small's width: (a) a 2-layer draft
    cut from the target, bf16 then int8 KV, K1 at T = k+1 once per layer
    and round; (b) f32 greedy tokens equal the non-spec engine's; (c) the
    target as its own draft accepts (almost) everything, every round not
    a row's last commits k+1; (d) int8 weights for both models through
    K5, the verify on ``tc``, the draft's feeds on the GEMVs."""
    import ray_lightning_tpu_torch.serve.engine as engine_mod
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.models import paged_attention as pa
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    dcfg = dataclasses.replace(cfg, n_layers=S_DRAFT_LAYERS)
    dsd = draft_state(sd, S_DRAFT_LAYERS)
    proto = TransformerLM(cfg, device="meta")
    greedy = greedy_ids(trace)
    out = {"runs": {}}

    # (a) the realistic draft, bf16 and int8 KV
    for kv_dtype in (None, "int8"):
        label = f"phaseS (a) kv_dtype={kv_dtype}"
        kw = dict(attention_kernel="cuda", kv_dtype=kv_dtype,
                  **spec_kw(dcfg, dsd))
        serve(proto, sd, WARM, **kw)
        seen = {}
        pa.reset_kernel_launches()
        done, eng, st = serve(proto, sd, trace,
                              observe=lambda e: record_spec(e, seen), **kw)
        by_t = pa.launches_by_t()
        check_completions(done, trace, cfg.vocab_size, label)
        expect = {S_K + 1: cfg.n_layers * eng.spec_rounds}
        check(eng.spec_rounds > 0 and by_t == expect,
              f"{label}: K1 launches by T {by_t}, expected n_layers x "
              f"rounds, all at T = k+1: {expect}")
        check(eng.decode_substeps == eng.spec_rounds
              and eng.spec_draft_steps == (S_K + 1) * eng.spec_rounds,
              f"{label}: counters {eng.decode_substeps} "
              f"{eng.spec_draft_steps} against {eng.spec_rounds} rounds")
        key = kv_dtype or "bf16"
        ref = served[key]
        same = sum(done[r].tokens == ref["tokens"][r] for r in greedy)
        res = dict(kv_dtype=key, k=S_K, draft_layers=S_DRAFT_LAYERS,
                   k1_launches=by_t.get(S_K + 1, 0),
                   **spec_figures(done, eng, st, seen),
                   non_spec=dict(
                       (n, ref[n]) for n in (
                           "decode_steps", "decode_tokens_per_s",
                           "step_ms_median", "ttft_ms_median")),
                   greedy_requests_equal_non_spec=f"{same}/{len(greedy)}",
                   card=card)
        print("phaseS", json.dumps(res), flush=True)
        out["runs"][key] = res

    # (b) f32 greedy identity with the non-spec engine; (c) the target
    # as its own draft, f32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    proto32 = TransformerLM(cfg32, device="meta")
    plain, _, _ = serve(proto32, sd, trace, attention_kernel="cuda")
    spec32, eng, _ = serve(proto32, sd, trace, attention_kernel="cuda",
                           **spec_kw(dataclasses.replace(
                               dcfg, dtype=torch.float32), dsd))
    check_completions(spec32, trace, cfg.vocab_size, "phaseS (b)")
    differ = [r for r in greedy if spec32[r].tokens != plain[r].tokens]
    print("phaseS (b) f32 greedy tokens, spec against non-spec: "
          f"{len(greedy) - len(differ)}/{len(greedy)} requests equal "
          f"(accept rate {eng.spec_accepted_tokens}/"
          f"{eng.spec_accepted_tokens + eng.spec_rejected_tokens})",
          flush=True)
    check(not differ, f"phaseS (b): f32 spec tokens differ from non-spec "
          f"for requests {differ}")

    rounds = []
    impl = engine_mod._spec_rounds_page_native_impl

    def recorded(*a, **k):
        res = impl(*a, **k)
        rounds.append((res[5].cpu(), res[8].cpu()))   # emitted, finished
        return res
    engine_mod._spec_rounds_page_native_impl = recorded
    try:
        ident, eng, _ = serve(proto32, sd, trace, attention_kernel="cuda",
                              **spec_kw(cfg32, sd))
    finally:
        engine_mod._spec_rounds_page_native_impl = impl
    check_completions(ident, trace, cfg.vocab_size, "phaseS (c)")
    judged = eng.spec_accepted_tokens + eng.spec_rejected_tokens
    rate = eng.spec_accepted_tokens / judged
    short = 0
    for emitted, finished in rounds:
        n = (emitted >= 0).sum(-1)                     # (rounds, B)
        short += int(((n > 0) & ~finished & (n != S_K + 1)).sum())
    res = dict(accepted=eng.spec_accepted_tokens,
               rejected=eng.spec_rejected_tokens, accept_rate=rate,
               threshold=S_ACCEPT_IDENTICAL, spec_rounds=eng.spec_rounds,
               non_final_rounds_short_of_k_plus_1=short,
               greedy_requests_equal_non_spec=sum(
                   ident[r].tokens == plain[r].tokens for r in greedy),
               card=card)
    print("phaseS (c) identical draft", json.dumps(res), flush=True)
    check(rate >= S_ACCEPT_IDENTICAL,
          f"phaseS (c): accept rate {rate} < {S_ACCEPT_IDENTICAL}")
    check(short == 0, f"phaseS (c): {short} non-final rounds committed "
          "fewer than k+1 tokens")
    out["identical"] = res
    del plain, spec32, ident

    # (d) int8 weights for target and draft through K5
    label = "phaseS (d) int8 weights"
    kw = dict(attention_kernel="cuda", matmul_kernel="cuda",
              weight_dtype="int8", draft_weight_dtype="int8",
              **spec_kw(dcfg, dsd))
    serve(proto, sd, WARM, **kw)
    seen = {}
    qmm.reset_kernel_launches()
    done, eng, st = serve(proto, sd, trace,
                          observe=lambda e: record_spec(e, seen), **kw)
    routes = qmm.route_launches()
    check_completions(done, trace, cfg.vocab_size, label)
    per_forward, draft_forward = 4 * cfg.n_layers + 1, 4 * S_DRAFT_LAYERS + 1
    refills = len(seen["refill_s"])
    # bf16 compute: the verify (M = 8 x 5 = 40), the target's prefills and
    # the draft's refills (M = 1024) on the tensor cores; the draft's
    # feeds (M = 8) on the GEMVs
    want = {"gemv_dense": 4 * S_DRAFT_LAYERS * eng.spec_draft_steps,
            "gemv_attend": eng.spec_draft_steps,
            "tc": per_forward * (eng.spec_rounds + eng.prefills)
            + draft_forward * refills,
            "tiled_f32": 0}
    check(routes == want, f"{label}: K5 routes {routes}, expected {want}")
    target_bytes = quantized["int8"]["param_bytes"]
    check(seen["param_bytes"] == target_bytes + seen["draft_param_bytes"]
          and seen["draft_param_bytes"] > 0,
          f"{label}: param bytes {seen['param_bytes']} != the target's "
          f"{target_bytes} + the draft's {seen['draft_param_bytes']}")
    res = dict(weight_dtype="int8", draft_weight_dtype="int8",
               route_launches=routes,
               verify_tc_launches=per_forward * eng.spec_rounds,
               param_bytes=seen["param_bytes"],
               draft_param_bytes=seen["draft_param_bytes"],
               **spec_figures(done, eng, st, seen),
               non_spec=dict((n, quantized["int8"][n]) for n in (
                   "decode_steps", "decode_tokens_per_s", "step_ms_median",
                   "ttft_ms_median")),
               card=card)
    print("phaseS", json.dumps(res), flush=True)
    out["runs"]["int8-weights"] = res
    return out


# -------------------------------------------------------------- phase G
# the JAX engine's two other KV layouts at phase 2's slots and prefill
G_LAYOUTS = {"dense": dict(num_slots=8, prefill_len=128),
             "view": dict(num_slots=8, prefill_len=128, page_size=16,
                          num_pages=512, page_native=False)}
G_NEW_TOKENS = 64                # generate()'s and the profiles' budget
G_PROFILE_WARM, G_PROFILE_HOST = 3, 5
# device kernel launches of one profiled decode dispatch (profile_decode),
# as phase G first counted them on the H100 (torch 2.11.0+cu128), held
# to within G_LAUNCH_SPREAD of these, here and by the card test
# test_dense_decode_dispatch_launches_match_phase_g: the profiler's
# count of the same code moved by up to 2 between calls (dense int8 1299
# and 1300, view bf16 991 and 993, view int8 1400 and 1401)
G_DECODE_LAUNCHES = {"dense bf16": 892, "dense int8": 1300,
                     "view bf16": 993, "view int8": 1401}
G_LAUNCH_SPREAD = 0.005
# the host's launch and copy calls, beside the device's kernel records
G_HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx",
                       "cudaMemcpyAsync", "cudaMemsetAsync")
# idle host time on both sides of a profiled window: the profiler keeps
# only device records whose span lies inside the window on ITS clock, so
# work launched right at an edge can be dropped (one card recorded 1386
# of a view int8 dispatch's 1401 launches while another recorded all)
PROFILE_PAD_S = 0.02
# profiled windows tried until the device's kernel and copy records match
# the host's launch and copy calls one for one
PROFILE_TRIES = 3


def launches_close(measured: int, key: str) -> bool:
    """``measured`` within G_LAUNCH_SPREAD of G_DECODE_LAUNCHES[key]."""
    want = G_DECODE_LAUNCHES[key]
    return abs(measured - want) <= G_LAUNCH_SPREAD * want


def dispatch_launches(prof) -> int:
    """The launches of a profiled dispatch (:func:`profile_decode`): the
    device's kernel and copy records, or the host's launch and copy calls
    where the profiler kept fewer device records than there were calls
    (it dropped one of a dense view dispatch's in every window of one
    run)."""
    return max(prof["launches"], prof["host_launch_calls"])


def storage_bytes(eng) -> int:
    """Bytes of an engine's KV storage: the slot pool's tensors (codes
    and scales for int8), or the arena's (its sink page included)."""
    if eng.paged:
        tensors = [t for kv in eng.pool.arena
                   for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)
                   if t is not None]
    else:
        tensors = [t for kv in eng.pool.cache for t in vars(kv).values()
                   if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in tensors)


def profiled(work):
    """``torch.profiler``'s ``key_averages()`` of one call of ``work``
    (CPU and CUDA), in a window padded by PROFILE_PAD_S of idle host time
    on both sides and closed after the device has finished; called again,
    up to PROFILE_TRIES windows, while the device's kernel and copy
    records differ in number from the host's launch and copy calls (a
    record the profiler dropped). Returns the last window's events and
    the number of windows taken."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            work()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = prof.key_averages()
        device = sum(a.count for a in events
                     if a.device_type == DeviceType.CUDA)
        host = sum(a.count for a in events if a.key in G_HOST_LAUNCH_CALLS)
        if device == host:
            break
    return events, tries


def profile_decode(proto, sd, trace, layout, **kw):
    """One decode dispatch of an engine of ``layout`` with the trace's
    first 8 prompts admitted (greedy, G_NEW_TOKENS each, so every row
    stays in flight): the median host ms of G_PROFILE_HOST dispatches
    after G_PROFILE_WARM, then one dispatch under ``torch.profiler``
    (:func:`profiled`: a further dispatch while records were dropped):
    its kernel launches (the device's kernel and copy records, and each
    kernel's count) and the host's launch and copy calls, the windows
    taken, device busy ms, the idle share against
    the host median, the six kernels that take the most device time (name,
    ms, launches), and the engine's KV storage bytes."""
    from torch.autograd import DeviceType
    from ray_lightning_tpu_torch.serve import ServeEngine
    from ray_lightning_tpu_torch.serve.request import Request
    eng = ServeEngine(proto, sd, device=DEVICE, **layout, **kw)
    eng.prefill([Request(id=i, prompt=r["prompt"],
                         max_new_tokens=G_NEW_TOKENS)
                 for i, (_, r) in enumerate(trace[:8])])
    for _ in range(G_PROFILE_WARM):
        eng.step()
    host = []
    for _ in range(G_PROFILE_HOST):
        t0 = time.perf_counter()
        eng.step()                   # ends in a host copy: synchronized
        host.append(time.perf_counter() - t0)
    events, tries = profiled(eng.step)
    kernels = [a for a in events if a.device_type == DeviceType.CUDA]
    busy_ms = sum(a.self_device_time_total for a in kernels) / 1e3
    host_ms = 1e3 * statistics.median(host)
    top = sorted(kernels, key=lambda a: -a.self_device_time_total)[:6]
    out = dict(launches=sum(a.count for a in kernels),
               host_launch_calls=sum(a.count for a in events
                                     if a.key in G_HOST_LAUNCH_CALLS),
               profile_tries=tries,
               kernel_counts={a.key: a.count for a in kernels},
               device_busy_ms=busy_ms if kernels else "not measured",
               host_ms_median=host_ms,
               idle_share=1 - busy_ms / host_ms if kernels
               else "not measured",
               storage_bytes=storage_bytes(eng),
               top_kernels=[(a.key[:60], a.self_device_time_total / 1e3,
                             a.count) for a in top])
    eng.shutdown()
    return out


def g_engine_tokens(proto, sd, prompts, layout, **kw):
    """Greedy tokens of an engine of ``layout`` serving ``prompts``
    together, G_NEW_TOKENS each."""
    done, _, _ = serve(proto, sd, [(0, dict(prompt=p,
                                            max_new_tokens=G_NEW_TOKENS))
                                   for p in prompts], layout=layout, **kw)
    return [done[i].tokens for i in range(len(prompts))]


def g_model(cfg, sd, weight_dtype=None, **kw):
    from ray_lightning_tpu_torch.models import TransformerLM
    m = TransformerLM(dataclasses.replace(cfg, **kw),
                      device="meta").to_empty(device=DEVICE)
    m.load_state_dict(sd)
    if weight_dtype is not None:
        m.quantize_weights(weight_dtype)
    return m.requires_grad_(False).eval()


def g_quantized_f32(cfg, sd, trace):
    """(c) in f32 with int8 weights on the dense pool: the first decode
    step's logits of the kernel path (K5) against the plain path from
    the same prefilled pool, then both paths' greedy tokens over the
    trace, request by request."""
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.models.generate import (_prefill_impl,
                                                        decode_step)
    from ray_lightning_tpu_torch.models.transformer import DenseKV
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    models = {k: g_model(cfg32, sd, "int8", matmul_kernel=k)
              for k in ("cuda", "torch")}
    prompts = [kw["prompt"] for _, kw in trace[:8]]
    tokens = torch.zeros((8, 128), dtype=torch.long)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    lengths = torch.tensor([len(p) for p in prompts], device=DEVICE)
    logits = {}
    with torch.inference_mode():
        cache, last = _prefill_impl(models["cuda"], tokens.to(DEVICE),
                                    lengths)
        cur = last.argmax(-1)[:, None]
        for kernel, m in models.items():
            pool = [DenseKV(kv.key.clone(), kv.value.clone()) for kv in cache]
            logits[kernel] = decode_step(m, pool, cur, lengths[:, None])
    a, b = logits["cuda"], logits["torch"]
    check(a.shape == (8, cfg.vocab_size) and bool(torch.isfinite(a).all()),
          f"phaseG (c) decode logits {tuple(a.shape)} not finite")
    err = (a - b).abs().max().item()
    check(err <= E2E_LOGITS_TOL, f"phaseG (c) f32 logits kernel vs plain "
          f"differ by {err}")
    del models, cache
    greedy = [(t, dict(kw, temperature=0.0, top_k=None)) for t, kw in trace]
    proto32 = TransformerLM(cfg32, device="meta")
    runs = {k: serve(proto32, sd, greedy, layout=G_LAYOUTS["dense"],
                     weight_dtype="int8", matmul_kernel=k)[0]
            for k in ("cuda", "torch")}
    differ = [r for r in runs["cuda"]
              if runs["cuda"][r].tokens != runs["torch"][r].tokens]
    check(not differ, f"phaseG (c) f32 greedy tokens of the kernel and "
          f"plain paths differ for requests {differ}")
    return dict(first_step_logits_max_abs=err, bound=E2E_LOGITS_TOL,
                greedy_requests_equal=f"{len(greedy) - len(differ)}/"
                f"{len(greedy)}")


def g_generate(cfg, sd, trace, card):
    """(d) ``generate()`` on the 8 first greedy prompts of the trace
    (ragged, padded to 128), G_NEW_TOKENS each: in f32 equal to
    ``generate_full_scan`` and to the dense, dense-view and page-native
    engines' tokens; in bf16 timed, then with int8 weights through K5."""
    from ray_lightning_tpu_torch.models import (TransformerLM, generate,
                                                generate_full_scan)
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    greedy = [kw for _, kw in trace if not kw.get("temperature")][:8]
    prompts = [kw["prompt"] for kw in greedy]
    batch = np.zeros((8, 128), np.int64)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    lengths = np.array([len(p) for p in prompts])
    n = G_NEW_TOKENS

    def windows(out):
        out = out.cpu().numpy()
        return [out[i, L:L + n].tolist() for i, L in enumerate(lengths)]

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    m32 = g_model(cfg32, sd)
    kw = dict(temperature=0.0, prompt_lengths=lengths)
    split = windows(generate(m32, None, batch, n, 0, **kw))
    full = windows(generate_full_scan(m32, None, batch, n, 0, **kw))
    del m32
    proto32 = TransformerLM(cfg32, device="meta")
    engines = {f"the {name} engine": g_engine_tokens(proto32, sd, prompts,
                                                    layout)
               for name, layout in G_LAYOUTS.items()}
    engines["the page-native engine"] = g_engine_tokens(
        proto32, sd, prompts, SERVE, attention_kernel="cuda")
    for what, other in [("generate_full_scan", full)] + list(
            engines.items()):
        differ = [i for i in range(8) if split[i] != other[i]]
        check(not differ, f"phaseG (d) f32 generate() tokens differ from "
              f"{what}'s for prompts {differ}")
    res = dict(prompts=8, prompt_lengths=lengths.tolist(), new_tokens=n,
               f32_equal="generate == generate_full_scan == the dense, "
               "dense-view and page-native engines, 8/8 prompts")
    for label, weight_dtype in (("bf16", None), ("int8-weights", "int8")):
        m = g_model(cfg, sd, weight_dtype, matmul_kernel="cuda"
                    if weight_dtype else cfg.matmul_kernel)
        generate(m, None, batch, 4, 0, **kw)          # warm
        torch.cuda.synchronize()
        qmm.reset_kernel_launches()
        t0 = time.perf_counter()
        out = generate(m, None, batch, n, 0, **kw)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        toks = windows(out)
        check(all(0 <= t < cfg.vocab_size for w in toks for t in w),
              f"phaseG (d) {label}: a token outside the vocab")
        res[label] = dict(seconds=s, tokens_per_s=8 * n / s,
                          ms_per_token_step=1e3 * s / n)
        if weight_dtype is not None:
            routes = qmm.route_launches()
            want = {"gemv_dense": 4 * cfg.n_layers * (n - 1),
                    "gemv_attend": n - 1, "tc": 4 * cfg.n_layers + 1,
                    "tiled_f32": 0}
            check(routes == want, f"phaseG (d) int8 generate(): K5 routes "
                  f"{routes}, expected {want}")
            res[label]["route_launches"] = routes
        del m
    res["card"] = card
    print("phaseG (d) generate()", json.dumps(res), flush=True)
    return res


def g_spec(cfg, sd, trace, card):
    """(e) phase S's draft on dense target storage, both layouts: f32
    greedy tokens equal the non-spec engine's of the same layout; bf16
    with int8 weights for both models, K5's routes (the verify at M =
    40 on ``tc``)."""
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    dcfg = dataclasses.replace(cfg, n_layers=S_DRAFT_LAYERS)
    dsd = draft_state(sd, S_DRAFT_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    dcfg32 = dataclasses.replace(dcfg, dtype=torch.float32)
    proto, proto32 = (TransformerLM(c, device="meta") for c in (cfg, cfg32))
    greedy = greedy_ids(trace)
    per_forward, draft_forward = 4 * cfg.n_layers + 1, 4 * S_DRAFT_LAYERS + 1
    out = {}
    for name, layout in G_LAYOUTS.items():
        plain, _, _ = serve(proto32, sd, trace, layout=layout)
        spec, eng, _ = serve(proto32, sd, trace, layout=layout,
                             **spec_kw(dcfg32, dsd))
        check_completions(spec, trace, cfg.vocab_size, f"phaseG (e) {name}")
        differ = [r for r in greedy if spec[r].tokens != plain[r].tokens]
        check(not differ, f"phaseG (e) {name}: f32 spec tokens differ from "
              f"non-spec for requests {differ}")
        res = dict(layout=name, f32_greedy_requests_equal_non_spec=(
            f"{len(greedy)}/{len(greedy)}"),
            f32_accepted=eng.spec_accepted_tokens,
            f32_rejected=eng.spec_rejected_tokens)
        kw = dict(matmul_kernel="cuda", weight_dtype="int8",
                  draft_weight_dtype="int8", **spec_kw(dcfg, dsd))
        seen = {}
        qmm.reset_kernel_launches()
        done, eng, st = serve(proto, sd, trace, layout=layout,
                              observe=lambda e: record_spec(e, seen), **kw)
        routes = qmm.route_launches()
        check_completions(done, trace, cfg.vocab_size,
                          f"phaseG (e) {name} int8 weights")
        refills = len(seen["refill_s"])
        want = {"gemv_dense": 4 * S_DRAFT_LAYERS * eng.spec_draft_steps,
                "gemv_attend": eng.spec_draft_steps,
                "tc": per_forward * (eng.spec_rounds + eng.prefills)
                + draft_forward * refills, "tiled_f32": 0}
        check(routes == want, f"phaseG (e) {name} int8 weights: K5 routes "
              f"{routes}, expected {want}")
        res.update(int8_weights=dict(
            route_launches=routes,
            verify_tc_launches=per_forward * eng.spec_rounds,
            **spec_figures(done, eng, st, seen)), card=card)
        print("phaseG (e) spec", json.dumps(res), flush=True)
        out[name] = res
    return out


def phase_g_dense(cfg, sd, trace, served, card):
    """The dense KV layouts and decode outside the engine at GPT-2-small
    width: (a) the dense slot pool (the default layout) and (b) the
    dense-view paged path, bf16 and int8 KV; (c) int8 weights through K5
    on the dense pool; (d) ``generate()``; (e) spec on both layouts. No
    dense layout launches K1 or K2 (the reference's rules)."""
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.models import paged_attention as pa
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    proto = TransformerLM(cfg, device="meta")
    out = {"runs": {}, "profiles": {}}
    pa.reset_kernel_launches()
    cf.reset_kernel_launches()
    out["profiles"]["page-native bf16"] = profile_decode(
        proto, sd, trace, SERVE, attention_kernel="cuda")
    out["profiles"]["page-native bf16"].pop("kernel_counts")
    p1_launches = pa.kernel_launches()
    pa.reset_kernel_launches()
    # (a) and (b)
    for name, layout in G_LAYOUTS.items():
        for kv_dtype in (None, "int8"):
            key = f"{name} {kv_dtype or 'bf16'}"
            serve(proto, sd, WARM, layout=layout, kv_dtype=kv_dtype)
            done, eng, st = serve(proto, sd, trace, layout=layout,
                                  kv_dtype=kv_dtype)
            check_completions(done, trace, cfg.vocab_size, f"phaseG {key}")
            prof = profile_decode(proto, sd, trace, layout,
                                  kv_dtype=kv_dtype)
            counts = prof.pop("kernel_counts")
            n = dispatch_launches(prof)
            if not launches_close(n, key):
                for name, c in sorted(counts.items(), key=lambda x: -x[1]):
                    print(f"phaseG {key} kernel {c} {name[:160]}",
                          file=sys.stderr)
            check(launches_close(n, key),
                  f"phaseG {key}: {n} launches a decode dispatch "
                  f"({prof['launches']} device records, "
                  f"{prof['host_launch_calls']} host launch calls, "
                  f"{prof['profile_tries']} windows), recorded "
                  f"{G_DECODE_LAUNCHES[key]} (+-{G_LAUNCH_SPREAD:.1%})")
            ref = served[kv_dtype or "bf16"]
            res = dict(layout=name, kv_dtype=kv_dtype or "bf16",
                       requests=len(done), decode_steps=eng.decode_substeps,
                       prefills=eng.prefills, **serving_times(done, st),
                       profile=prof,
                       phase2_page_native=dict(
                           (n, ref[n]) for n in ("decode_steps",
                                                 "decode_tokens_per_s",
                                                 "step_ms_median",
                                                 "ttft_ms_median")),
                       card=card)
            print("phaseG", key, json.dumps(res), flush=True)
            out["runs"][key] = res
            out["profiles"][key] = prof
    check(pa.kernel_launches() == 0 and not any(
        cf.kernel_launches().values()),
        f"phaseG: a dense layout launched K1 {pa.kernel_launches()} or K2-K4 "
        f"{cf.kernel_launches()}")
    out["k1_launches_page_native_profile"] = p1_launches
    # (c) int8 weights through K5 on the dense pool, bf16
    qkw = dict(weight_dtype="int8", matmul_kernel="cuda")
    serve(proto, sd, WARM, layout=G_LAYOUTS["dense"], **qkw)
    qmm.reset_kernel_launches()
    done, eng, st = serve(proto, sd, trace, layout=G_LAYOUTS["dense"], **qkw)
    routes = qmm.route_launches()
    check_completions(done, trace, cfg.vocab_size, "phaseG (c)")
    per_forward = 4 * cfg.n_layers + 1
    want = {"gemv_dense": 4 * cfg.n_layers * eng.decode_substeps,
            "gemv_attend": eng.decode_substeps,
            "tc": per_forward * eng.prefills, "tiled_f32": 0}
    check(routes == want, f"phaseG (c): K5 routes {routes}, expected {want}")
    res = dict(weight_dtype="int8", layout="dense", route_launches=routes,
               decode_steps=eng.decode_substeps, prefills=eng.prefills,
               **serving_times(done, st),
               f32=g_quantized_f32(cfg, sd, trace), card=card)
    print("phaseG (c) int8 weights", json.dumps(res), flush=True)
    out["quantized"] = res
    out["generate"] = g_generate(cfg, sd, trace, card)
    out["spec"] = g_spec(cfg, sd, trace, card)
    print("phaseG profiles", json.dumps(dict(out["profiles"], card=card)),
          flush=True)
    return out


# --------------------------------------------------------------- phase P
P_ENGINES = {"page-native": dict(SERVE, attention_kernel="cuda"),
             "int8-weights": dict(SERVE, attention_kernel="cuda",
                                  weight_dtype="int8", matmul_kernel="cuda"),
             "chunked": dict(L_SERVE, attention_kernel="cuda"),
             "spec": dict(SERVE, attention_kernel="cuda")}
P_DTYPES = (torch.bfloat16, torch.float32)
# (c)'s profiled tick, sync and async: the page-native engine's only
# (the script's time limit; every engine's was profiled before)
P_PROFILED = ("page-native",)


def p_models(cfg, sd, dtype, engine):
    """The target's prototype at ``dtype`` and the engine's extra
    arguments (phase S's 2-layer draft for ``"spec"``)."""
    from ray_lightning_tpu_torch.models import TransformerLM
    c = dataclasses.replace(cfg, dtype=dtype)
    kw = {}
    if engine == "spec":
        kw = spec_kw(dataclasses.replace(c, n_layers=S_DRAFT_LAYERS),
                     draft_state(sd, S_DRAFT_LAYERS))
    return TransformerLM(c, device="meta"), kw


def p_serve(proto, sd, trace, layout, *, async_dispatch, debug=False, **kw):
    """Replay ``trace`` through a fresh ``ServeClient`` (tick clock), sync
    or pipelined. Times every step tick on the host (the sync ``step()``
    ends in its event wait; a pipelined tick is the enqueue of N+1 and
    the sync of N) and every drain of the pipeline outside a step tick,
    keeps each synced handle's event wait, and with ``debug`` runs every
    steady-state enqueue (one that chains on an outstanding carry) under
    ``torch.cuda.set_sync_debug_mode("error")``: any synchronizing call
    raises. Returns the completions, the engine and the stats."""
    from ray_lightning_tpu_torch.serve import ServeClient
    client = ServeClient(proto, sd, device=DEVICE,
                         async_dispatch=async_dispatch, **layout, **kw)
    eng = client.engine
    st = {"tick_s": [], "drain_s": [], "wait_s": [], "checked": 0}
    enqueue, sync = eng.step_enqueue, eng.step_sync

    def checked_enqueue():
        if not (debug and eng.carry_deferred):
            return enqueue()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = enqueue()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        st["checked"] += 1
        return out

    def waited_sync(pending):
        out = sync(pending)
        st["wait_s"].append(pending.wait_s)
        return out

    def timed(fn, key):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            st[key].append(time.perf_counter() - t0)
            return out
        return run

    eng.step_enqueue, eng.step_sync = checked_enqueue, waited_sync
    if async_dispatch:
        pipelined, drain = client._step_pipelined, client._sync_pending
        in_tick = []

        def tick_step(done):
            in_tick.append(1)
            try:
                return pipelined(done)
            finally:
                in_tick.pop()

        def timed_drain(done):
            if in_tick or client._pending is None:
                return drain(done)
            return timed(drain, "drain_s")(done)
        client._step_pipelined = timed(tick_step, "tick_s")
        client._sync_pending = timed_drain
    else:
        eng.step = timed(eng.step, "tick_s")
    t0 = time.perf_counter()
    done = client.serve_trace(list(trace))
    st["trace_s"] = time.perf_counter() - t0
    client.shutdown()
    return done, eng, st


def p_figures(done, st):
    """Host ms a step tick (median), the ms a sync waited on its event
    (median), decode tokens over the step ticks' and drains' host time,
    and the replay's wall seconds."""
    decode_tokens = sum(len(c.tokens) - 1 for c in done.values())
    return dict(
        tick_ms_median=1e3 * statistics.median(st["tick_s"]),
        sync_wait_ms_median=1e3 * statistics.median(st["wait_s"]),
        decode_tokens=decode_tokens,
        decode_tokens_per_s=decode_tokens / (sum(st["tick_s"])
                                             + sum(st["drain_s"])),
        drains=len(st["drain_s"]), trace_s=st["trace_s"],
        step_ticks=len(st["tick_s"]))


def p_profile(proto, sd, prompts, layout, *, async_dispatch,
              row_adapters=None, **kw):
    """One decode tick of an engine of ``layout`` with ``prompts``
    admitted (greedy, G_NEW_TOKENS each; ``row_adapters`` the rows'
    adapter names): sync, ``step()``; pipelined, the enqueue of the next
    dispatch and the sync of the last. The median host ms of
    G_PROFILE_HOST ticks after G_PROFILE_WARM, then one tick under
    ``torch.profiler`` (:func:`profiled`): the device's kernel launches,
    busy ms, and the idle share against the host median."""
    from torch.autograd import DeviceType
    from ray_lightning_tpu_torch.serve import ServeEngine
    from ray_lightning_tpu_torch.serve.request import Request
    eng = ServeEngine(proto, sd, device=DEVICE, **layout, **kw)
    eng.prefill([Request(id=i, prompt=p, max_new_tokens=G_NEW_TOKENS,
                         adapter=row_adapters[i] if row_adapters else None)
                 for i, p in enumerate(prompts)])
    while eng.chunk_pending:
        eng.prefill_chunk_step()
    pending = []

    def tick():
        if not async_dispatch:
            eng.step()
            return
        pending.append(eng.step_enqueue())
        if len(pending) > 1:
            eng.step_sync(pending.pop(0))

    for _ in range(G_PROFILE_WARM):
        tick()
    host = []
    for _ in range(G_PROFILE_HOST):
        t0 = time.perf_counter()
        tick()
        host.append(time.perf_counter() - t0)
    events, _ = profiled(tick)
    for p in pending:
        eng.step_sync(p)
    kernels = [a for a in events if a.device_type == DeviceType.CUDA]
    busy_ms = sum(a.self_device_time_total for a in kernels) / 1e3
    host_ms = 1e3 * statistics.median(host)
    eng.shutdown()
    return dict(launches=sum(a.count for a in kernels),
                device_busy_ms=busy_ms if kernels else "not measured",
                host_ms_median=host_ms,
                idle_share=(1 - busy_ms / host_ms if kernels
                            else "not measured"))


def p_launches():
    """Every kernel counter, as one dict."""
    from ray_lightning_tpu_torch.models import paged_attention as pa
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    return dict(k1_by_t=pa.launches_by_t(), k5=qmm.route_launches(),
                k2=cf.route_launches("flash_fwd"))


def p_reset():
    from ray_lightning_tpu_torch.models import paged_attention as pa
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    for mod in (pa, qmm, cf):
        mod.reset_kernel_launches()


def add_launches(total, got):
    """Add one run's counters (``p_launches``) into ``total``."""
    for key, counts in got.items():
        into = total.setdefault(key, {})
        for k, n in counts.items():
            into[k] = into.get(k, 0) + n


def phase_p_async(cfg, sd, trace, card):
    """Async dispatch at GPT-2-small width, phase 2's weights and trace,
    8 slots, on four engines: page-native (K1), int8 weights (K5),
    chunked with the prefix cache (K2) and spec at k = 4 (phase S's
    draft). (a) For each, in bf16 and f32, the pipelined client against
    the sync client: tokens and finish reasons bitwise equal (the same
    kernels on the same inputs). (b) Every steady-state enqueue of the
    bf16 runs, and of a greedy-only spec run, under
    ``set_sync_debug_mode("error")``: no synchronizing call. (c) Per
    engine, sync beside async: host ms a step tick, the ms a sync waits
    on its event, decode tokens/s, and for the page-native engine
    (``P_PROFILED``) one profiled decode tick's launches, device busy ms
    and idle share."""
    out = {"runs": {}, "launches": {}}
    greedy = [(t, {k: v for k, v in kw.items()
                   if k not in ("temperature", "top_k")}) for t, kw in trace]
    prompts = [kw["prompt"] for _, kw in trace[:8]]
    for engine, layout in P_ENGINES.items():
        for dtype in P_DTYPES:
            proto, kw = p_models(cfg, sd, dtype, engine)
            tag = f"{engine} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
            serve(proto, sd, WARM, layout=layout, **kw)
            res, tokens = {}, {}
            for mode in ("sync", "async"):
                p_reset()
                done, eng, st = p_serve(proto, sd, trace, layout,
                                        async_dispatch=mode == "async",
                                        debug=dtype == torch.bfloat16, **kw)
                if dtype == torch.bfloat16:
                    add_launches(out["launches"].setdefault(engine, {}),
                                 p_launches())
                check_completions(done, trace, cfg.vocab_size,
                                  f"phaseP {tag} {mode}")
                tokens[mode] = {r: (c.tokens, c.finish_reason)
                                for r, c in done.items()}
                res[mode] = dict(p_figures(done, st),
                                 dispatches=eng.steps,
                                 enqueues_checked=st["checked"])
            differ = [r for r in tokens["sync"]
                      if tokens["sync"][r] != tokens["async"].get(r)]
            check(not differ, f"phaseP {tag}: async tokens differ from "
                  f"sync for requests {differ}")
            if dtype == torch.bfloat16:
                if engine == "spec":
                    # the spec engine drains while a sampled row is in
                    # flight: the greedy batch checks its steady state
                    done, _, st = p_serve(proto, sd, greedy, layout,
                                          async_dispatch=True, debug=True,
                                          **kw)
                    res["async"]["enqueues_checked_greedy"] = st["checked"]
                    checked = st["checked"]
                else:
                    checked = res["async"]["enqueues_checked"]
                check(checked > 0, f"phaseP {tag}: no steady-state enqueue "
                      "was checked under set_sync_debug_mode")
            if dtype == torch.bfloat16 and engine in P_PROFILED:
                for mode in ("sync", "async"):
                    res[mode]["profile"] = p_profile(
                        proto, sd, prompts, layout,
                        async_dispatch=mode == "async", **kw)
            res["tokens_per_s_async_over_sync"] = (
                res["async"]["decode_tokens_per_s"]
                / res["sync"]["decode_tokens_per_s"])
            print("phaseP", tag, json.dumps(dict(res, card=card)),
                  flush=True)
            out["runs"][tag] = res
    return out


# --------------------------------------------------------------- phase A
A_RANK, A_CAPACITY, A_ADAPTERS = 16, 4, 3
A_SCALE = 0.1                     # std of the adapters' A and B entries
A_NEW_TOKENS = 16
A_SEED = 14                       # the adapters' generator
A_LAYOUT = dict(SERVE, attention_kernel="cuda")
A_TARGETS = (("attn", "qkv"), ("attn", "out"), ("mlp", "up"),
             ("mlp", "down"))


def a_dims(cfg, name):
    d, ff = cfg.d_model, cfg.d_ff
    return {"qkv": (d, 3 * d), "out": (d, d), "up": (d, ff),
            "down": (ff, d)}[name]


def a_adapters(cfg, rng, n):
    """``n`` adapter trees in the JAX package's layout (numpy, rank
    A_RANK, entries N(0, A_SCALE)) for every projection of ``cfg``."""
    out = {}
    for i in range(n):
        tree = {"stack": {}}
        for layer in range(cfg.n_layers):
            blk = tree["stack"].setdefault(f"block_{layer}", {})
            for mod, name in A_TARGETS:
                d_in, d_out = a_dims(cfg, name)
                blk.setdefault(mod, {})[name] = {
                    "lora_A": A_SCALE * rng.standard_normal(
                        (d_in, A_RANK), dtype=np.float32),
                    "lora_B": A_SCALE * rng.standard_normal(
                        (A_RANK, d_out), dtype=np.float32)}
        out[f"ad{i}"] = tree
    return out


def a_merged(sd, tree):
    """The state dict with each targeted projection's weight merged:
    W + scale * (A @ B)^T (scale 1: alpha defaults to the rank)."""
    out = dict(sd)
    for name, blk in tree["stack"].items():
        layer = name.split("_")[1]
        for mod, name2 in A_TARGETS:
            pair = blk[mod][name2]
            key = f"stack.blocks.{layer}.{mod}.{name2}.weight"
            delta = torch.from_numpy(pair["lora_A"] @ pair["lora_B"]).T
            out[key] = (sd[key].double() + delta.double()).float()
    return out


def a_bank_bytes(cfg):
    """One adapter slot's bytes across every bank, from the shapes (f32
    A (in, r) and B (r, out) per projection and layer), times the bank's
    capacity."""
    per = sum(4 * A_RANK * sum(a_dims(cfg, n)) for _, n in A_TARGETS)
    return A_CAPACITY * cfg.n_layers * per


def a_int8_param_bytes(cfg):
    """The int8-weight model's bytes from the shapes (the JAX rule: every
    matrix as int8 codes plus one f32 scale per slice of its last axis;
    biases and LayerNorm f32)."""
    d, ff, V, S = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.max_seq_len
    emb = V * d + 4 * d + S * d + 4 * d
    layer = (d * 3 * d + 4 * cfg.head_dim + 4 * 3 * d       # qkv
             + d * d + 4 * d + 4 * d                        # out
             + d * ff + 4 * ff + 4 * ff                     # up
             + ff * d + 4 * d + 4 * d                       # down
             + 2 * 2 * 4 * d)                               # ln1, ln2
    return emb + cfg.n_layers * layer + 2 * 4 * d


def a_tokens(proto, sd, trace, layout=A_LAYOUT, **kw):
    done, eng, _ = serve(proto, sd, trace, layout=layout, **kw)
    return {r: c.tokens for r, c in done.items()}, done, eng


def phase_a_adapters(cfg, sd, trace, card):
    """Multi-LoRA and tenancy at GPT-2-small width, phase 2's weights: a
    page-native engine with ``max_resident_adapters=4, lora_rank=16`` and
    three random adapters. (a) f32, a mixed batch (rows under each
    adapter and base rows): adapted rows equal a bankless engine with
    merged weights, base rows the bankless base engine, every request
    its solo run, and every adapted stream differs from its base stream.
    (b) bf16 with int8 weights: K5's routes exactly the bankless
    engine's, K1 n_layers a decode step, chunked prompts through K2, the
    param and bank bytes from the shapes; a decode tick's launches and
    device busy ms armed beside bankless. (c) Hot load during a trace,
    LRU eviction, a pinned adapter that refuses to unload, an
    ``UnknownAdapter`` shed. (d) Two tenant classes (weights 3:1, the
    heavier with a default adapter): the first admissions follow the
    weights and every request's tokens equal its solo run. (e) Spec with
    adapters, f32: the non-spec adapted engine's tokens. (f) The async
    client with adapters: the sync client's tokens."""
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.serve import (ServeClient, TenantClass,
                                               UnknownAdapter)
    from ray_lightning_tpu_torch.serve.request import OccupancyError
    rng = np.random.default_rng(A_SEED)
    ads = a_adapters(cfg, rng, A_ADAPTERS)
    names = sorted(ads)
    bank = dict(adapters=ads, max_resident_adapters=A_CAPACITY,
                lora_rank=A_RANK)
    out = {"launches": {}}
    # (a) f32: merged weights, base rows, solo runs
    p32 = TransformerLM(dataclasses.replace(cfg, dtype=torch.float32),
                        device="meta")
    rows = [names[0], names[1], names[2], None, names[0], names[1], None,
            names[2]]
    mixed = [(0, dict(prompt=kw["prompt"], max_new_tokens=A_NEW_TOKENS,
                      adapter=rows[i]))
             for i, (_, kw) in enumerate(trace[:8])]
    got, done, _ = a_tokens(p32, sd, mixed, **bank)
    check(all(done[i].adapter == rows[i] for i in range(8)),
          "phaseA (a): completions carry the wrong adapter")
    base, _, _ = a_tokens(p32, sd, [(t, dict(kw, adapter=None))
                                    for t, kw in mixed])
    merged_equal = differs = 0
    for name in names:
        ids = [i for i in range(8) if rows[i] == name]
        want, _, _ = a_tokens(p32, a_merged(sd, ads[name]),
                              [(0, dict(mixed[i][1], adapter=None))
                               for i in ids])
        for j, i in enumerate(ids):
            check(got[i] == want[j], f"phaseA (a): request {i} under "
                  f"{name} differs from the merged-weight engine")
            check(got[i] != base[i], f"phaseA (a): request {i} under "
                  f"{name} equals the base model's stream")
            merged_equal += 1
            differs += 1
    for i in range(8):
        if rows[i] is None:
            check(got[i] == base[i], f"phaseA (a): base request {i} "
                  "differs from the bankless engine")
        solo, _, _ = a_tokens(p32, sd, [mixed[i]], **bank)
        check(solo[0] == got[i], f"phaseA (a): request {i} differs from "
              "its solo run")
    out["a"] = dict(requests=8, adapted_equal_merged=merged_equal,
                    adapted_differ_from_base=differs,
                    base_rows_equal_bankless=rows.count(None),
                    solo_equal=8, card=card)
    print("phaseA (a) f32", json.dumps(out["a"]), flush=True)
    # (b) bf16, int8 weights
    proto = TransformerLM(cfg, device="meta")
    qkw = dict(weight_dtype="int8", matmul_kernel="cuda")
    atrace = [(t, dict(kw, adapter=([None] + names)[i % 4]))
              for i, (t, kw) in enumerate(trace)]
    serve(proto, sd, WARM, layout=A_LAYOUT, **qkw, **bank)
    res = {}
    per_forward = 4 * cfg.n_layers + 1
    for label, tr, extra in (("bankless", trace, {}),
                             ("armed", atrace, bank)):
        p_reset()
        done, eng, st = serve(proto, sd, tr, layout=A_LAYOUT, **qkw, **extra)
        launches = p_launches()
        add_launches(out["launches"], launches)
        check_completions(done, tr, cfg.vocab_size, f"phaseA (b) {label}")
        want = {"gemv_dense": 4 * cfg.n_layers * eng.decode_substeps,
                "gemv_attend": eng.decode_substeps,
                "tc": per_forward * eng.prefills, "tiled_f32": 0}
        check(launches["k5"] == want,
              f"phaseA (b) {label}: K5 routes {launches['k5']}, expected "
              f"{want}")
        check(launches["k1_by_t"] == {1: cfg.n_layers * eng.decode_substeps},
              f"phaseA (b) {label}: K1 {launches['k1_by_t']}, expected "
              f"{cfg.n_layers} a decode step")
        res[label] = dict(decode_steps=eng.decode_substeps,
                          prefills=eng.prefills, k5=launches["k5"],
                          param_bytes=eng.param_bytes(),
                          adapter_bank_bytes=eng.adapter_bank_bytes(),
                          **serving_times(done, st),
                          tokens={r: c.tokens for r, c in done.items()})
    check(res["armed"]["param_bytes"] == a_int8_param_bytes(cfg)
          + a_bank_bytes(cfg) and res["bankless"]["param_bytes"]
          == a_int8_param_bytes(cfg),
          f"phaseA (b): param bytes {res['armed']['param_bytes']} / "
          f"{res['bankless']['param_bytes']}, from the shapes "
          f"{a_int8_param_bytes(cfg) + a_bank_bytes(cfg)} / "
          f"{a_int8_param_bytes(cfg)}")
    check(res["armed"]["adapter_bank_bytes"] == a_bank_bytes(cfg),
          f"phaseA (b): bank bytes {res['armed']['adapter_bank_bytes']}, "
          f"from the shapes {a_bank_bytes(cfg)}")
    prompts = [kw["prompt"] for _, kw in trace[:8]]
    res["profiles"] = {
        "bankless": p_profile(proto, sd, prompts, A_LAYOUT,
                              async_dispatch=False, **qkw),
        "armed": p_profile(proto, sd, prompts, A_LAYOUT,
                           async_dispatch=False,
                           row_adapters=[([None] + names)[i % 4]
                                     for i in range(8)], **qkw, **bank)}
    # chunked prompts with adapters through K2 (and K5 at M = 128)
    p_reset()
    chunked = dict(L_SERVE, attention_kernel="cuda")
    done, eng, st = serve(proto, sd, atrace, layout=chunked, **qkw, **bank)
    launches = p_launches()
    out["chunk_launches"] = launches
    check_completions(done, atrace, cfg.vocab_size, "phaseA (b) chunked")
    check(eng.prefills == 0 and launches["k2"]
          == {"tc": cfg.n_layers * eng.chunk_dispatches, "simt": 0},
          f"phaseA (b) chunked: K2 {launches['k2']} over "
          f"{eng.chunk_dispatches} chunks")
    check(launches["k5"]["tc"] == per_forward * eng.chunk_dispatches,
          f"phaseA (b) chunked: K5 tc {launches['k5']['tc']}")
    res["chunked"] = dict(chunk_dispatches=eng.chunk_dispatches,
                          k2=launches["k2"], k5=launches["k5"])
    out["b"] = {k: ({n: v for n, v in r.items() if n != "tokens"}
                    if isinstance(r, dict) else r) for k, r in res.items()}
    print("phaseA (b) bf16 int8 weights", json.dumps(dict(out["b"],
                                                          card=card)),
          flush=True)
    # (f) the async client with adapters: the sync client's tokens
    p_reset()
    done, _, _ = serve(proto, sd, atrace, layout=A_LAYOUT, **qkw, **bank,
                       async_dispatch=True)
    add_launches(out["launches"], p_launches())
    check({r: c.tokens for r, c in done.items()} == res["armed"]["tokens"],
          "phaseA (f): async tokens with adapters differ from sync")
    # (c) hot load during a trace, eviction, pinning, an unknown adapter
    extra = a_adapters(cfg, rng, A_ADAPTERS + 2)
    client = ServeClient(proto, sd, device=DEVICE, async_dispatch=True,
                         **A_LAYOUT, **bank)
    rid0 = client.submit(prompt=prompts[0], max_new_tokens=24,
                         adapter=names[0])
    client.submit(prompt=prompts[1], max_new_tokens=24, adapter=names[1])
    for _ in range(4):
        client.tick()
    evicted = [client.load_adapter("ad3", extra["ad3"]),
               client.load_adapter("ad4", extra["ad4"])]
    check(evicted == [None, names[2]], f"phaseA (c): evicted {evicted}, "
          f"expected [None, {names[2]!r}] (the least recently bound)")
    try:
        client.unload_adapter(names[0])
        refused = False
    except OccupancyError:
        refused = True
    check(refused, "phaseA (c): a pinned adapter unloaded")
    try:
        client.submit(prompt=prompts[2], max_new_tokens=8,
                      adapter=names[2])
        shed = None
    except UnknownAdapter as exc:
        shed = exc.resident
    check(shed is not None, "phaseA (c): an evicted adapter was admitted")
    rid4 = client.submit(prompt=prompts[3], max_new_tokens=16,
                         adapter="ad4")
    done = client.run_until_idle()
    residents = client.engine.resident_adapters
    client.shutdown()
    solo, _, _ = a_tokens(proto, sd, [(0, dict(prompt=prompts[3],
                                               max_new_tokens=16,
                                               adapter="ad4"))],
                          adapters={"ad4": extra["ad4"]},
                          max_resident_adapters=A_CAPACITY,
                          lora_rank=A_RANK)
    check(done[rid4].tokens == solo[0] and len(done[rid0].tokens) == 24,
          "phaseA (c): the hot-loaded adapter's tokens differ from a "
          "fresh engine's")
    out["c"] = dict(evicted=evicted, unload_refused=refused,
                    shed_residents=shed, residents=residents, card=card)
    print("phaseA (c)", json.dumps(out["c"]), flush=True)
    # (d) two tenant classes with weights and a class default adapter
    classes = [TenantClass("gold", weight=3.0, tier="batch",
                           adapter=names[0]),
               TenantClass("free", weight=1.0, tier="batch")]
    ttrace = [(0, dict(prompt=trace[i][1]["prompt"], max_new_tokens=8,
                       tenant="gold" if i < 8 else "free"))
              for i in range(12)]
    client = ServeClient(proto, sd, device=DEVICE, tenant_classes=classes,
                         **A_LAYOUT, **bank)
    admitted = []
    prefill = client.engine.prefill

    def record(reqs):
        admitted.extend(r.tenant for r in reqs)
        return prefill(reqs)
    client.engine.prefill = record
    done = client.serve_trace(list(ttrace))
    client.shutdown()
    first = admitted[:SERVE["num_slots"]]
    check(first.count("gold") == 6 and first.count("free") == 2,
          f"phaseA (d): first admissions {first}, expected 6 gold : 2 free")
    for i, (_, kw) in enumerate(ttrace):
        solo, _, _ = a_tokens(proto, sd, [(0, dict(kw))],
                              tenant_classes=classes, **bank)
        check(solo[0] == done[i].tokens, f"phaseA (d): request {i} differs "
              "from its solo run")
        check(done[i].adapter == (names[0] if i < 8 else None),
              f"phaseA (d): request {i} adapter {done[i].adapter}")
    out["d"] = dict(admission_order=admitted, solo_equal=len(ttrace),
                    card=card)
    print("phaseA (d)", json.dumps(out["d"]), flush=True)
    # (e) spec with adapters, f32: the non-spec adapted engine's tokens
    dcfg = dataclasses.replace(cfg, dtype=torch.float32,
                               n_layers=S_DRAFT_LAYERS)
    spec, _, eng = a_tokens(p32, sd, mixed, **bank,
                            **spec_kw(dcfg, draft_state(sd, S_DRAFT_LAYERS)))
    check(spec == got, "phaseA (e): spec tokens with adapters differ from "
          "the non-spec adapted engine's")
    out["e"] = dict(spec_rounds=eng.spec_rounds, requests=len(spec),
                    card=card)
    print("phaseA (e) f32 spec", json.dumps(out["e"]), flush=True)
    return out



# --------------------------------------------------------------- phase F
F_POLICY = dict(max_attempts=3, base_delay=0.0)
# device launches of phase 2's page-native bf16 decode dispatch as phase
# G's profile counts it (runs EE and FE: 749), held within
# G_LAUNCH_SPREAD armed and disarmed
F_PAGE_NATIVE_LAUNCHES = 749
F_SPANS = {"engine.prefill", "engine.chunk", "engine.step",
           "engine.spec_round"}
F_DRIVER_KILL = 50              # (e): the serve.driver tick that kills it
F_JOURNAL_SYNC = 8


def f_models(cfg, dtype):
    from ray_lightning_tpu_torch.models import TransformerLM
    return TransformerLM(dataclasses.replace(cfg, dtype=dtype),
                         device="meta")


def f_sub(a: dict, b: dict) -> dict:
    """Counters ``a - b`` (``p_launches`` dicts)."""
    return {key: {k: n - b.get(key, {}).get(k, 0) for k, n in c.items()}
            for key, c in a.items()}


def f_serve(proto, sd, trace, layout, plan=None, *, record_steps=False,
            **kw):
    """Replay ``trace`` through a fresh supervised ``ServeClient`` (tick
    clock, ``RetryPolicy(**F_POLICY)``) of ``layout`` under ``plan`` (a
    ``FaultPlan``; None = the fault-free run). Records each recovery's
    entries as (id, prompt + emitted tokens) and its host ms, the card's
    allocated bytes right after each rebuilt engine is built, the kernel
    counters at the first rebuild and inside each recovery, and with
    ``record_steps`` the in-flight rows at every dispatch (its index in
    the fault-free numbering, a step or not, the rows' ids and lengths).
    The card's allocated bytes before the client is built and after it
    is shut down and dropped must agree. Returns the completions, the
    supervisor's counters and the record."""
    from ray_lightning_tpu_torch.reliability import RetryPolicy, faults
    from ray_lightning_tpu_torch.serve import ServeClient
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    p_reset()
    client = ServeClient(proto, sd, device=DEVICE,
                         retry_policy=RetryPolicy(**F_POLICY), **layout, **kw)
    sup = client.engine
    rec = {"entries": [], "rebuilt_bytes": [], "recovery_ms": [],
           "in_recovery": [], "fires_in_recovery": [],
           "at_first_rebuild": None, "dispatches": []}
    recover, new_engine = sup._recover, sup._new_engine

    def recording_recover(entries):
        rec["entries"].append([(req.id, req.prompt_len + len(toks))
                               for req, toks in entries])
        at, fires = p_launches(), faults.get_armed()
        fired = fires.counts()["serve.dispatch"] if fires else 0
        t0 = time.perf_counter()
        done = recover(entries)
        rec["recovery_ms"].append(1e3 * (time.perf_counter() - t0))
        rec["in_recovery"].append(f_sub(p_launches(), at))
        rec["fires_in_recovery"].append(
            fires.counts()["serve.dispatch"] - fired if fires else 0)
        return done

    def recording_new_engine():
        new_engine()
        torch.cuda.synchronize()
        rec["rebuilt_bytes"].append(torch.cuda.memory_allocated())
        if rec["at_first_rebuild"] is None:
            rec["at_first_rebuild"] = p_launches()

    sup._recover, sup._new_engine = recording_recover, recording_new_engine
    if record_steps:
        for op in ("prefill", "step", "prefill_chunk_step"):
            def recording(*a, _op=op, _fn=getattr(sup, op)):
                rows = [(r.id, r.prompt_len + len(t))
                        for r, t in sup.engine.snapshot_in_flight()]
                rec["dispatches"].append((_op, rows))
                return _fn(*a)
            setattr(sup, op, recording)
    if plan is None:
        done = client.serve_trace(list(trace))
    else:
        with plan.armed():
            done = client.serve_trace(list(trace))
    rec["launches"] = p_launches()
    counters = dict(rebuilds=sup.rebuilds, recoveries=sup.recoveries,
                    failed_requests=sup.failed_requests,
                    recovery_ms_per_crash=(
                        1e3 * sup.recovery_s_total / sup.recoveries
                        if sup.recoveries else None),
                    fired=plan.fired if plan is not None else 0)
    client.shutdown()
    del client, sup, recover, new_engine
    gc.collect()
    torch.cuda.synchronize()
    rec["bytes_leaked"] = torch.cuda.memory_allocated() - before
    return done, counters, rec


def f_tokens(done):
    return {rid: (c.tokens, c.finish_reason) for rid, c in done.items()}


def f_check_run(tag, done, ref, counters, rec, *, rebuilds,
                recoveries=None, failed=()):
    """The checks every faulted run shares: the plan fired, the counters
    are as planned, every replayed request's tokens equal the fault-free
    run's (``failed``: the ids that retire "failed" with a prefix of
    theirs), memory equal after every rebuild and none left after the
    client."""
    recoveries = rebuilds if recoveries is None else recoveries
    check(counters["fired"] > 0 and counters["rebuilds"] == rebuilds
          and counters["recoveries"] == recoveries
          and counters["failed_requests"] == len(failed),
          f"phaseF {tag}: counters {counters}, expected {rebuilds} "
          f"rebuilds, {recoveries} recoveries, {len(failed)} failed")
    check(sorted(done) == sorted(ref), f"phaseF {tag}: completions "
          f"{sorted(done)} against {sorted(ref)}")
    for rid, (toks, reason) in ref.items():
        got = done[rid]
        if rid in failed:
            check(got.finish_reason == "failed"
                  and got.tokens == toks[:len(got.tokens)],
                  f"phaseF {tag}: request {rid} should retire failed with "
                  f"a prefix of its tokens, got {got.finish_reason} "
                  f"{len(got.tokens)}")
        else:
            check((got.tokens, got.finish_reason) == (toks, reason),
                  f"phaseF {tag}: request {rid} differs from the "
                  "fault-free run")
    check(len(set(rec["rebuilt_bytes"])) == 1,
          f"phaseF {tag}: allocated bytes after each rebuild "
          f"{rec['rebuilt_bytes']} (the card holds a second engine)")


def f_after_rebuild(rec) -> dict:
    """The kernel counters from the first rebuild to the end of the run:
    what the rebuilt engines launched."""
    return f_sub(rec["launches"], rec["at_first_rebuild"])


def f_summary(counters, rec, extra=None) -> dict:
    return dict(counters, rebuilt_bytes=rec["rebuilt_bytes"],
                bytes_left_after_client=rec["bytes_leaked"],
                recovery_ms=[round(t, 3) for t in rec["recovery_ms"]],
                **(extra or {}))


def f_page_native(cfg, sd, trace, served, card, out):
    """(a) phase 2's page-native engine (K1) under three serve.dispatch
    crashes: a prefill, a decode dispatch with at least 4 rows in flight,
    and a dispatch where some rows' prompt + emitted tokens exceed
    ``max_replay_len`` (the ticks chosen from the fault-free run's
    dispatches). f32 checked; bf16 reported against phase 2's tokens."""
    from ray_lightning_tpu_torch.reliability import FaultPlan
    layout = dict(SERVE, attention_kernel="cuda")
    p32 = f_models(cfg, torch.float32)
    base, _, brec = f_serve(p32, sd, trace, layout, record_steps=True)
    ref = f_tokens(base)
    limit = SERVE["prefill_len"]           # max_replay_len, unchunked
    steps = [(i, rows) for i, (op, rows) in enumerate(brec["dispatches"])
             if op == "step"]
    d2 = next(i for i, rows in steps if len(rows) >= 4)
    d3, rows3 = next((i, rows) for i, rows in steps if i > d2 + 3
                     and len(rows) >= 4
                     and any(n > limit for _, n in rows)
                     and any(n <= limit for _, n in rows))
    over = sorted(rid for rid, n in rows3 if n > limit)
    # each recovery before a fault replays its entries in one prefill
    # wave, one extra serve.dispatch tick
    ticks = [0, d2 + 1, d3 + 2]
    plan = FaultPlan.at("serve.dispatch", ticks)
    done, counters, rec = f_serve(p32, sd, trace, layout, plan)
    check(rec["entries"][2] and sorted(rid for rid, n in rec["entries"][2]
                                       if n > limit) == over
          and len(rec["entries"][1]) >= 4,
          f"phaseF (a): recoveries saw {rec['entries']}, expected {over} "
          "over max_replay_len at the third")
    f_check_run("(a) f32", done, ref, counters, rec, rebuilds=3,
                failed=set(over))
    sampled = [rid for rid, (_, kw) in enumerate(trace)
               if kw.get("temperature") and rid not in over]
    k1 = f_after_rebuild(rec)["k1_by_t"].get(1, 0)
    check(k1 > 0, "phaseF (a): no K1 launch after the first rebuild")
    res = {"f32": f_summary(counters, rec, dict(
        ticks=ticks, failed=over, sampled_replay_exact=sampled,
        k1_t1_after_rebuild=k1))}
    add_launches(out["launches"], rec["launches"])
    # bf16: reported (greedy margins on random weights sit below rounding)
    pbf = f_models(cfg, torch.bfloat16)
    done, counters, rec = f_serve(pbf, sd, trace, layout, plan.__class__.at(
        "serve.dispatch", ticks))
    add_launches(out["launches"], rec["launches"])
    phase2 = served["bf16"]["tokens"]
    same = [rid for rid, c in done.items()
            if rid not in over and c.tokens == phase2[rid]]
    res["bf16"] = f_summary(counters, rec, dict(
        equal_to_phase2=f"{len(same)}/{len(done) - len(over)}"))
    print("phaseF (a)", json.dumps(dict(res, card=card)), flush=True)
    out["runs"]["a"] = res
    return ref


def f_chunked(cfg, sd, card, out):
    """(b) phase L's layout (chunks of 128, the prefix cache, K2) on a long
    trace of phase L's kind: a crash mid-chunk, a second during the first
    replay's chunk re-feed (a failed recovery attempt), a third
    mid-decode; every replay streams through chunks, one request a wave.
    A bf16 run with the first two crashes (tokens reported; K2 on
    ``tc``) finds how many serve.dispatch ticks the first recovery adds,
    which places the third crash; the f32 run with all three (K2 on
    ``simt``) is checked."""
    from ray_lightning_tpu_torch.reliability import FaultPlan
    layout = dict(L_SERVE, attention_kernel="cuda")
    trace, _ = make_long_trace(np.random.default_rng(15), cfg.vocab_size)
    p32 = f_models(cfg, torch.float32)
    base, _, brec = f_serve(p32, sd, trace, layout, record_steps=True)
    ref = f_tokens(base)
    ops = brec["dispatches"]
    c1 = next(i for i, (op, _) in enumerate(ops)
              if op == "prefill_chunk_step" and i > 2)
    d3 = next(i for i, (op, rows) in enumerate(ops)
              if op == "step" and i > c1 + 10 and len(rows) >= 4)
    # the first recovery's second serve.dispatch tick is its first
    # replay's first chunk: the second crash
    pbf = f_models(cfg, torch.bfloat16)
    done, counters, rec = f_serve(pbf, sd, trace, layout, FaultPlan.at(
        "serve.dispatch", [c1, c1 + 2]))
    check(counters["fired"] == 2 and counters["recoveries"] == 1
          and counters["rebuilds"] == 2 and len(done) == len(trace),
          f"phaseF (b) bf16: the second crash missed the replay's chunk "
          f"re-feed: {counters}")
    add_launches(out["launches"], rec["launches"])
    out["k2_chunk_tc"] += rec["launches"]["k2"].get("tc", 0)
    res = {"bf16": f_summary(counters, rec, dict(
        k2_tc=rec["launches"]["k2"].get("tc", 0),
        equal_to_f32=sum(f_tokens(done)[r] == ref[r] for r in ref)))}
    # the mid-decode crash: fault-free dispatch d3, shifted by the ticks
    # the first recovery fired beyond the crashed dispatch
    ticks = [c1, c1 + 2, d3 + sum(rec["fires_in_recovery"])]
    done, counters, rec = f_serve(p32, sd, trace, layout,
                                  FaultPlan.at("serve.dispatch", ticks))
    f_check_run("(b) f32", done, ref, counters, rec, rebuilds=3,
                recoveries=2)
    check(len(rec["entries"][1]) >= 4, f"phaseF (b): the mid-decode crash "
          f"replayed {len(rec['entries'][1])} rows")
    k2 = [r["k2"] for r in rec["in_recovery"]]
    check(all(sum(k.values()) > 0 for k in k2),
          f"phaseF (b): a recovery replayed without a chunk (K2 {k2})")
    add_launches(out["launches"], rec["launches"])
    res["f32"] = f_summary(counters, rec, dict(
        ticks=ticks, replayed=[len(e) for e in rec["entries"]],
        k2_in_recovery=k2))
    print("phaseF (b)", json.dumps(dict(res, card=card)), flush=True)
    out["runs"]["b"] = res


def f_spec(cfg, sd, trace, card, out):
    """(c) phase S's spec engine (2-layer draft, k = 4, K1 at T = 5),
    f32, two serve.verify crashes: greedy tokens equal the fault-free
    run's, sampled ones too (replay-exact)."""
    from ray_lightning_tpu_torch.reliability import FaultPlan
    layout = dict(SERVE, attention_kernel="cuda")
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    kw = spec_kw(dataclasses.replace(c32, n_layers=S_DRAFT_LAYERS),
                 draft_state(sd, S_DRAFT_LAYERS))
    p32 = f_models(cfg, torch.float32)
    base, _, _ = f_serve(p32, sd, trace, layout, **kw)
    ref = f_tokens(base)
    # early rounds: every row's prompt + emitted tokens still fit the
    # batched prefill (max_replay_len 128), so nothing retires failed
    plan = FaultPlan.at("serve.verify", [1, 4])
    done, counters, rec = f_serve(p32, sd, trace, layout, plan, **kw)
    f_check_run("(c) f32 spec", done, ref, counters, rec, rebuilds=2)
    k1 = f_after_rebuild(rec)["k1_by_t"].get(S_K + 1, 0)
    check(k1 > 0, "phaseF (c): no K1 launch at T = 5 after a rebuild")
    add_launches(out["launches"], rec["launches"])
    res = f_summary(counters, rec, dict(
        k1_t5_after_rebuild=k1,
        sampled=[r for r, (_, k) in enumerate(trace)
                 if k.get("temperature")]))
    print("phaseF (c)", json.dumps(dict(res, card=card)), flush=True)
    out["runs"]["c"] = res


def f_async_int8(cfg, sd, trace, card, out):
    """(d) int8 weights through K5 on the async client, f32: a crash at an
    enqueue while the previous dispatch's handle is in flight. The older
    handle is discarded (kept until its copy's event completes), never
    synced; tokens equal the fault-free async run's."""
    from ray_lightning_tpu_torch.reliability import FaultPlan
    from ray_lightning_tpu_torch.serve import client as client_mod
    layout = dict(P_ENGINES["int8-weights"], async_dispatch=True)
    p32 = f_models(cfg, torch.float32)
    base, _, _ = f_serve(p32, sd, trace, layout)
    ref = f_tokens(base)
    seen = {"discarded": [], "synced": []}
    discard = client_mod.ServeClient._discard

    def recording_discard(self, handle):
        seen["discarded"].append(handle)
        return discard(self, handle)

    from ray_lightning_tpu_torch.serve.engine import ServeEngine as engine_cls
    sync = engine_cls.step_sync

    def recording_sync(self, pending):
        # the issuing engine's token and the dispatch index, not the
        # handle: a kept handle would keep its device carry allocated,
        # and a freed one's id() is reused by later handles
        seen["synced"].append((pending.owner, pending.dispatch))
        return sync(self, pending)

    client_mod.ServeClient._discard = recording_discard
    engine_cls.step_sync = recording_sync
    try:
        # tick 4: a steady-state enqueue, dispatch 3's handle in flight
        plan = FaultPlan.at("serve.dispatch", [4])
        done, counters, rec = f_serve(p32, sd, trace, layout, plan)
    finally:
        client_mod.ServeClient._discard = discard
        engine_cls.step_sync = sync
    f_check_run("(d) f32 async int8", done, ref, counters, rec, rebuilds=1)
    gone = seen["discarded"]
    check(gone and gone[0].event is not None
          and (gone[0].owner, gone[0].dispatch) not in seen["synced"],
          f"phaseF (d): the in-flight handle was not discarded unsynced "
          f"({len(gone)} discarded)")
    k5 = f_after_rebuild(rec)["k5"]
    check(sum(k5.values()) > 0, "phaseF (d): no K5 launch after the rebuild")
    add_launches(out["launches"], rec["launches"])
    res = f_summary(counters, rec, dict(
        discarded=len(gone), discarded_dispatch=gone[0].dispatch,
        k5_after_rebuild=k5))
    print("phaseF (d)", json.dumps(dict(res, card=card)), flush=True)
    out["runs"]["d"] = res


def f_journal(cfg, sd, trace, ref, card, out, root):
    """(e) phase 2's trace, f32, with a journal (``sync_every=8``) on
    phase 2's engine with ``prefill_chunk=128`` (prompts of up to 128
    tokens still take the batched prefill, so the fault-free tokens are
    (a)'s; a restored request's prompt + frontier, which can exceed
    ``prefill_len``, streams back in through chunks): the serve.driver
    site kills the driver mid-trace; ``ServeClient.restore`` on a fresh
    client finishes it with (a)'s fault-free tokens, and no request
    retired before the kill is served again. Prints the journal's
    bytes, records, fsyncs and ms per fsync."""
    from ray_lightning_tpu_torch.reliability import FaultPlan, InjectedFault
    from ray_lightning_tpu_torch.serve import (Journal, ServeClient,
                                               read_journal)
    layout = dict(SERVE, attention_kernel="cuda", prefill_chunk=L_CHUNK)
    p32 = f_models(cfg, torch.float32)
    path = os.path.join(root, "serve.journal")
    journal = Journal(path, sync_every=F_JOURNAL_SYNC)
    sync, fsync_s = journal.sync, []

    def timed_sync():
        pending = journal._unsynced
        t0 = time.perf_counter()
        sync()
        if pending:
            fsync_s.append(time.perf_counter() - t0)

    journal.sync = timed_sync
    dead = ServeClient(p32, sd, device=DEVICE, journal=journal, **layout)
    plan = FaultPlan.at("serve.driver", [F_DRIVER_KILL])
    killed = False
    with plan.armed():
        try:
            dead.serve_trace(list(trace))
        except InjectedFault:
            killed = True
    check(killed, "phaseF (e): the serve.driver site did not fire")
    early = {rid: (c.tokens, c.finish_reason)
             for rid, c in dead.completions.items()}
    records = journal.records
    # the driver is gone, its engine's device state with it; its journal
    # is dropped unclosed (as JAX's test drops it)
    dead.engine.shutdown()
    del dead, journal, sync, timed_sync
    gc.collect()
    state = read_journal(path)
    pending = {r.id for r, _ in state.pending()}
    t0 = time.perf_counter()
    client = ServeClient.restore(path, p32, sd, device=DEVICE, **layout)
    restore_s = time.perf_counter() - t0
    done = client.run_until_idle()
    client.shutdown()
    check(set(done) == pending and not pending & set(early),
          f"phaseF (e): restored {sorted(done)}, pending {sorted(pending)}")
    for rid in pending:
        check(f_tokens({rid: done[rid]})[rid] == ref[rid],
              f"phaseF (e): request {rid} differs after the restore")
    for rid, toks in early.items():
        check(toks == ref[rid], f"phaseF (e): request {rid} differs")
    check(set(done) | set(early) == set(ref),
          "phaseF (e): a request was lost across the restart")
    res = dict(journal_bytes=os.path.getsize(path),
               records_before_kill=records,
               records_total=read_journal(path).records,
               fsyncs=len(fsync_s),
               fsync_ms_median=1e3 * statistics.median(fsync_s),
               fsync_ms_max=1e3 * max(fsync_s),
               bytes_per_request=os.path.getsize(path) / len(ref),
               retired_before_kill=len(early), replayed=len(pending),
               torn_tail=state.torn_tail, restore_ms=1e3 * restore_s,
               card=card)
    print("phaseF (e)", json.dumps(res), flush=True)
    out["runs"]["e"] = res


def f_telemetry(cfg, sd, trace, card, out, root):
    """(f) phase 2's bf16 page-native trace with
    ``Telemetry(clock=time.perf_counter, jsonl_path=...)`` armed beside
    the same trace disarmed: tokens equal; a profiled decode dispatch's
    launches equal armed and disarmed (phase G's count); the armed async
    client's steady-state enqueues under
    ``set_sync_debug_mode("error")``; the Chrome trace parses with the
    JAX span names; host ms a tick, events by name."""
    from ray_lightning_tpu_torch.obs import Telemetry
    from ray_lightning_tpu_torch.serve import ServeClient
    layout = dict(SERVE, attention_kernel="cuda")
    proto = f_models(cfg, torch.bfloat16)
    res, tokens = {}, {}
    p_reset()
    for armed in (False, True):
        tel = (Telemetry(clock=time.perf_counter,
                         jsonl_path=os.path.join(root, "f.jsonl"))
               if armed else None)
        client = ServeClient(proto, sd, device=DEVICE, telemetry=tel,
                             **layout)
        tick, tick_s = client.tick, []

        def timed_tick(_tick=tick, _s=tick_s):
            t0 = time.perf_counter()
            got = _tick()
            _s.append(time.perf_counter() - t0)
            return got

        client.tick = timed_tick
        done = client.serve_trace(list(trace))
        client.shutdown()
        tokens[armed] = f_tokens(done)
        key = "armed" if armed else "disarmed"
        res[key] = dict(tick_ms_median=1e3 * statistics.median(tick_s),
                        tick_ms_mean=1e3 * statistics.mean(tick_s),
                        ticks=len(tick_s))
        if armed:
            tel.flush()
            sites = [json.loads(line)["site"]
                     for line in open(os.path.join(root, "f.jsonl"))]
            counts = {s: sites.count(s) for s in sorted(set(sites))}
            doc = json.load(open(tel.spans.export_chrome_trace(
                os.path.join(root, "f_trace.json"))))
            names = {e["name"] for e in doc["traceEvents"]}
            check(names and names <= F_SPANS
                  and {"engine.prefill", "engine.step"} <= names,
                  f"phaseF (f): span names {sorted(names)}")
            check(counts.get("serve.retire") == len(trace),
                  f"phaseF (f): events {counts}")
            res["armed"].update(events=counts, spans=len(doc["traceEvents"]),
                                span_names=sorted(names),
                                jsonl_bytes=os.path.getsize(
                                    os.path.join(root, "f.jsonl")))
    check(tokens[True] == tokens[False],
          "phaseF (f): armed tokens differ from disarmed")
    res["armed_over_disarmed_tick_ms"] = (res["armed"]["tick_ms_median"]
                                          / res["disarmed"]["tick_ms_median"])
    profiles = {}
    for armed in (False, True):
        tel = Telemetry(clock=time.perf_counter) if armed else None
        prof = profile_decode(proto, sd, trace, SERVE,
                              attention_kernel="cuda", telemetry=tel)
        profiles[armed] = dispatch_launches(prof)
        res["armed" if armed else "disarmed"]["profile"] = dict(
            launches=prof["launches"],
            host_launch_calls=prof["host_launch_calls"],
            device_busy_ms=prof["device_busy_ms"],
            host_ms_median=prof["host_ms_median"],
            idle_share=prof["idle_share"])
    spread = G_LAUNCH_SPREAD * F_PAGE_NATIVE_LAUNCHES
    check(all(abs(n - F_PAGE_NATIVE_LAUNCHES) <= spread
              for n in profiles.values())
          and abs(profiles[True] - profiles[False]) <= spread,
          f"phaseF (f): decode dispatch launches armed "
          f"{profiles[True]}, disarmed {profiles[False]}, expected "
          f"{F_PAGE_NATIVE_LAUNCHES}")
    done, _, st = p_serve(proto, sd, trace, layout, async_dispatch=True,
                          debug=True, telemetry=Telemetry(
                              clock=time.perf_counter))
    check(st["checked"] > 0 and f_tokens(done) == tokens[False],
          f"phaseF (f): {st['checked']} armed enqueues checked under "
          "set_sync_debug_mode, or async tokens differ")
    res["async_enqueues_checked"] = st["checked"]
    add_launches(out["launches"], p_launches())
    print("phaseF (f)", json.dumps(dict(res, card=card)), flush=True)
    out["runs"]["f"] = res


def phase_f_faults(cfg, sd, trace, served, card):
    """Faults and telemetry at GPT-2-small width (the module docstring):
    (a)-(d) crash replay through the page-native, chunked, spec and async
    int8-weights engines, (e) a journal across a driver kill, (f)
    telemetry armed against disarmed, (g) memory across rebuilds (every
    faulted run's own check) and recovery ms per crash."""
    import tempfile
    out = {"runs": {}, "launches": {}, "k2_chunk_tc": 0}
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phaseF-")
    try:
        ref = f_page_native(cfg, sd, trace, served, card, out)
        f_chunked(cfg, sd, card, out)
        f_spec(cfg, sd, trace, card, out)
        f_async_int8(cfg, sd, trace, card, out)
        f_journal(cfg, sd, trace, ref, card, out, root)
        f_telemetry(cfg, sd, trace, card, out, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    runs = out["runs"]
    g = {tag: runs[tag]["f32"]["recovery_ms_per_crash"] if "f32" in runs[
        tag] else runs[tag]["recovery_ms_per_crash"] for tag in "abcd"}
    print("phaseF (g)", json.dumps(dict(
        recovery_ms_per_crash=g, rebuilt_bytes={
            tag: (runs[tag]["f32"] if "f32" in runs[tag] else runs[tag]
                  )["rebuilt_bytes"] for tag in "abcd"},
        launches=out["launches"], seconds=time.perf_counter() - t0,
        card=card)), flush=True)
    return out


# -------------------------------------------------------------- phase T1
FLASH_CASES = [  # (label, B, T, S, causal); H=12, D=64 throughout
    ("path", 8, 1024, 1024, True),
    ("ragged", 8, 1000, 1000, True),
    ("end-aligned", 8, 512, 1024, True),
    ("non-causal", 8, 1024, 1024, False),
    ("empty-rows", 8, 64, 32, True),
]


def flash_tol(dtype, name: str, ref: torch.Tensor, grad: bool, q, k, v,
              causal: bool, grad_bounds=None):
    """Bound on |kernel - plain| of one flash output, in f32 units: a
    number, or a tensor of ref's shape bounding each element
    (``grad_bounds``: bf16 dq, dk, dv's, from ``cf.flash_grad_bound``).

    f32: only the order of the f32 sums differs (64-key tiles, an online
    softmax whose running maximum rescales earlier tiles) -- 1e-5 for out
    and lse; 1e-4 of the largest magnitude for a gradient, a sum over up
    to 1024 rows in another order. lse is f32 sums of exact products in
    both dtypes: 1e-5 (rows that admit no key are 1e30 in both, exactly).
    bf16 out, element by element: ``cf.flash_out_bound``, 2**-7 (1 +
    2**-6) (|plain| + A), A the p-weighted mean of |v| over the row -- the
    two round p against different maxima and out once each. On an
    H100 80GB HBM3 at 700 W the kernel used at most 0.367 of it (path
    and ragged; 0.22-0.24 in the other cases); the former bound, 2e-2 of
    max(1, largest magnitude), was 0.08 on the path, as large as a
    typical |out| of a long row.
    bf16 gradients (K3, K4), element by element: ``cf.flash_grad_bound``,
    2**-7 (1 + 2**-6) (|plain| + A), A the sum of the rounded factor's
    magnitudes times the other's (p |dO| for dv, scale |ds| |q| for dk,
    scale |ds| |k| for dq, |ds| with a term for dp - delta's f32
    cancellation) -- the two may flip a bf16 rounding of p or ds and of
    the output. Predicted before its first run: the kernels use at most
    half of it. The former bound, 2e-2 of max(1, largest magnitude), was
    ~0.08 on the path, where a long key row's dv is ~0.05."""
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    if name == "lse":
        return 1e-5
    top = float(ref.float().abs().max())
    if dtype == torch.float32:
        return 1e-4 * max(top, 1e-30) if grad else 1e-5
    if name == "out":
        return cf.flash_out_bound(q, k, v, causal, ref)
    return grad_bounds[name]


def bound_used(got: torch.Tensor, ref: torch.Tensor, tol) -> float:
    """The largest share of ``tol`` (a number or an element-wise tensor)
    that |got - ref| takes: at most 1 passes."""
    d = (got.float() - ref.float()).abs()
    return float(torch.where(d > 0, d / tol, 0.0).max())


def flash_inputs(dtype, B, T, S, H=12, D=64, seed=0):
    """q, k, v as views of fused projections (the model's layout) and dO,
    N(0, 1), made on the card from ``seed``."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    qkv = torch.randn(B, T, 3, H, D, generator=g, device=DEVICE).to(dtype)
    kv = torch.randn(B, S, 2, H, D, generator=g, device=DEVICE).to(dtype)
    do = torch.randn(B, T, H, D, generator=g, device=DEVICE).to(dtype)
    return qkv[:, :, 0], kv[:, :, 0], kv[:, :, 1], do


def admitted_pairs(T: int, S: int, causal: bool) -> int:
    """(query, key) pairs the mask admits: the work these inputs need."""
    if not causal:
        return T * S
    keys = np.clip(np.arange(T) + (S - T) + 1, 0, S)
    return int(keys.sum())


def flash_bound(kind: str, q, k, causal: bool):
    """Least time of one flash kernel call, as ``(ms, "bytes" |
    "operations")``. Operations, per admitted (query, key) pair and head
    dimension: 4 for the forward (Q.K^T, P.V), 8 for dK/dV (Q.K^T, dO.V^T,
    P^T.dO, dS^T.Q), 6 for dQ (Q.K^T, dO.V^T, dS.K), over the peak rate of
    q's type. Bytes: every input read once and every output written once
    (forward: q, k, v -> out, lse; dK/dV: q, k, v, dO, lse, delta -> dk,
    dv; dQ: q, k, v, dO, lse, delta -> dq) over 3.35 TB/s."""
    B, T, H, D = q.shape
    S = k.shape[1]
    e = q.element_size()
    nq, nk, rows = B * T * H * D * e, B * S * H * D * e, B * H * T * 4
    ops_per, nbytes = {
        "fwd": (4, 2 * nq + 2 * nk + rows),
        "dkv": (8, 2 * nq + 4 * nk + 2 * rows),
        "dq": (6, 3 * nq + 2 * nk + 2 * rows),
    }[kind]
    ops = ops_per * B * H * D * admitted_pairs(T, S, causal)
    by_ops = ops / PEAK_OPS_PER_S[q.dtype]
    by_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(by_ops, by_bytes),
            "bytes" if by_bytes >= by_ops else "operations")


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_times(q, k, v, do, causal, flush):
    """``F.scaled_dot_product_attention`` on (B, H, T, D) views of the same
    inputs, once under each backend of ``SDPA_BACKENDS`` that
    ``torch.nn.attention.sdpa_kernel`` lets run them: its forward, and its
    backward (forward + backward minus forward). Returns ``{backend:
    (fwd_ms, bwd_ms)}``; a backend that refuses these inputs is left out
    and named. The port never calls it; it is the yardstick."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
    doh = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)

    def fwd_bwd():
        for x in leaves:
            x.grad = None
        F.scaled_dot_product_attention(*leaves, is_causal=causal) \
            .backward(doh)

    times = {}
    for name in SDPA_BACKENDS:
        with sdpa_kernel(getattr(SDPBackend, name)):
            try:            # does this backend take these inputs?
                fwd_bwd()
                torch.cuda.synchronize()
            except RuntimeError as err:
                print(f"phaseT1 sdpa {name} does not run these inputs: "
                      f"{str(err).splitlines()[0]}", flush=True)
                continue
            fwd_ms = time_ms(fwd, flush)
            times[name] = (fwd_ms, time_ms(fwd_bwd, flush) - fwd_ms)
        print(f"phaseT1 sdpa {name}: forward {times[name][0]:.4f} ms, "
              f"backward {times[name][1]:.4f} ms", flush=True)
    check(bool(times), "no SDPA backend runs the path's inputs")
    return times


def phase_t1_flash_vs_plain(flush):
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    rows = {}
    for label, B, T, S, causal in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = flash_inputs(dtype, B, T, S)
            cf.reset_kernel_launches()
            out, lse = cf.flash_fwd(q, k, v, causal)
            delta = cf.flash_delta(out, do)
            dk, dv = cf.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
            dq = cf.flash_bwd_dq(q, k, v, do, lse, delta, causal)
            torch.cuda.synchronize()
            # views of fused projections: bf16 on the tensor cores, f32
            # on the CUDA cores, every kernel
            route = "tc" if dtype == torch.bfloat16 else "simt"
            routes = {n: cf.route_launches(n) for n in cf.KERNELS}
            check(all(r == {"simt": 0, "tc": 0, route: 1}
                      for r in routes.values()),
                  f"flash {label} {dtype}: routes {routes}, want {route}")
            # the same inputs for both: the kernels' lse and delta
            ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, causal)
            ref_dk, ref_dv = cf.flash_bwd_dkv_reference(q, k, v, do, lse,
                                                        delta, causal)
            ref_dq = cf.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                               causal)
            grad_bounds = None
            if dtype == torch.bfloat16:
                grad_bounds = dict(zip(("dq", "dk", "dv"),
                                       cf.flash_grad_bound(
                                           q, k, v, do, lse, delta, causal,
                                           ref_dq, ref_dk, ref_dv)))
            row = dict(case=label, dtype=str(dtype).split(".")[-1], B=B,
                       T=T, S=S, causal=causal, route=route)
            for name, got, ref, grad in (("out", out, ref_out, False),
                                         ("lse", lse, ref_lse, False),
                                         ("dq", dq, ref_dq, True),
                                         ("dk", dk, ref_dk, True),
                                         ("dv", dv, ref_dv, True)):
                check(got.shape == ref.shape and got.dtype == ref.dtype,
                      f"flash {label} {name}: {got.shape} {got.dtype}")
                check(bool(torch.isfinite(got).all()),
                      f"flash {label} {dtype} {name} not finite")
                err = (got.float() - ref.float()).abs().max().item()
                tol = flash_tol(dtype, name, ref, grad, q, k, v, causal,
                                grad_bounds)
                used = bound_used(got, ref, tol)
                row[f"{name}_err"], row[f"{name}_used"] = err, used
                row[f"{name}_tol"] = (None if torch.is_tensor(tol)
                                      else tol)          # None: per element
                check(used <= 1.0, f"flash {label} {dtype} {name}: kernel "
                      f"vs plain {err}, {used} of the bound")
            if causal and T > S:
                check(float(out[:, :T - S].abs().max()) == 0.0
                      and bool((lse[:, :, :T - S] == 1e30).all())
                      and float(dq[:, :T - S].abs().max()) == 0.0,
                      "rows that admit no key must give out 0, lse 1e30, "
                      "dq 0")
            del grad_bounds
            if label == "path":
                lib = sdpa_times(q, k, v, do, causal, flush)
                fwd_backend = min(lib, key=lambda n: lib[n][0])
                bwd_backend = min(lib, key=lambda n: lib[n][1])
                for kind, fn, plain in (
                        ("fwd", lambda: cf.flash_fwd(q, k, v, causal),
                         lambda: cf.flash_fwd_reference(q, k, v, causal)),
                        ("dkv", lambda: cf.flash_bwd_dkv(
                            q, k, v, do, lse, delta, causal),
                         lambda: cf.flash_bwd_dkv_reference(
                             q, k, v, do, lse, delta, causal)),
                        ("dq", lambda: cf.flash_bwd_dq(
                            q, k, v, do, lse, delta, causal),
                         lambda: cf.flash_bwd_dq_reference(
                             q, k, v, do, lse, delta, causal))):
                    bound_ms, bound_by = flash_bound(kind, q, k, causal)
                    row[f"{kind}_ms"] = time_ms(fn, flush)
                    row[f"{kind}_plain_ms"] = time_ms(plain, flush)
                    row[f"{kind}_bound_ms"] = bound_ms
                    row[f"{kind}_bound_by"] = bound_by
                row["library_ms_by_backend"] = {
                    n: dict(fwd=f, bwd=b) for n, (f, b) in lib.items()}
                row["library_fwd_ms"] = lib[fwd_backend][0]
                row["library_fwd_backend"] = fwd_backend
                row["library_bwd_ms"] = lib[bwd_backend][1]
                row["library_bwd_backend"] = bwd_backend
            rows[(label, row["dtype"])] = row
            print("phaseT1 flash", json.dumps(row), flush=True)
            del q, k, v, do, out, lse, delta, dk, dv, dq
            del ref_out, ref_lse, ref_dk, ref_dv, ref_dq
    return rows


# -------------------------------------------------------------- phase T2
TRAIN_STEPS, VAL_BATCHES, WARMUP_STEPS = 20, 2, 3


def phase_t2_training(card, flash_path):
    """The training main path; returns its measurements and launches."""
    from ray_lightning_tpu_torch import GPTModule, RayStrategy, Trainer
    from ray_lightning_tpu_torch.core import LambdaCallback
    from ray_lightning_tpu_torch.models import gpt2_config
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    cfg = gpt2_config("small", attention_impl="flash")
    module = GPTModule(config=cfg, batch_size=8, seq_len=1024)
    ends, losses = [], []

    def on_batch_end(trainer, pl_module, outputs, batch, batch_idx):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        losses.append(float(outputs["loss"]))

    trainer = Trainer(strategy=RayStrategy(num_workers=1), max_epochs=1,
                      limit_train_batches=TRAIN_STEPS,
                      limit_val_batches=VAL_BATCHES, seed=0,
                      callbacks=[LambdaCallback(
                          on_train_batch_end=on_batch_end)])
    torch.cuda.reset_peak_memory_stats()
    cf.reset_kernel_launches()
    t0 = time.perf_counter()
    trainer.fit(module)
    fit_s = time.perf_counter() - t0
    launches = cf.kernel_launches()
    routes = {name: cf.route_launches(name) for name in cf.KERNELS}
    n = cfg.n_layers
    check(trainer.global_step == TRAIN_STEPS,
          f"global_step {trainer.global_step} != {TRAIN_STEPS}")
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"losses {losses}")
    check(np.isfinite(trainer.callback_metrics["val_loss"]),
          f"val_loss {trainer.callback_metrics}")
    last5 = float(np.mean(losses[-5:]))
    check(last5 < losses[0],
          f"loss did not fall: first {losses[0]}, last-5 mean {last5}")
    expect = {"flash_fwd": n * (TRAIN_STEPS + VAL_BATCHES),
              "flash_bwd_dkv": n * TRAIN_STEPS,
              "flash_bwd_dq": n * TRAIN_STEPS}
    check(launches == expect, f"flash launches {launches} != {expect}")
    # bf16 views of the fused qkv projection and autograd's dO: every
    # forward and backward launch on the tensor cores
    want = {name: {"simt": 0, "tc": expect[name]} for name in cf.KERNELS}
    check(routes == want, f"flash routes {routes} != {want}")
    steps_s = np.diff(ends)[WARMUP_STEPS - 1:]      # steps 4..20
    step_ms = 1e3 * float(np.median(steps_s))
    tokens = module.batch_size * module.seq_len
    n_params = sum(p.numel() for p in trainer.model.parameters())
    # model flops per step (PaLM's count): 6·N·tokens for the weights'
    # products forward and backward (N every parameter, the tied LM head
    # included) + 12·L·T·d·tokens for attention's two products, counted
    # without the causal half
    flops = (6 * n_params * tokens
             + 12 * cfg.n_layers * module.seq_len * cfg.d_model * tokens)
    attn_ms = n * sum(flash_path[f"{k}_ms"] for k in ("fwd", "dkv", "dq"))
    res = dict(
        train_steps=TRAIN_STEPS, val_batches=VAL_BATCHES,
        first_loss=losses[0], last5_mean_loss=last5, losses=losses,
        val_loss=trainer.callback_metrics["val_loss"],
        expected_first_loss=float(np.log(cfg.vocab_size)),
        launches=launches, routes=routes, params=n_params, fit_s=fit_s,
        step_ms_median=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
        model_flops_per_step=flops,
        bf16_peak_share=flops / (step_ms / 1e3) / PEAK_OPS_PER_S[
            torch.bfloat16],
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        # n_layers x (K2 + K3 + K4 at the T1 path shapes, cold L2)
        attention_share_of_step=attn_ms / step_ms, card=card)
    print("phaseT2 training", json.dumps(res), flush=True)
    del trainer, module
    torch.cuda.empty_cache()
    return res


# -------------------------------------------------------------- phase T3
E2E_LOSS_RTOL = 1e-5    # the loss of one f32 step, kernel vs plain path
# each f32 gradient, |kernel - plain| <= this x its largest magnitude:
# attention's sums run in another order (the kernels' 64-key tiles and
# online softmax against one dense softmax and autograd's products) in 12
# layers, and the rest of the step is the same f32 code on both paths
E2E_GRAD_RTOL = 1e-4


def phase_t3_train_kernel_vs_plain():
    from ray_lightning_tpu_torch import GPTModule
    from ray_lightning_tpu_torch.data import synthetic_tokens
    from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
    cfg = gpt2_config("small", attention_impl="flash", dtype=torch.float32)
    toks = torch.from_numpy(synthetic_tokens(2, 1025, cfg.vocab_size,
                                             seed=3)).to(DEVICE)
    batch = (toks[:, :-1], toks[:, 1:])
    module = GPTModule(config=cfg)
    sd = None
    result = {}
    for impl in ("flash", "dot"):
        model = TransformerLM(dataclasses.replace(cfg, attention_impl=impl),
                              device="meta").to_empty(device=DEVICE)
        if sd is None:
            model.reset_parameters(torch.Generator().manual_seed(0))
            sd = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(sd)
        loss, _ = module._loss(model, batch)
        loss.backward()
        result[impl] = (loss.item(), {
            n: p.grad for n, p in model.named_parameters()})
        del model
    (lk, gk), (lp, gp) = result["flash"], result["dot"]
    check(np.isfinite(lk), f"T3 loss {lk}")
    rel = abs(lk - lp) / abs(lp)
    worst = max(((gk[n] - gp[n]).abs().max().item()
                 / max(gp[n].abs().max().item(), 1e-30), n) for n in gp)
    print(f"phaseT3 f32 training step, kernel vs plain path: loss "
          f"{lk:.6f} vs {lp:.6f} (rel {rel:.3e}, bound {E2E_LOSS_RTOL}); "
          f"worst gradient |diff|/max|grad| {worst[0]:.3e} in {worst[1]} "
          f"(bound {E2E_GRAD_RTOL})", flush=True)
    check(rel <= E2E_LOSS_RTOL, f"T3 loss differs by {rel}")
    check(worst[0] <= E2E_GRAD_RTOL, f"T3 gradient {worst[1]} differs by "
          f"{worst[0]} of its largest magnitude")
    del result
    torch.cuda.empty_cache()
    return rel, worst[0]


# -------------------------------------------------------------- phase M
M_RATE = 0.1                       # dropout of (a) and (c), GPT-2's
M_POLICIES = (None, "dots", "dots_with_no_batch_dims",
              "dots_with_no_batch_dims_save_attn",
              "dots_with_no_batch_dims_save_attn_mlp")
# the policies whose saved bytes must rise in this order (``dots`` keeps
# the attention products too, which the flash path does not make)
M_SAVED_ORDER = (None, "dots_with_no_batch_dims",
                 "dots_with_no_batch_dims_save_attn",
                 "dots_with_no_batch_dims_save_attn_mlp")
M_REMAT_STEPS, M_UNTIED_STEPS, M_SOFTMAX_STEPS = 5, 5, 3
M_SEED = 1234                      # (c)'s dropout seed
# (c) one f32 step with dropout, remat (policy None) against no remat:
# the replay must redraw every mask, or the loss moves by ~1e-3 and the
# gradients by their own size; these leave room for summation order only
M_REPLAY_LOSS_RTOL = 1e-6
M_REPLAY_GRAD_RTOL = 1e-5
# (d) the LM-head losses against the materialized loss on the same bf16
# hidden states: the materialized path rounds the logits and their
# gradient to bf16, the chunked one keeps f32 logits; loss relative,
# each gradient |diff| against its largest magnitude (4 bf16 ulps)
M_XENT_LOSS_RTOL = 1e-3
M_XENT_GRAD_RTOL = 2.0 ** -5
M_XENT_CHUNK = 2048
M_HEAD_MS = (8, 128, 1024)    # the untied head's M: decode, chunk, prefill


def m_fit(cfg, steps, val_batches=0, warmup=1, count_saved=False):
    """T2's fit (GPT-2-small, batch 8 x 1024, ``Trainer(strategy=
    RayStrategy(num_workers=1), seed=0)``) of ``GPTModule(config=cfg)``
    for ``steps`` steps and ``val_batches`` validation batches. Returns
    the losses, the median step ms after ``warmup`` steps, tokens/s,
    peak memory, K2-K4 launches and routes, and (``count_saved``) the
    bytes autograd kept for backward in the first step."""
    from ray_lightning_tpu_torch import GPTModule, RayStrategy, Trainer
    from ray_lightning_tpu_torch.core import LambdaCallback
    from ray_lightning_tpu_torch.models import remat
    from ray_lightning_tpu_torch.ops import cuda_flash as cf

    class Module(GPTModule):
        saved_bytes = None

        def training_step(self, model, batch, generator):
            if not count_saved or self.saved_bytes is not None:
                return super().training_step(model, batch, generator)
            with remat.count_saved() as counter:
                loss = super().training_step(model, batch, generator)
            self.saved_bytes = counter.bytes
            return loss

    module = Module(config=cfg, batch_size=8, seq_len=1024)
    ends, losses = [], []

    def on_batch_end(trainer, pl_module, outputs, batch, batch_idx):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        losses.append(float(outputs["loss"]))

    trainer = Trainer(strategy=RayStrategy(num_workers=1), max_epochs=1,
                      limit_train_batches=steps,
                      limit_val_batches=val_batches, seed=0,
                      callbacks=[LambdaCallback(
                          on_train_batch_end=on_batch_end)])
    release()
    torch.cuda.reset_peak_memory_stats()
    cf.reset_kernel_launches()
    trainer.fit(module)
    check(trainer.global_step == steps and len(losses) == steps
          and all(np.isfinite(losses)), f"M fit {cfg}: losses {losses}")
    step_ms = 1e3 * float(np.median(np.diff(ends)[warmup - 1:]))
    res = dict(losses=losses, step_ms_median=step_ms,
               tokens_per_s=module.batch_size * module.seq_len
               / (step_ms / 1e3),
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=cf.kernel_launches(),
               routes={k: cf.route_launches(k) for k in cf.KERNELS},
               saved_bytes=module.saved_bytes,
               val_loss=trainer.callback_metrics.get("val_loss"))
    del trainer, module
    release()
    return res


def m_flash_expect(what, res, fwd, bwd):
    """K2 launched ``fwd`` times, K3 and K4 ``bwd`` times, all on
    ``tc``."""
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    want = {"flash_fwd": fwd, "flash_bwd_dkv": bwd, "flash_bwd_dq": bwd}
    check(res["launches"] == want,
          f"{what}: flash launches {res['launches']} != {want}")
    routes = {k: {"simt": 0, "tc": want[k]} for k in cf.KERNELS}
    check(res["routes"] == routes,
          f"{what}: flash routes {res['routes']} != {routes}")


def phase_m_dropout(card, t2):
    """(a) GPT-2's dropout through ``Trainer.fit`` on the flash config:
    the reference routes dropout steps to the dense attention, so no
    training step launches K2-K4; validation is deterministic and
    launches K2 once a layer a batch."""
    from ray_lightning_tpu_torch.models import gpt2_config
    cfg = gpt2_config("small", attention_impl="flash", dropout=M_RATE)
    res = m_fit(cfg, TRAIN_STEPS, VAL_BATCHES, warmup=WARMUP_STEPS)
    m_flash_expect("phaseM (a)", res, cfg.n_layers * VAL_BATCHES, 0)
    losses = res["losses"]
    last5 = float(np.mean(losses[-5:]))
    check(last5 < losses[0], f"phaseM (a): loss did not fall: first "
          f"{losses[0]}, last-5 mean {last5}")
    row = dict(dropout=M_RATE, train_steps=TRAIN_STEPS,
               val_batches=VAL_BATCHES, first_loss=losses[0],
               last5_mean_loss=last5, **{k: res[k] for k in (
                   "step_ms_median", "tokens_per_s", "peak_memory_gib",
                   "launches", "val_loss")},
               t2_step_ms_median=t2["step_ms_median"],
               t2_tokens_per_s=t2["tokens_per_s"],
               t2_peak_memory_gib=t2["peak_memory_gib"], card=card)
    print("phaseM (a) dropout", json.dumps(row), flush=True)
    return res


def phase_m_remat(card):
    """(b) ``remat=True`` under each policy (flash, dropout 0), and the
    same fit without remat: K2 twice a layer a step (the forward and its
    replay: no policy can keep a ``ctypes`` kernel's output), K3 and K4
    once; the bytes autograd keeps in order."""
    from ray_lightning_tpu_torch.models import gpt2_config
    plain_cfg = gpt2_config("small", attention_impl="flash")
    n, s = plain_cfg.n_layers, M_REMAT_STEPS
    rows = {"no remat": m_fit(plain_cfg, s, count_saved=True)}
    m_flash_expect("phaseM (b) no remat", rows["no remat"], n * s, n * s)
    for policy in M_POLICIES:
        cfg = gpt2_config("small", attention_impl="flash", remat=True,
                          remat_policy=policy)
        res = m_fit(cfg, s, count_saved=True)
        m_flash_expect(f"phaseM (b) remat_policy={policy}", res,
                       2 * n * s, n * s)
        rows[str(policy)] = res
    plain = rows["no remat"]["losses"]
    for label, res in rows.items():
        row = dict(remat_policy=label, steps=s,
                   saved_bytes_per_step=res["saved_bytes"],
                   launches_per_step={k: v / s for k, v in
                                      res["launches"].items()},
                   losses_equal_no_remat=res["losses"] == plain,
                   **{k: res[k] for k in ("step_ms_median", "tokens_per_s",
                                          "peak_memory_gib")}, card=card)
        print("phaseM (b) remat", json.dumps(row), flush=True)
    saved = [rows[str(p)]["saved_bytes"] for p in M_SAVED_ORDER]
    check(all(a < b for a, b in zip(saved, saved[1:]))
          and saved[-1] <= rows["no remat"]["saved_bytes"],
          f"phaseM (b): saved bytes {dict(zip(M_SAVED_ORDER, saved))} "
          f"not in order, no remat {rows['no remat']['saved_bytes']}")
    return rows


def phase_m_replay():
    """(c) One f32 step of GPT-2-small (B=2, T=1024) with dropout 0.1,
    rematerialized (policy None) against not, the same weights, batch and
    seed: the replay redraws the masks."""
    from ray_lightning_tpu_torch import GPTModule
    from ray_lightning_tpu_torch.data import synthetic_tokens
    from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
    cfg = gpt2_config("small", attention_impl="flash", dtype=torch.float32,
                      dropout=M_RATE)
    toks = torch.from_numpy(synthetic_tokens(2, 1025, cfg.vocab_size,
                                             seed=3)).to(DEVICE)
    batch = (toks[:, :-1], toks[:, 1:])
    module = GPTModule(config=cfg)
    result = {}
    for remat in (False, True):
        model = TransformerLM(dataclasses.replace(cfg, remat=remat),
                              device="meta").to_empty(device=DEVICE)
        model.reset_parameters(torch.Generator().manual_seed(0))
        loss, _ = module._loss(model, batch, deterministic=False,
                               dropout_seed=M_SEED)
        loss.backward()
        result[remat] = (loss.item(), {
            n: p.grad for n, p in model.named_parameters()})
        del model
    (lr, gr), (lp, gp) = result[True], result[False]
    check(np.isfinite(lr), f"phaseM (c) loss {lr}")
    rel = abs(lr - lp) / abs(lp)
    worst = max(((gr[n] - gp[n]).abs().max().item()
                 / max(gp[n].abs().max().item(), 1e-30), n) for n in gp)
    bitwise = lr == lp and all(torch.equal(gr[n], gp[n]) for n in gp)
    print(f"phaseM (c) f32 step with dropout {M_RATE}, remat vs no remat: "
          f"loss {lr:.6f} vs {lp:.6f} (rel {rel:.3e}, bound "
          f"{M_REPLAY_LOSS_RTOL}); worst gradient |diff|/max|grad| "
          f"{worst[0]:.3e} in {worst[1]} (bound {M_REPLAY_GRAD_RTOL}); "
          f"bitwise {bitwise}", flush=True)
    check(rel <= M_REPLAY_LOSS_RTOL, f"phaseM (c): loss differs by {rel}")
    check(worst[0] <= M_REPLAY_GRAD_RTOL, f"phaseM (c): gradient "
          f"{worst[1]} differs by {worst[0]} of its largest magnitude")
    del result
    release()
    return rel, worst[0]


def phase_m_lm_head_loss(card):
    """(d) The LM-head losses on T2's model's hidden states (seed 0,
    batch 8 x 1024, bf16) and its tied table, against the materialized
    f32 loss ``GPTModule`` computes: loss and both gradients, and each
    path's time and the peak memory its forward and its backward add."""
    import torch.nn.functional as F
    from ray_lightning_tpu_torch.data import synthetic_tokens
    from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
    from ray_lightning_tpu_torch.ops.lm_head_loss import (
        chunked_lm_head_xent, lm_head_xent)
    cfg = gpt2_config("small")
    model = TransformerLM(cfg, device="meta").to_empty(device=DEVICE)
    model.reset_parameters(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(synthetic_tokens(8, 1025, cfg.vocab_size,
                                             seed=4)).to(DEVICE)
    labels = toks[:, 1:].long()
    with torch.no_grad():
        hidden = model(toks[:, :-1], return_hidden=True)
    table = model.wte.weight.detach()
    del model
    release()
    V = cfg.vocab_size
    paths = {
        "materialized": lambda h, t: F.cross_entropy(
            F.linear(h, t.to(cfg.dtype)).float().reshape(-1, V),
            labels.reshape(-1)),
        "lm_head_xent": lambda h, t: lm_head_xent(h, t, labels),
        "chunked_lm_head_xent": lambda h, t: chunked_lm_head_xent(
            h, t, labels, chunk_size=M_XENT_CHUNK),
    }
    out = {}
    for name, fn in paths.items():
        for _ in range(2):      # the second run is timed
            h = hidden.detach().requires_grad_()
            t = table.detach().requires_grad_()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = fn(h, t)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fwd_peak = torch.cuda.max_memory_allocated() - base
            held = torch.cuda.memory_allocated() - base
            mid = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            bwd_peak = torch.cuda.max_memory_allocated() - mid
            row = dict(loss=loss.item(), fwd_ms=1e3 * (t1 - t0),
                       bwd_ms=1e3 * (t2 - t1),
                       fwd_peak_gib=fwd_peak / 2**30,
                       held_for_backward_gib=held / 2**30,
                       bwd_peak_gib=bwd_peak / 2**30)
            grads = (h.grad.float(), t.grad)
            del loss, h, t
        out[name] = (row, grads)
        release()
    ref_row, ref_grads = out["materialized"]
    rows = {}
    for name, (row, grads) in out.items():
        row["loss_rel_diff"] = abs(row["loss"] - ref_row["loss"]) / abs(
            ref_row["loss"])
        row["grad_rel_diff"] = [
            (g - r).abs().max().item() / r.abs().max().item()
            for g, r in zip(grads, ref_grads)]
        rows[name] = row
        print(f"phaseM (d) {name}", json.dumps(dict(
            row, chunk=M_XENT_CHUNK, tokens=labels.numel(), vocab=V,
            loss_bound=M_XENT_LOSS_RTOL, grad_bound=M_XENT_GRAD_RTOL,
            card=card)), flush=True)
        check(np.isfinite(row["loss"]), f"phaseM (d) {name} loss")
        check(row["loss_rel_diff"] <= M_XENT_LOSS_RTOL,
              f"phaseM (d) {name}: loss differs by {row['loss_rel_diff']}")
        check(max(row["grad_rel_diff"]) <= M_XENT_GRAD_RTOL,
              f"phaseM (d) {name}: gradients differ by "
              f"{row['grad_rel_diff']} of their largest magnitude")
    del out, hidden, table
    release()
    return rows


def m_head_kernel(flush):
    """K5 at the untied head (int8, the dense orientation, K = 768, N =
    50257) against its plain version at M = 8, 128 and 1024 with bf16 x,
    every call on ``tc``: error, time, bound, plain and cuBLAS (on the
    dequantized bf16 weight) times. int4 cannot take this head: no even
    group length divides 50257 (the JAX rule refuses it too)."""
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    from ray_lightning_tpu_torch.models.quant import quantize_params
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    K, N = 768, 50257
    w = torch.randn((K, N), generator=gen, device=DEVICE) * 0.02
    try:
        quantize_params({"w": w}, "int4")
        check(False, "phaseM (e): int4 took a (768, 50257) leaf")
    except ValueError as exc:
        print(f"phaseM (e) K5 int4 at N={N}: refused ({exc})", flush=True)
    qt = quantize_params({"w": w}, "int8")["w"]
    wd = qt.dequantize().to(torch.bfloat16).reshape(K, N)
    rows = {}
    for M in M_HEAD_MS:
        x = torch.randn(M, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        qmm.reset_kernel_launches()
        got = qmm.quantized_matmul(x, qt)
        again = qmm.quantized_matmul(x, qt)
        torch.cuda.synchronize()
        routes = qmm.route_launches(n=N)
        check(routes == {r: 2 * (r == "tc") for r in qmm.ROUTES},
              f"phaseM (e) K5 at M={M}, N={N}: routes {routes}")
        check(torch.equal(got, again), "K5: a second call must give the "
              "same bits")
        ref = qmm.quantized_matmul_reference(x, qt)
        err = (got.float() - ref.float()).abs().max().item()
        tol = QMM_TOL[torch.bfloat16] * max(1.0,
                                            float(ref.float().abs().max()))
        bound_ms, bound_by = matmul_bound(x, qt, N)
        row = dict(proj="untied head", weights="int8", x="bfloat16", M=M,
                   K=K, N=N, route="tc", max_abs_err=err, tol=tol,
                   ms=time_ms(lambda: qmm.quantized_matmul(x, qt), flush),
                   plain_ms=time_ms(
                       lambda: qmm.quantized_matmul_reference(x, qt), flush),
                   library_ms=time_ms(lambda: torch.matmul(x, wd), flush),
                   bound_ms=bound_ms, bound_by=bound_by)
        print("phaseM (e) K5 untied head", json.dumps(row), flush=True)
        check(err <= tol, f"phaseM (e) K5 vs plain {err} > {tol}")
        rows[M] = row
    del w, wd, qt
    return rows


def untied_state(cfg, rng):
    """An untied GPT-2-small from phase 2's generator: phase 2's kind of
    random weights and an N(0, 0.02) ``lm_head/kernel`` (d_model, vocab),
    as the port's state dict."""
    from ray_lightning_tpu_torch.interop import load_flax_params
    from ray_lightning_tpu_torch.models import TransformerLM
    params = random_flax_params(cfg, rng)
    params["lm_head"] = {"kernel": rng.standard_normal(
        (cfg.d_model, cfg.vocab_size), dtype=np.float32) * 0.02}
    return load_flax_params(TransformerLM(cfg, device="cpu"),
                            params).state_dict()


def phase_m_untied(card, rng, trace):
    """(e) ``tie_embeddings=False``: a few training steps; phase 2's
    trace served with int8 weights through K5, the head on ``tc`` at
    every M; K5 at the head against its plain version; f32 kernel path
    against plain path (logits, greedy tokens)."""
    from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    cfg = gpt2_config("small", tie_embeddings=False)
    n = cfg.n_layers
    train = m_fit(dataclasses.replace(cfg, attention_impl="flash"),
                  M_UNTIED_STEPS)
    m_flash_expect("phaseM (e) training", train, n * M_UNTIED_STEPS,
                   n * M_UNTIED_STEPS)
    print("phaseM (e) untied training", json.dumps(dict(
        steps=M_UNTIED_STEPS, **{k: train[k] for k in (
            "losses", "step_ms_median", "tokens_per_s", "peak_memory_gib")},
        card=card)), flush=True)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    head = m_head_kernel(flush)
    del flush
    sd = untied_state(cfg, rng)
    proto = TransformerLM(cfg, device="meta")
    kw = dict(attention_kernel="cuda", matmul_kernel="cuda",
              weight_dtype="int8")
    serve(proto, sd, WARM, **kw)
    qmm.reset_kernel_launches()
    done, eng, st = serve(proto, sd, trace, **kw)
    heads, routes = qmm.route_launches(n=cfg.vocab_size), qmm.route_launches()
    check_completions(done, trace, cfg.vocab_size, "phaseM (e) untied int8")
    forwards = eng.decode_substeps + eng.prefills
    want_head = {r: forwards * (r == "tc") for r in qmm.ROUTES}
    check(heads == want_head, f"phaseM (e): the head's K5 routes {heads}, "
          f"expected {want_head}")
    want = {"gemv_dense": 4 * n * eng.decode_substeps, "gemv_attend": 0,
            "tc": 4 * n * eng.prefills + forwards, "tiled_f32": 0}
    check(routes == want, f"phaseM (e): K5 routes {routes}, expected {want}")
    res = dict(weight_dtype="int8", decode_steps=eng.decode_substeps,
               prefills=eng.prefills, route_launches=routes,
               head_route_launches=heads, param_bytes=eng.param_bytes(),
               **serving_times(done, st), card=card)
    print("phaseM (e) untied serving", json.dumps(res), flush=True)
    err, share = phase3_kernel_vs_plain_path(
        cfg, sd, trace, tag="phaseM (e) untied", paths=PATHS_QUANTIZED,
        weight_dtype="int8")
    check(share == 1.0, f"phaseM (e): f32 greedy tokens of the kernel path "
          f"equal the plain path's on a {share} share only")
    del sd
    release()
    return dict(train=train, head=head, serving=res, f32_logits_err=err)


def phase_m_softmax(card):
    """(f) ``attention_impl="dot"`` with a bf16 softmax beside the f32
    one: finite losses, step ms and peak memory."""
    from ray_lightning_tpu_torch.models import gpt2_config
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        res = m_fit(gpt2_config("small", attention_impl="dot",
                                attention_softmax_dtype=dtype),
                    M_SOFTMAX_STEPS)
        rows[str(dtype)] = res
        print("phaseM (f) dot attention", json.dumps(dict(
            softmax_dtype=str(dtype), steps=M_SOFTMAX_STEPS,
            **{k: res[k] for k in ("losses", "step_ms_median",
                                   "tokens_per_s", "peak_memory_gib")},
            card=card)), flush=True)
    return rows


def phase_m_model_core(card, t2, rng, trace):
    """Phase M: the model core's training options at GPT-2-small width."""
    release()
    t0 = time.perf_counter()
    res = dict(dropout=phase_m_dropout(card, t2),
               remat=phase_m_remat(card), replay=phase_m_replay(),
               lm_head_loss=phase_m_lm_head_loss(card),
               untied=phase_m_untied(card, rng, trace),
               softmax=phase_m_softmax(card))
    fits = [res["dropout"], *res["remat"].values(), res["untied"]["train"]]
    res["flash_launches"] = {k: sum(f["launches"][k] for f in fits)
                             for k in fits[0]["launches"]}
    print(f"phaseM done in {time.perf_counter() - t0:.1f} s, K2-K4 "
          f"launches {res['flash_launches']}", flush=True)
    return res


# -------------------------------------------------------------- phase R
R_STEPS, R_EVERY, R_KILL = 12, 4, 9   # save every 4 steps, die at step 10


def train_module(weighted: bool = False, **kw):
    """T2's module -- GPT-2-small at full width on the flash kernels --
    predicting the logits of its validation batches; ``weighted`` adds a
    float per-token loss weight (all ones) to every batch: the float leaf
    a NaN fault poisons."""
    import torch.nn.functional as F
    from ray_lightning_tpu_torch import GPTModule
    from ray_lightning_tpu_torch.data import (ArrayDataset, DataLoader,
                                              synthetic_tokens)
    from ray_lightning_tpu_torch.models import gpt2_config

    class Module(GPTModule):
        def predict_dataloader(self):
            return self.val_dataloader()

        def predict_step(self, model, batch, generator):
            return model(batch[0])

    class Weighted(Module):
        def _loader(self, seed, shuffle=False):
            toks = synthetic_tokens(self.num_samples, self.seq_len + 1,
                                    self.cfg.vocab_size, seed=seed)
            ones = np.ones(toks[:, 1:].shape, np.float32)
            return DataLoader(ArrayDataset((toks[:, :-1], toks[:, 1:], ones)),
                              batch_size=self.batch_size, shuffle=shuffle)

        def training_step(self, model, batch, generator):
            inputs, targets, weight = batch
            logits = model(inputs)
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 targets.reshape(-1).long(),
                                 reduction="none")
            return (ce * weight.reshape(-1)).mean()

    return (Weighted if weighted else Module)(
        config=gpt2_config("small", attention_impl="flash"), batch_size=8,
        seq_len=1024, **kw)


def train_strategy():
    from ray_lightning_tpu_torch import RayStrategy
    return RayStrategy(num_workers=1)


def check_flash_launches(what: str, steps: int, fwd_extra: int = 0,
                         n: int = 12) -> dict:
    """K2-K4 launched ``n`` (n_layers) times per step, K2 also per extra
    forward, every launch on the tensor-core route, since the last
    reset."""
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    expect = {"flash_fwd": n * (steps + fwd_extra),
              "flash_bwd_dkv": n * steps, "flash_bwd_dq": n * steps}
    routes = {name: cf.route_launches(name) for name in cf.KERNELS}
    want = {name: {"simt": 0, "tc": expect[name]} for name in cf.KERNELS}
    check(routes == want, f"{what}: flash routes {routes} != {want}")
    return {name: expect[name] for name in cf.KERNELS}


def host_state(trainer) -> dict:
    """The train state's tensors copied to the host (params, optimizer
    state, counters), for bitwise comparison."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().clone()
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x
    return copy(trainer.train_state.state_dict())


def bitwise_diff(a, b, where="") -> list:
    """Paths at which two host states differ (values, dtypes or keys)."""
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
        return [] if same else [where]
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [where]
        return [d for k in a for d in bitwise_diff(a[k], b[k],
                                                   f"{where}/{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [where]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in bitwise_diff(x, y, f"{where}/{i}")]
    return [] if a == b else [where]


def tree_bytes(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def r_trainer(root, losses, **kw):
    from ray_lightning_tpu_torch import Trainer
    from ray_lightning_tpu_torch.core import LambdaCallback
    rec = LambdaCallback(on_train_batch_end=lambda tr, m, out, b, i:
                         losses.append((tr.global_step,
                                        float(out["loss"]))))
    kw["callbacks"] = [rec, *kw.get("callbacks", [])]
    return Trainer(strategy=train_strategy(), max_epochs=1,
                   limit_train_batches=R_STEPS, limit_val_batches=0,
                   seed=0, default_root_dir=root, **kw)


def phase_r_resume(card):
    """Checkpoint and resume on the card: returns its measurements."""
    import tempfile
    from ray_lightning_tpu_torch import FaultPlan, ModelCheckpoint
    from ray_lightning_tpu_torch.core.checkpoint import (
        find_resume_candidates, is_committed_checkpoint)
    from ray_lightning_tpu_torch.core import LambdaCallback
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    from ray_lightning_tpu_torch.reliability import InjectedFault
    release()
    root = tempfile.mkdtemp(prefix="chip_smoke_r_")
    res = {"card": card}
    try:
        # (a) uninterrupted, with a stream checkpoint taken at step 8
        stream_path = os.path.join(root, "stream", "step8.ckpt")
        saved = {}

        def save_stream(tr, m, out, b, i):
            if tr.global_step == 2 * R_EVERY:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.save_checkpoint(stream_path, save_format="stream")
                saved["ms"] = 1e3 * (time.perf_counter() - t0)
        losses_a = []
        ta = r_trainer(root, losses_a, callbacks=[LambdaCallback(
            on_train_batch_end=save_stream)])
        ta.fit(train_module())
        state_a = host_state(ta)
        check(len(losses_a) == R_STEPS
              and all(np.isfinite(v) for _, v in losses_a),
              f"R (a) losses {losses_a}")
        res["stream_bytes"] = tree_bytes(stream_path)
        res["stream_save_ms"] = saved["ms"]

        # the directory format's save of the same run's final state
        dir_path = os.path.join(root, "dir", "final.orbax")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ta.save_checkpoint(dir_path, save_format="orbax")
        res["dir_save_ms"] = 1e3 * (time.perf_counter() - t0)
        res["dir_bytes"] = tree_bytes(dir_path)
        # each read into the live state on the card; the directory (the
        # final state) last, so the state ends as (a) left it
        for fmt, path in (("stream", stream_path), ("dir", dir_path)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt = ta._read_checkpoint(path)
            ta.train_state.load_state_dict(ckpt["state"])
            torch.cuda.synchronize()
            res[f"{fmt}_load_ms"] = 1e3 * (time.perf_counter() - t0)
            del ckpt
            for op in ("save", "load"):
                res[f"{fmt}_{op}_gb_per_s"] = (
                    res[f"{fmt}_bytes"] / 1e9
                    / (res[f"{fmt}_{op}_ms"] / 1e3))
        check(not bitwise_diff(state_a, host_state(ta)),
              "R: loading the directory checkpoint changed the state")
        shutil.rmtree(os.path.dirname(dir_path))
        del ta
        release()

        # (b) the same run, periodic directory saves, killed at step 10
        ck = os.path.join(root, "ck")
        mc = dict(dirpath=ck, every_n_train_steps=R_EVERY,
                  save_format="orbax", keep_last_n=1)
        losses_b = []
        tb = r_trainer(root, losses_b, callbacks=[ModelCheckpoint(**mc)])
        try:
            with FaultPlan.at("train.step", [R_KILL]).armed():
                tb.fit(train_module())
            check(False, "R (b) was not killed")
        except InjectedFault:
            pass
        del tb
        release()
        names = sorted(os.listdir(ck))
        check(names == [f"epoch=0-step={2 * R_EVERY}.orbax"],
              f"R (b) left {names}")

        # (c) resume="auto" restores step 8 and finishes
        losses_c = []
        cf.reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tc = r_trainer(root, losses_c, resume="auto",
                       callbacks=[ModelCheckpoint(**mc)])
        tc.fit(train_module())
        res["resume_fit_s"] = time.perf_counter() - t0
        resumed = R_STEPS - 2 * R_EVERY
        res["resumed_launches"] = check_flash_launches("R (c)", resumed)
        check([s for s, _ in losses_c] == list(range(2 * R_EVERY + 1,
                                                      R_STEPS + 1)),
              f"R (c) steps {losses_c}")
        check(losses_c == losses_a[-resumed:],
              f"R (c) losses {losses_c} != (a) {losses_a[-resumed:]}")
        diff = bitwise_diff(state_a, host_state(tc))
        check(not diff, f"R (c) differs from (a) at {diff[:5]}")
        res["resumed_losses"] = [v for _, v in losses_c]

        # a save killed at ckpt.save leaves nothing that resume picks up
        torn = os.path.join(ck, "epoch=0-step=99.orbax")
        try:
            with FaultPlan.at("ckpt.save", [0]).armed():
                tc.save_checkpoint(torn, save_format="orbax")
            check(False, "R: the ckpt.save fault did not fire")
        except InjectedFault:
            pass
        left = sorted(os.listdir(ck))
        cands = find_resume_candidates(ck)
        check(not os.path.exists(torn) and not any(".tmp-" in n
                                                   for n in left)
              and cands and is_committed_checkpoint(cands[0])
              and cands[0].endswith(f"step={R_STEPS}.orbax"),
              f"R: after the killed save {left}, candidates {cands}")
        del tc
        release()

        # (d) the stream checkpoint of (a) at step 8, through ckpt_path=
        losses_d = []
        td = r_trainer(root, losses_d)
        td.fit(train_module(), ckpt_path=stream_path)
        check(losses_d == losses_a[-resumed:],
              f"R (d) losses {losses_d} != (a) {losses_a[-resumed:]}")
        diff = bitwise_diff(state_a, host_state(td))
        check(not diff, f"R (d) differs from (a) at {diff[:5]}")
        del td
        release()

        # (e) (b) and (c) with asynchronous directory saves: in one
        # process the tensors are copied to the host on the step's thread
        # and written on the commit thread
        res["async"] = r_async(root, mc, losses_a, state_a)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("phaseR checkpoint and resume", json.dumps(res), flush=True)
    return res, state_a


class TimedCheckpoint(ModelCheckpoint):
    """``ModelCheckpoint`` recording the ms each periodic save takes until
    it returns."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.ms = []

    def on_train_batch_end(self, trainer, module, outputs, batch, idx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super().on_train_batch_end(trainer, module, outputs, batch, idx)
        if trainer.global_step % R_EVERY == 0:
            self.ms.append(1e3 * (time.perf_counter() - t0))


def r_async(root, mc, losses_a, state_a) -> dict:
    """Phase R (e): the kill and the resume of (b) and (c) with
    ``async_save=True``; the resumed fit bitwise (a)."""
    from ray_lightning_tpu_torch import FaultPlan, ModelCheckpoint
    from ray_lightning_tpu_torch.core.checkpoint import wait_for_async_saves
    from ray_lightning_tpu_torch.reliability import InjectedFault
    ck = os.path.join(root, "ck_async")
    amc = dict(mc, dirpath=ck, async_save=True)
    out = {}
    timer = TimedCheckpoint(**amc)
    tb = r_trainer(root, [], callbacks=[timer])
    try:
        with FaultPlan.at("train.step", [R_KILL]).armed():
            tb.fit(train_module())
        check(False, "R (e) was not killed")
    except InjectedFault:
        pass
    wait_for_async_saves()
    out["save_returned_ms"] = list(timer.ms)
    del tb, timer
    release()
    names = sorted(os.listdir(ck))
    check(names == [f"epoch=0-step={2 * R_EVERY}.orbax"],
          f"R (e) left {names}")
    losses = []
    tc = r_trainer(root, losses, resume="auto",
                   callbacks=[ModelCheckpoint(**amc)])
    tc.fit(train_module())
    resumed = R_STEPS - 2 * R_EVERY
    check(losses == losses_a[-resumed:],
          f"R (e) losses {losses} != (a) {losses_a[-resumed:]}")
    diff = bitwise_diff(state_a, host_state(tc))
    check(not diff, f"R (e) differs from (a) at {diff[:5]}")
    out["resumed_bitwise"] = True
    del tc
    release()
    return out


# -------------------------------------------------------------- phase H
H_LIFECYCLE = ["launch.start", "worker.start", "fit.start", "epoch.start",
               "epoch.end", "fit.end", "launch.done"]
H_GAUGES = {"profile_train_step_s", "profile_get_train_batch_s",
            "profile_validation_s", "profile_epoch_end_callbacks_s"}
# a beat follows each step; the longest gap between two is step 8's, with
# its directory save and the memory tier's host copy and put (~1.5 GB)
H_HEARTBEAT_TIMEOUT = 20.0
# a fresh worker's first step: spawn, torch import, the CUDA context, the
# kernels' loads and the first step
H_STARTUP_GRACE = 300.0
H_STALL_S = 600.0                # far past the timeout: never waited out
# free device memory at a restarted worker's first step against the
# fault-free worker's: a dead worker left on the card would hold its
# whole ~10 GB, while a resumed worker's allocator keeps ~1.06 GB more
# cached from the restore's uploads
H_MEM_SLACK = 4 << 30
# the gang fit: 8 steps, a save every 4 (periodic only); attempt 1 dies
# before step 6 (tick 5), attempt 2 (resumed at step 4) wedges before
# step 7 (its tick 2)
H_STEPS, H_EVERY, H_KILL, H_STALL_AT = 8, 4, 5, 2
H_GANG_SITES = ("worker.dead", "worker.error", "worker.heartbeat_missed",
                "gang.teardown", "gang.restart", "standby.promoted")


class PeriodicCheckpoint(ModelCheckpoint):
    """``ModelCheckpoint`` without its epoch-end save (the gang fits end
    on a periodic one, and each save is a memory put too)."""

    def on_train_epoch_end(self, trainer, module):
        pass


class HProbe(Callback):
    """What a gang worker's fit looks like from inside: the wall time
    (``time.time``) of this attempt's fit start and of each of its steps'
    ends (each step synchronized; the state a resume restores is dropped
    at fit start), and the card's free memory at its first step's end;
    carried back as this callback's state. ``stamp``: a file the end of
    each step writes its wall time, the first step's and the free memory
    to, which outlives a worker that dies (the fault sites fire right
    after the end hooks)."""

    def __init__(self, stamp=None):
        self.stamp = stamp
        self.fit_start, self.ends, self.free_at_first = None, [], None

    def on_fit_start(self, trainer, module):
        self.fit_start, self.ends, self.free_at_first = time.time(), [], None

    def on_train_batch_end(self, trainer, module, outputs, batch, idx):
        torch.cuda.synchronize()
        self.ends.append(time.time())
        if self.free_at_first is None:
            self.free_at_first = torch.cuda.mem_get_info()[0]
        if self.stamp is not None:
            with open(self.stamp, "w") as f:
                f.write(json.dumps({"wall": self.ends[-1],
                                    "first_wall": self.ends[0],
                                    "free_at_first": self.free_at_first}))

    def state_dict(self):
        return {"fit_start": self.fit_start, "ends": self.ends,
                "free_at_first": self.free_at_first}

    def load_state_dict(self, state):
        self.fit_start = state["fit_start"]
        self.ends = state["ends"]
        self.free_at_first = state["free_at_first"]


def h_armed_fit(card, t2):
    """(a): T2's fit with telemetry, StepStats(block=True) and the simple
    profiler, against T2's disarmed fit of the same call (the same
    per-step synchronize, the same steps)."""
    from ray_lightning_tpu_torch import (GPTModule, RayStrategy,
                                         StepStatsCallback, Telemetry,
                                         Trainer)
    from ray_lightning_tpu_torch.core import LambdaCallback
    from ray_lightning_tpu_torch.models import gpt2_config
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    release()
    ends, step_ms = [], []

    def on_end(trainer, m, outputs, batch, idx):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        step_ms.append(trainer.callback_metrics["step_time_ms"])
    tel = Telemetry(clock=time.perf_counter)
    trainer = Trainer(strategy=RayStrategy(num_workers=1), max_epochs=1,
                      limit_train_batches=TRAIN_STEPS,
                      limit_val_batches=VAL_BATCHES, seed=0, callbacks=[
                          StepStatsCallback(tel, block=True),
                          LambdaCallback(on_train_batch_end=on_end)],
                      telemetry=tel, profiler="simple")
    cf.reset_kernel_launches()
    trainer.fit(GPTModule(config=gpt2_config("small",
                                             attention_impl="flash"),
                          batch_size=8, seq_len=1024))
    launches = check_flash_launches("H (a)", TRAIN_STEPS,
                                    fwd_extra=VAL_BATCHES)
    check(launches == t2["launches"],
          f"H (a) launches {launches}, T2's disarmed {t2['launches']}")
    sites = [e.site for e in tel.events()]
    life = [x for x in sites if x != "train.straggler"]
    check(life == H_LIFECYCLE, f"H (a) events {sites}")
    snap = tel.metrics.snapshot()
    check(snap["train_step_ms"]["count"] == TRAIN_STEPS,
          f"H (a) train_step_ms {snap['train_step_ms']}")
    gauges = {k: v for k, v in snap.items() if k.startswith("profile_")}
    check(set(gauges) == H_GAUGES and all(v > 0 for v in gauges.values()),
          f"H (a) gauges {gauges}")
    res = dict(card=card, launches=launches, events=life,
               stragglers=sites.count("train.straggler"),
               train_step_ms=snap["train_step_ms"], gauges=gauges,
               step_time_ms_median=float(np.median(step_ms[WARMUP_STEPS:])),
               armed_step_ms_median=1e3 * float(np.median(
                   np.diff(ends)[WARMUP_STEPS - 1:])),
               t2_step_ms_median=t2["step_ms_median"])
    # block=True times the device work: a step timed at its enqueue
    # would read a fraction of the same fit's synchronized step
    res["step_time_over_synced_step"] = (res["step_time_ms_median"]
                                         / res["armed_step_ms_median"])
    check(res["step_time_over_synced_step"] > 0.9,
          f"H (a) step_time_ms {res['step_time_ms_median']} against the "
          f"synchronized step's {res['armed_step_ms_median']} ms")
    res["step_time_over_t2_step"] = (res["step_time_ms_median"]
                                     / t2["step_ms_median"])
    res["armed_over_disarmed_step"] = (res["armed_step_ms_median"]
                                       / t2["step_ms_median"])
    del trainer
    release()
    return res


def h_supervised_fit(state_r) -> dict:
    """(b): FitSupervisor over phase R's fit, killed at step 10; the final
    state bitwise phase R (a)'s."""
    import tempfile
    from ray_lightning_tpu_torch import FaultPlan, ModelCheckpoint
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    from ray_lightning_tpu_torch.reliability import (FitSupervisor,
                                                     RetryPolicy)
    root = tempfile.mkdtemp(prefix="chip_smoke_h_")
    try:
        mc = dict(dirpath=os.path.join(root, "ck"), save_format="orbax",
                  every_n_train_steps=R_EVERY, keep_last_n=1)
        sup = FitSupervisor(
            lambda: r_trainer(root, [], callbacks=[ModelCheckpoint(**mc)]),
            RetryPolicy(max_attempts=3, base_delay=0.0),
            sleep=lambda s: None)
        cf.reset_kernel_launches()
        t0 = time.perf_counter()
        with FaultPlan.at("train.step", [R_KILL]).armed():
            trainer = sup.fit(train_module)
        fit_s = time.perf_counter() - t0
        # attempt 1 runs R_KILL steps, attempt 2 the steps after the
        # step-8 save
        launches = check_flash_launches(
            "H (b)", R_KILL + R_STEPS - 2 * R_EVERY)
        check(sup.attempts == 2, f"H (b) attempts {sup.attempts}")
        diff = bitwise_diff(state_r, host_state(trainer))
        check(not diff, f"H (b) differs from R (a) at {diff[:5]}")
        del trainer, sup
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release()
    return {"attempts": 2, "bitwise_vs_r": True, "fit_s": fit_s,
            "launches": launches}


class ChainedGang(GangSupervisor):
    """Phase H's supervisor: attempt n runs under ``plans[n - 1]`` (armed
    in the driver when the attempt's trainer is made, so its dispatch
    carries it), the warm pool is attached from attempt ``warm_from`` on,
    and each restart's wall time (``time.time``) is recorded."""

    def __init__(self, *a, plans, pool, warm_from, **kw):
        super().__init__(*a, standby=pool, **kw)
        self.plans, self.pool, self.warm_from = plans, pool, warm_from
        self.restart_walls = []

    def _prepare_trainer(self, trainer):
        from ray_lightning_tpu_torch.reliability import faults
        faults.disarm()
        faults.arm(self.plans[self.attempts - 1])
        if self.attempts >= self.warm_from:
            trainer._launcher._standby = self.pool
        return super()._prepare_trainer(trainer)

    def _on_retry(self, attempt):
        self.restart_walls.append(time.time())
        super()._on_retry(attempt)


def h_reference(steps) -> dict:
    """The fault-free reference of the gang fits: the same fit in this
    process (a DDP world of one is the one-process fit bitwise: runs
    HB-HD checked it against a fault-free gang fit)."""
    import tempfile
    from ray_lightning_tpu_torch import Trainer
    root = tempfile.mkdtemp(prefix="chip_smoke_h_ref_")
    try:
        trainer = Trainer(strategy=train_strategy(), max_epochs=1,
                          limit_train_batches=steps, limit_val_batches=0,
                          seed=0, default_root_dir=root)
        trainer.fit(train_module())
        state = host_state(trainer)
        del trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release()
    return state


def h_gang_chain(ray, gang, ref_state) -> dict:
    """(c)-(e) in one supervised gang fit of T2's module (H_STEPS steps,
    a periodic stream save every H_EVERY) on a spawned card worker, a
    memory store installed: attempt 1 dies by ``os._exit`` before step 6
    and restarts cold (c); attempt 2 resumes from memory and wedges
    before step 7, and restarts on a warm standby (d, e); attempt 3
    finishes."""
    import tempfile
    from ray_lightning_tpu_torch import (FaultPlan, RayStrategy, Telemetry,
                                         Trainer)
    from ray_lightning_tpu_torch.launchers import ExecutorBase, RayLauncher
    from ray_lightning_tpu_torch.reliability import (MemoryCheckpointStore,
                                                     RetryPolicy,
                                                     StandbyPool, faults)
    root = tempfile.mkdtemp(prefix="chip_smoke_h_gang_")
    # wall-clock events: an event's time is t0 + wall_ms, t0 the first
    tel = Telemetry(clock=time.time)
    t0 = time.time()
    tel.event("phaseH.start")
    store = MemoryCheckpointStore(keep_last=1)
    pool = StandbyPool(ray, num_standby=1, warmup_timeout=300.0)
    # the standby spawns and warms off the critical path, while the
    # first two attempts train
    pool.refill_async(lambda: ray.remote(ExecutorBase).options(
        num_gpus=1, construct_timeout=300).remote())
    probes = []

    def make_trainer():
        probes.append(HProbe(os.path.join(root,
                                          f"attempt_{len(probes)}")))
        strategy = RayStrategy(num_workers=1)
        trainer = Trainer(
            strategy=strategy, max_epochs=1, limit_train_batches=H_STEPS,
            limit_val_batches=0, seed=0, default_root_dir=root,
            telemetry=tel, callbacks=[
                PeriodicCheckpoint(dirpath=os.path.join(root, "ck"),
                                   every_n_train_steps=H_EVERY,
                                   keep_last_n=1), probes[-1]])
        trainer._launcher = RayLauncher(strategy, ray_module=ray, gang=gang)
        return trainer

    plans = [FaultPlan.at("worker.exit", [H_KILL], mode="exit"),
             FaultPlan.at("worker.stall", [H_STALL_AT], mode="stall",
                          stall_s=H_STALL_S),
             FaultPlan([])]
    sup = ChainedGang(make_trainer, RetryPolicy(max_attempts=3,
                                                base_delay=0.0),
                      sleep=lambda s: None, telemetry=tel,
                      restart_backoff=0.0, plans=plans, pool=pool,
                      warm_from=3)
    release()
    try:
        with store.installed():
            t1 = time.perf_counter()
            trainer = sup.fit(t2_module)
            fit_s = time.perf_counter() - t1
        # each attempt's last step end and first step's free memory: the
        # dead and wedged workers' stamps outlive them
        stamps = []
        for n in range(3):
            with open(os.path.join(root, f"attempt_{n}")) as f:
                stamps.append(json.loads(f.read()))
    finally:
        faults.disarm()
        pool.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    sites = [e.site for e in tel.events() if e.site in H_GANG_SITES]
    want = ["worker.dead", "gang.teardown", "gang.restart",
            "worker.heartbeat_missed", "gang.teardown", "gang.restart",
            "standby.promoted"]
    check(sites == want, f"H (c)-(e) events {sites} != {want}")
    check(sup.attempts == 3 and pool.promotions == 1,
          f"H attempts {sup.attempts}, promotions {pool.promotions}")
    dead, wedged = sup.failures
    check(dead.reason == "worker.dead" and dead.postmortems[0].dead
          and dead.postmortems[0].last_step == H_KILL,
          f"H (c) failure {dead}")
    check(wedged.reason == "worker.heartbeat_missed"
          and wedged.postmortems[0].silent
          and wedged.postmortems[0].last_step == H_EVERY + H_STALL_AT,
          f"H (d) failure {wedged}")
    check(trainer.resumed_from == f"<memory:step={H_EVERY}>",
          f"H resumed from {trainer.resumed_from}")
    diff = bitwise_diff(ref_state, trainer.train_state_dict)
    check(not diff, f"H (c)-(e) differ from the fault-free fit at "
          f"{diff[:5]}")
    ev = {}
    for e in tel.events():
        ev.setdefault(e.site, []).append(t0 + e.wall_ms / 1e3)
    cold, warm = sup.restart_walls
    out = dict(
        fit_s=fit_s, memory_puts=[{"bytes": b, "ms": 1e3 * t}
                                  for b, t in trainer.memory_puts],
        store_puts=store.puts, resumed_from=trainer.resumed_from,
        exit=dict(
            fault_to_detection_ms=1e3 * (ev["worker.dead"][0]
                                         - stamps[0]["wall"]),
            fault_to_teardown_ms=1e3 * (ev["gang.teardown"][0]
                                        - stamps[0]["wall"]),
            restart_to_first_step_s=stamps[1]["first_wall"] - cold,
            free_at_first_step=stamps[1]["free_at_first"],
            free_at_first_step_fresh=stamps[0]["free_at_first"]),
        stall=dict(
            heartbeat_timeout_s=H_HEARTBEAT_TIMEOUT,
            last_beat_age_s=wedged.postmortems[0].last_beat_age_s,
            fault_to_detection_ms=1e3 * (ev["worker.heartbeat_missed"][0]
                                         - stamps[1]["wall"]),
            fault_to_teardown_ms=1e3 * (ev["gang.teardown"][1]
                                        - stamps[1]["wall"])),
        standby=dict(
            restart_to_first_step_s=stamps[2]["first_wall"] - warm,
            cold_restart_to_first_step_s=stamps[1]["first_wall"] - cold,
            promotions=pool.promotions))
    # a dead worker left on the card would hold its whole ~10 GB; the
    # resumed one's allocator keeps ~1 GB more cached than a fresh one's
    check(abs(stamps[1]["free_at_first"] - stamps[0]["free_at_first"])
          <= H_MEM_SLACK,
          f"H (c) free memory at the restarted worker's first step "
          f"{stamps[1]['free_at_first']} against the fresh worker's "
          f"{stamps[0]['free_at_first']}")
    latency = out["stall"]["fault_to_detection_ms"] / 1e3
    check(H_HEARTBEAT_TIMEOUT <= latency < H_HEARTBEAT_TIMEOUT + 10.0,
          f"H (d) detected {latency} s after the stall began")
    store.shutdown()
    del trainer, sup
    release()
    return out


def phase_h_fit_health(card, t2, state_r):
    """The health of a fit: telemetry, FitSupervisor and the gang."""
    from ray_lightning_tpu_torch.launchers import ProcessRay
    from ray_lightning_tpu_torch.reliability import GangConfig
    res = {"card": card, "armed": h_armed_fit(card, t2)}
    print("phaseH (a) telemetry", json.dumps(res["armed"]), flush=True)
    res["supervised"] = h_supervised_fit(state_r)
    print("phaseH (b) FitSupervisor", json.dumps(res["supervised"]),
          flush=True)
    ref_state = h_reference(H_STEPS)
    gang = GangConfig(heartbeat_timeout=H_HEARTBEAT_TIMEOUT,
                      startup_grace=H_STARTUP_GRACE)
    ray = ProcessRay()
    ray.init()
    try:
        res["gang"] = h_gang_chain(ray, gang, ref_state)
    finally:
        ray.shutdown()
    check(ray.live_actor_count() == 0, "H: a worker outlived the phase")
    print("phaseH fit health", json.dumps(res), flush=True)
    return res


# -------------------------------------------------------------- phase O
O_STEPS, O_GUARD_STEPS, O_POISON = 10, 6, 2
O_PREDICT = 2
# the JAX preset's adafactor state for GPT-2-small (optax on the scanned
# leaves: the fused qkv weight's second moment kept whole)
ADAFACTOR_STATE_BYTES = 334_953_400


def release() -> None:
    """Free what dropped trainers held: a trainer and its module refer to
    each other, so only the cycle collector frees them."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_o_optimizers(card):
    """The optimizer presets, predict and the guard on the card."""
    from ray_lightning_tpu_torch import FaultPlan, Trainer
    from ray_lightning_tpu_torch.core import LambdaCallback, opt_state_bytes
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    res = {"card": card, "presets": {}}
    for name in ("adamw", "adamw_bf16m", "adafactor"):
        ends, losses = [], []

        def on_end(tr, m, out, b, i):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            losses.append(float(out["loss"]))
        release()
        module = train_module(optimizer=name)
        trainer = Trainer(strategy=train_strategy(), max_epochs=1,
                          limit_train_batches=O_STEPS, limit_val_batches=0,
                          seed=0, callbacks=[LambdaCallback(
                              on_train_batch_end=on_end)])
        torch.cuda.reset_peak_memory_stats()
        cf.reset_kernel_launches()
        trainer.fit(module)
        check_flash_launches(f"O {name}", O_STEPS)
        first, last5 = losses[0], float(np.mean(losses[-5:]))
        check(len(losses) == O_STEPS and all(np.isfinite(losses)),
              f"O {name} losses {losses}")
        check(last5 < first, f"O {name}: loss did not fall: first {first}, "
              f"last-5 mean {last5}")
        state_bytes = opt_state_bytes(trainer.train_state.optimizer)
        if name == "adafactor":
            check(state_bytes == ADAFACTOR_STATE_BYTES,
                  f"O adafactor: opt_state_bytes {state_bytes}, the JAX "
                  f"preset's {ADAFACTOR_STATE_BYTES}")
        res["presets"][name] = dict(
            opt_state_bytes=state_bytes,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            step_ms_median=1e3 * float(np.median(
                np.diff(ends)[WARMUP_STEPS - 1:])),
            first_loss=first, last5_mean_loss=last5, losses=losses)
        if name == "adamw":
            res["predict"] = predict_check(trainer, module)
        del trainer, module

    # the guard: one NaN-weighted batch skipped, params finite, one
    # AdamW step fewer than batches
    release()
    trainer = Trainer(strategy=train_strategy(), max_epochs=1,
                      limit_train_batches=O_GUARD_STEPS, limit_val_batches=0,
                      seed=0, nonfinite_action="skip_batch")
    with FaultPlan.at("loader.next", [O_POISON], mode="nan").armed():
        trainer.fit(train_module(weighted=True))
    steps = {int(s["step"]) for s in
             trainer.train_state.optimizer.state.values()}
    finite = all(torch.isfinite(p).all().item()
                 for p in trainer.model.parameters())
    check(trainer.nonfinite_batches == 1 and finite
          and steps == {O_GUARD_STEPS - 1},
          f"O guard: nonfinite_batches {trainer.nonfinite_batches}, "
          f"finite {finite}, optimizer steps {steps}")
    res["guard"] = dict(batches=O_GUARD_STEPS, poisoned=O_POISON,
                        nonfinite_batches=trainer.nonfinite_batches,
                        optimizer_steps=sorted(steps))
    del trainer
    release()
    print("phaseO optimizers, predict, guard", json.dumps(res), flush=True)
    return res


def predict_check(trainer, module) -> dict:
    """``Trainer.predict`` over O_PREDICT validation batches: n_layers K2
    launches a batch, logits equal to the ``model.eval()`` forward."""
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    trainer.limit_predict_batches = O_PREDICT
    cf.reset_kernel_launches()
    outs = trainer.predict(module)
    check_flash_launches("O predict", 0, fwd_extra=O_PREDICT)
    check(len(outs) == O_PREDICT, f"O predict gave {len(outs)} batches")
    model = trainer.model.eval()
    with torch.no_grad():
        for out, batch in zip(outs, module.val_dataloader(), strict=False):
            want = model(torch.from_numpy(batch[0]).to(DEVICE)).cpu()
            check(out.shape == want.shape and torch.equal(out, want),
                  "O predict logits differ from model.eval() forward")
    return dict(batches=len(outs), shape=list(outs[0].shape),
                dtype=str(outs[0].dtype), bitwise=True)

# -------------------------------------------------------------- phase D
D_STEPS = 6
# ZeRO and FSDP2 against T2's losses, relative: bf16 activations, and the
# sharded or gathered paths may sum in another order, which can flip a
# bf16 rounding; over 6 AdamW steps that moves a loss of ~11 far less
# than this
D_LOSS_RTOL = 1e-3


class WorkerProbe(Callback):
    """Measures a fit from inside the process that trains it: the flash
    kernels' launches per route (reset at fit start), step end times and
    losses, peak device memory and ``opt_state_bytes``; the counts and
    sizes ride back in ``callback_metrics``, the per-step series as this
    callback's state (both reach the driver from rank 0)."""

    def __init__(self, launched_at: float):
        self.launched_at = launched_at
        self.losses, self.ends, self.fit_start = [], [], None

    def on_fit_start(self, trainer, module):
        from ray_lightning_tpu_torch.ops import cuda_flash as cf
        self.fit_start = time.time()
        cf.reset_kernel_launches()
        torch.cuda.reset_peak_memory_stats()

    def on_train_batch_end(self, trainer, module, outputs, batch, idx):
        torch.cuda.synchronize()
        self.ends.append(time.perf_counter())
        self.losses.append(float(outputs["loss"]))

    def on_train_end(self, trainer, module):
        from ray_lightning_tpu_torch.core import opt_state_bytes
        from ray_lightning_tpu_torch.ops import cuda_flash as cf
        m = trainer.callback_metrics
        for name in cf.KERNELS:
            for route, n in cf.route_launches(name).items():
                m[f"launches/{name}/{route}"] = n
        m["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        m["opt_state_bytes"] = opt_state_bytes(trainer.train_state.optimizer)
        m["launch_to_fit_start_s"] = self.fit_start - self.launched_at
        m["device"] = str(trainer.strategy.root_device)

    def state_dict(self):
        return {"losses": self.losses, "ends": self.ends}

    def load_state_dict(self, state):
        self.losses, self.ends = state["losses"], state["ends"]


def t2_module(optimizer: str = "adamw"):
    """T2's module itself: a worker unpickles it by import path (the
    subclasses ``train_module`` defines inside a function do not
    pickle)."""
    from ray_lightning_tpu_torch import GPTModule
    from ray_lightning_tpu_torch.models import gpt2_config
    return GPTModule(config=gpt2_config("small", attention_impl="flash"),
                     batch_size=8, seq_len=1024, optimizer=optimizer)


def spawn_card_worker():
    """One spawned worker process that owns the card, for phases D and U
    (``RayLauncher(workers=)``): (``ProcessRay``, workers, spawn s)."""
    from ray_lightning_tpu_torch.launchers import ExecutorBase, ProcessRay
    ray = ProcessRay()
    ray.init()
    t0 = time.perf_counter()
    workers = [ray.remote(ExecutorBase).options(
        construct_timeout=300).remote()]
    return ray, workers, time.perf_counter() - t0


def worker_fit(ray, workers, strategy, module, callbacks, ckpt_path=None,
               **kw):
    """``module`` fit by the card worker: (trainer, fit seconds)."""
    from ray_lightning_tpu_torch import Trainer
    from ray_lightning_tpu_torch.launchers import RayLauncher
    release()
    trainer = Trainer(strategy=strategy, **{
        **dict(max_epochs=1, limit_train_batches=D_STEPS,
               limit_val_batches=0, seed=0), **kw}, callbacks=callbacks)
    trainer._launcher = RayLauncher(strategy, ray_module=ray,
                                    workers=workers)
    t0 = time.perf_counter()
    trainer.fit(module, ckpt_path=ckpt_path)
    return trainer, time.perf_counter() - t0


def worker_launches(m, expect: dict, what: str) -> dict:
    """The flash kernels' launches the worker counted, each all on
    ``tc`` and as many as ``expect`` says."""
    launches = {k: {r: int(m[f"launches/{k}/{r}"]) for r in ("simt", "tc")}
                for k in expect}
    check(launches == {k: {"simt": 0, "tc": v} for k, v in expect.items()},
          f"{what}: worker launches {launches}, want {expect} all on tc")
    return launches


def phase_d_data_parallel(card, t2, o, ray, workers, spawn_s):
    """Data parallelism through the spawned card worker."""
    from ray_lightning_tpu_torch import (FSDPStrategy, HorovodRayStrategy,
                                         RayShardedStrategy, RayStrategy,
                                         Trainer)
    release()
    before = len(multiprocessing.active_children())
    try:
        Trainer(strategy=RayStrategy(num_workers=2), max_steps=1).fit(
            t2_module())
        check(False, "D: RayStrategy(num_workers=2) on one card did not "
              "raise")
    except ValueError as exc:
        refusal = str(exc)
    check(len(multiprocessing.active_children()) == before,
          "D: the refused launch spawned a process")
    n = 12
    expect = {"flash_fwd": n * D_STEPS, "flash_bwd_dkv": n * D_STEPS,
              "flash_bwd_dq": n * D_STEPS}
    res = {"card": card, "refused_two_workers": refusal, "fits": {},
           "spawn_s": spawn_s}
    fits = [(name, cls, "adamw") for name, cls in (
        ("ddp", RayStrategy), ("allreduce", HorovodRayStrategy),
        ("zero", RayShardedStrategy), ("fsdp2", FSDPStrategy))]
    fits += [(name, cls, preset) for name, cls in (
        ("zero", RayShardedStrategy), ("fsdp2", FSDPStrategy))
        for preset in ("adamw_bf16m", "adafactor")]
    for name, cls, preset in fits:
        key = name if preset == "adamw" else f"{name}/{preset}"
        probe = WorkerProbe(time.time())
        trainer, fit_s = worker_fit(ray, workers, cls(num_workers=1),
                                    t2_module(preset), [probe])
        m = trainer.callback_metrics
        launches = worker_launches(m, expect, f"D {key}")
        got = probe.losses
        # AdamW against T2's losses; a preset against phase O's
        want = (t2["losses"] if preset == "adamw"
                else o["presets"][preset]["losses"])[:D_STEPS]
        check(len(got) == D_STEPS and all(np.isfinite(got)),
              f"D {key}: losses {got}")
        bitwise = got == want
        diff = max(abs(a - b) for a, b in zip(got, want))
        if name in ("ddp", "allreduce") or (name == "zero"
                                            and preset != "adamw"):
            check(bitwise, f"D {key}: losses {got} != {want}")
        else:
            check(all(abs(a - b) <= D_LOSS_RTOL * abs(b)
                      for a, b in zip(got, want)),
                  f"D {key}: losses {got} vs {want} past {D_LOSS_RTOL} "
                  "relative")
        opt_bytes = int(m["opt_state_bytes"])
        if preset != "adamw":
            check(opt_bytes == o["presets"][preset]["opt_state_bytes"],
                  f"D {key}: opt_state_bytes {opt_bytes} != phase O's "
                  f"{o['presets'][preset]['opt_state_bytes']}")
        check(trainer.global_step == D_STEPS and
              trainer.train_state_dict is not None,
              f"D {key}: global_step {trainer.global_step}")
        steps = np.diff(probe.ends)[WARMUP_STEPS - 1:]
        res["fits"][key] = dict(
            optimizer=preset, losses=got, bitwise_vs_one_process=bitwise,
            max_loss_diff=diff,
            step_ms_median=1e3 * float(np.median(steps)),
            t2_step_ms_median=t2["step_ms_median"],
            peak_memory_gib=m["peak_memory_gib"], opt_state_bytes=opt_bytes,
            launch_to_fit_start_s=m["launch_to_fit_start_s"],
            fit_s=fit_s, worker_device=m["device"],
            state_stream=trainer.state_stream_stats, launches=launches)
        print(f"phaseD {key}", json.dumps(res["fits"][key]), flush=True)
        del trainer
    print("phaseD data parallel", json.dumps(res), flush=True)
    return res


# -------------------------------------------------------------- phase U
U_STEPS = 2                      # steps an epoch; one validation batch
CKPT_BYTES = 1_493_454_109       # GPT-2-small's AdamW stream (run AN)


class FakeTune:
    """Ray Tune 1.x as a trial's process sees it: ``report(**metrics)``
    and ``checkpoint_dir(step)`` under the trial's directory. Installed
    in this process (the driver) only; the worker has no Tune."""

    def __init__(self, root: str):
        self.root = root
        self.reports, self.dirs = [], []

    def is_session_enabled(self):
        return True

    def report(self, **metrics):
        self.reports.append(dict(metrics))

    @contextlib.contextmanager
    def checkpoint_dir(self, step):
        d = os.path.join(self.root, f"checkpoint_{step:06d}")
        os.makedirs(d, exist_ok=True)
        self.dirs.append(d)
        yield d


class FakeCheckpoint2:
    """Ray 2.x's ``Checkpoint``: the trial's directory copied under
    ``root``, where the fake keeps it (the callback's temporary one goes
    after the report)."""
    root = ""
    kept = 0

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_directory(cls, path: str):
        keep = os.path.join(cls.root, f"checkpoint_{cls.kept:06d}")
        shutil.copytree(path, keep)
        cls.kept += 1
        return cls(keep)

    def to_directory(self):
        return self.path


class FakeTune2:
    """Ray Tune 2.x: ``report(metrics, checkpoint=)``, ``get_context``,
    ``get_checkpoint``."""
    Checkpoint = FakeCheckpoint2

    def __init__(self):
        self.reports = []

    def report(self, metrics, checkpoint=None):
        self.reports.append((dict(metrics), checkpoint))

    def get_context(self):
        return self

    def get_trial_id(self):
        return "trial_0002"

    def get_checkpoint(self):
        done = [c for _m, c in self.reports if c is not None]
        return done[-1] if done else None


class TrialProbe(WorkerProbe):
    """WorkerProbe, and each validation's ``val_loss`` and step as the
    worker saw them at ``on_validation_end`` (sanity checks counted
    apart)."""

    def __init__(self, launched_at: float):
        super().__init__(launched_at)
        self.vals, self.sanity, self.train_losses = [], 0, []

    def on_validation_end(self, trainer, module):
        if trainer.sanity_checking:
            self.sanity += 1
        else:
            self.vals.append((trainer.global_step,
                              float(trainer.callback_metrics["val_loss"])))

    def on_train_epoch_end(self, trainer, module):
        self.train_losses.append(
            float(trainer.callback_metrics["train_loss"]))

    def state_dict(self):
        return {**super().state_dict(), "vals": self.vals,
                "sanity": self.sanity, "train_losses": self.train_losses}

    def load_state_dict(self, state):
        super().load_state_dict(state)
        self.vals, self.sanity = state["vals"], state["sanity"]
        self.train_losses = state["train_losses"]


def deliveries(tune_mod) -> dict:
    """The driver's record of what it delivered to Tune, as seconds."""
    out = {"checkpoints": [], "report_items": []}
    for d in tune_mod.DELIVERIES:
        if d["kind"] == "checkpoint":
            out["checkpoints"].append(dict(
                global_step=d["global_step"], bytes=d["bytes"],
                serialize_s=d["serialize_s"],
                put_to_drained_s=d["delivered_at"] - d["put_at"],
                driver_write_s=d["write_s"],
                hook_to_delivered_s=d["delivered_at"] - d["hooked_at"]))
        else:
            out["report_items"].append(dict(
                global_step=d["global_step"],
                hook_to_delivered_s=d["delivered_at"] - d["hooked_at"]))
    return out


def phase_u_tune(card, ray, workers, spawn_s):
    """A Tune trial on the card, reporting through the session queue."""
    import tempfile
    import ray_lightning_tpu_torch.tune as tm
    from ray_lightning_tpu_torch import (FSDPStrategy, RayStrategy,
                                         Trainer)
    n = 12
    steps = 2 * U_STEPS
    expect = {"flash_fwd": n * (steps + 2 + 1),   # + validation, sanity
              "flash_bwd_dkv": n * steps, "flash_bwd_dq": n * steps}
    root = tempfile.mkdtemp(prefix="chip_smoke_tune-")
    res = {"card": card, "spawn_s": spawn_s}
    trial = dict(max_epochs=2, limit_train_batches=U_STEPS,
                 limit_val_batches=1, num_sanity_val_steps=1)
    saved = tm.tune
    try:
        # trial 1: Ray 1.x's API, DDP, AdamW
        fake = FakeTune(os.path.join(root, "trial1"))
        tm.tune = fake
        tm.DELIVERIES.clear()
        probe = TrialProbe(time.time())
        cb = tm.TuneReportCheckpointCallback(metrics={"loss": "val_loss"},
                                             on="validation_end")
        # and a report alone at each epoch's end: its hook-to-delivery
        # time without a checkpoint beside it
        cb_train = tm.TuneReportCallback(metrics=["train_loss"],
                                         on="train_epoch_end")
        trainer, fit_s = worker_fit(ray, workers, RayStrategy(num_workers=1),
                                    t2_module(), [probe, cb, cb_train],
                                    default_root_dir=root, **trial)
        launches = worker_launches(trainer.callback_metrics, expect, "U")
        reports = [r["loss"] for r in fake.reports if "loss" in r]
        check(probe.sanity == 1 and len(probe.vals) == 2,
              f"U: sanity checks {probe.sanity}, validations {probe.vals}")
        check(reports == [v for _s, v in probe.vals],
              f"U: reports {reports} != the worker's val_loss "
              f"{probe.vals}")
        train_reports = [r["train_loss"] for r in fake.reports
                         if "train_loss" in r]
        check(train_reports == probe.train_losses,
              f"U: train_loss reports {train_reports} != the worker's "
              f"{probe.train_losses}")
        files = [os.path.join(d, "checkpoint") for d in fake.dirs]
        sizes = [os.path.getsize(f) for f in files]
        check(len(files) == 2 and all(
            abs(b - CKPT_BYTES) <= 0.01 * CKPT_BYTES for b in sizes),
            f"U: checkpoint files {files} of {sizes} bytes")
        record = deliveries(tm)
        check([c["global_step"] for c in record["checkpoints"]] == [
            U_STEPS, 2 * U_STEPS] and [r["global_step"] for r in record[
                "report_items"]] == [U_STEPS, 2 * U_STEPS],
            f"U: deliveries {record}")
        res["trial1"] = dict(
            reported_loss=reports, worker_val_loss=probe.vals,
            reported_train_loss=train_reports,
            checkpoint_bytes=sizes, fit_s=fit_s,
            launch_to_fit_start_s=trainer.callback_metrics[
                "launch_to_fit_start_s"], launches=launches, **record)
        print("phaseU trial 1", json.dumps(res["trial1"]), flush=True)
        del trainer

        # resume from the last trial checkpoint vs three epochs whole
        path = tm.resume_ckpt_path(fake.dirs[-1])
        check(path == files[-1], f"U: resume_ckpt_path {path}")
        tm.tune = None      # no Tune session: no queue for these two
        probe_r = TrialProbe(time.time())
        resumed, resumed_s = worker_fit(
            ray, workers, RayStrategy(num_workers=1), t2_module(),
            [probe_r], ckpt_path=path, **{**trial, "max_epochs": 3})
        probe_w = TrialProbe(time.time())
        # the resumed probe starts from the checkpoint's copy of its
        # state, so it holds all three epochs' losses
        whole, whole_s = worker_fit(
            ray, workers, RayStrategy(num_workers=1), t2_module(),
            [probe_w], **{**trial, "max_epochs": 3})
        check(probe_r.losses == probe_w.losses and len(probe_w.losses) == 3
              * U_STEPS, f"U: resumed losses {probe_r.losses} != "
              f"{probe_w.losses}")
        diff = bitwise_diff(resumed.train_state_dict["params"],
                            whole.train_state_dict["params"], "params")
        check(not diff, f"U: resumed params differ from the whole fit's "
              f"at {diff[:5]}")
        res["resume"] = dict(path=path, losses=probe_w.losses,
                             bitwise=True, resumed_fit_s=resumed_s,
                             whole_fit_s=whole_s)
        print("phaseU resume", json.dumps(res["resume"]), flush=True)
        del resumed, whole

        # trial 2: Ray 2.x's API, FSDP2, adafactor
        fake2 = FakeTune2()
        FakeCheckpoint2.root = os.path.join(root, "trial2-kept")
        tm.tune = fake2
        tm.DELIVERIES.clear()
        probe2 = TrialProbe(time.time())
        cb2 = tm.TuneReportCheckpointCallback(metrics={"loss": "val_loss"},
                                              on="validation_end")
        trainer2, fit2_s = worker_fit(
            ray, workers, FSDPStrategy(num_workers=1),
            t2_module("adafactor"), [probe2, cb2],
            default_root_dir=os.path.join(root, "trial2"), **trial)
        launches2 = worker_launches(trainer2.callback_metrics, expect,
                                    "U trial 2")
        check(len(fake2.reports) == 2 and all(
            c is not None for _m, c in fake2.reports)
            and [m["loss"] for m, _c in fake2.reports] == [
                v for _s, v in probe2.vals],
            f"U trial 2: reports {fake2.reports} vs {probe2.vals}")
        path2 = tm.resume_ckpt_path()
        check(path2 is not None, "U trial 2: no checkpoint to resume")
        record2 = deliveries(tm)
        del trainer2
        tm.tune = None
        release()
        one = Trainer(strategy=RayStrategy(num_workers=1), seed=0,
                      limit_val_batches=0, **{
                          k: v for k, v in trial.items()
                          if k not in ("limit_val_batches",
                                       "num_sanity_val_steps")})
        one.fit(t2_module("adafactor"), ckpt_path=path2)
        with open(path2, "rb") as f:
            ckpt = torch.load(f, map_location="cpu", weights_only=True)
        diff = bitwise_diff({k: v.detach().cpu() for k, v in
                             one.model.state_dict().items()},
                            ckpt["state"]["params"], "params")
        check(not diff and one.global_step == 2 * U_STEPS,
              f"U trial 2: the one-process load differs at {diff[:5]}")
        res["trial2"] = dict(
            reported=[m for m, _c in fake2.reports],
            worker_val_loss=probe2.vals, checkpoint=path2,
            checkpoint_bytes=os.path.getsize(path2), fit_s=fit2_s,
            launches=launches2, loads_in_one_process=True, **record2)
        print("phaseU trial 2", json.dumps(res["trial2"]), flush=True)
        del one, ckpt
    finally:
        tm.tune = saved
        shutil.rmtree(root, ignore_errors=True)
        release()
    print("phaseU tune", json.dumps(res), flush=True)
    return res


# -------------------------------------------------------------- phase I
I_STEPS = 8
I_WORKERS, I_DEPTH = 2, 2
I_COUNTED_STEP = 5          # the step whose launches each fit profiles


class IRingModule(GPTModule):
    """T2's module with its training batches from
    ``MultiprocessDataLoader`` (spawned producers: CUDA is live) and
    ``DevicePrefetcher`` (pinned staging, a side stream). Module level:
    the producers' spawn re-imports this script."""

    def train_dataloader(self):
        from ray_lightning_tpu_torch.data import (DevicePrefetcher,
                                                  MultiprocessDataLoader)
        self.ring = MultiprocessDataLoader(
            super().train_dataloader(), num_workers=I_WORKERS,
            auto_fallback=False)
        self.prefetcher = DevicePrefetcher(self.ring, depth=I_DEPTH)
        return self.prefetcher


class IProbe(Callback):
    """Each step's batch on the host and its end time (synchronized),
    and ``torch.profiler``'s records over step I_COUNTED_STEP: from the
    end of the step before it (the next batch's loading and copies
    included) to its own end."""

    def __init__(self):
        self.batches, self.ends, self.prof = [], [], None
        self.window_copies = None

    def on_train_batch_end(self, trainer, pl_module, outputs, batch,
                           batch_idx):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.ends.append(time.perf_counter())
        copies = getattr(getattr(pl_module, "prefetcher", None), "copies",
                         None)
        if batch_idx == I_COUNTED_STEP:
            self.prof.__exit__(None, None, None)
            self.events = self.prof.key_averages()
            self.window_copies = (None if copies is None
                                  else copies - self.window_copies)
        self.batches.append([t.cpu() for t in batch])
        if batch_idx == I_COUNTED_STEP - 1:
            self.window_copies = copies
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()

    def counts(self) -> dict:
        """The counted step's kernel launches and copies: the host's launch
        and copy calls (what the check compares: the profiler drops a
        device record now and then, PERF.md §7), beside the device's
        kernel and host-to-device copy records."""
        from torch.autograd import DeviceType
        dev = [a for a in self.events if a.device_type == DeviceType.CUDA]
        host = {a.key: a.count for a in self.events
                if a.key in G_HOST_LAUNCH_CALLS}
        return dict(
            launch_calls=sum(n for k, n in host.items()
                             if "Launch" in k),
            copy_calls=host.get("cudaMemcpyAsync", 0),
            kernel_records=sum(a.count for a in dev if not a.key.startswith(
                ("Memcpy", "Memset"))),
            h2d_records=sum(a.count for a in dev
                            if a.key.startswith("Memcpy HtoD")),
            prefetcher_copies=self.window_copies)


def i_fit(cls):
    """T2's fit for I_STEPS steps (no validation) with the probe; returns
    the trainer, the module and the probe."""
    from ray_lightning_tpu_torch import Trainer
    from ray_lightning_tpu_torch.models import gpt2_config
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    module = cls(config=gpt2_config("small", attention_impl="flash"),
                 batch_size=8, seq_len=1024)
    probe = IProbe()
    trainer = Trainer(strategy=train_strategy(), max_epochs=1,
                      limit_train_batches=I_STEPS, limit_val_batches=0,
                      seed=0, callbacks=[probe])
    cf.reset_kernel_launches()
    t0 = time.perf_counter()
    trainer.fit(module)
    fit_s = time.perf_counter() - t0
    check(trainer.global_step == I_STEPS,
          f"I: global_step {trainer.global_step} != {I_STEPS}")
    launches = check_flash_launches(f"I {cls.__name__}", I_STEPS)
    return trainer, module, probe, launches, fit_s


def phase_i_input_pipeline(card):
    """T2's configuration fed by two spawned producers through the shared-
    memory ring and the device prefetcher, against the same fit fed
    in-process: every batch equal on the host, the final state bitwise
    equal (the same token batches reach the same deterministic step),
    the counted step's kernel launches and copies equal (the prefetcher's
    copies replace ``_to_device``'s), K2-K4 on ``tc``; step ms of each,
    the producers' start-up seconds and the ring's bytes per second."""
    from ray_lightning_tpu_torch import GPTModule as Plain
    release()
    t_phase = time.perf_counter()
    base, _, bprobe, blaunch, bfit = i_fit(Plain)
    want = host_state(base)
    del base
    release()
    ring_tr, ring_mod, rprobe, rlaunch, rfit = i_fit(IRingModule)
    got = host_state(ring_tr)
    ring, pref = ring_mod.ring, ring_mod.prefetcher
    check(ring.uses_ring and ring.mp_context == "spawn"
          and ring.num_workers == I_WORKERS,
          f"I: the loader ran uses_ring={ring.uses_ring} "
          f"mp_context={ring.mp_context} workers={ring.num_workers}")
    check(len(rprobe.batches) == len(bprobe.batches) == I_STEPS
          and all(torch.equal(a, b) for x, y in zip(rprobe.batches,
                                                    bprobe.batches)
                  for a, b in zip(x, y)),
          "I: the ring's batches differ from the in-process loader's")
    diff = bitwise_diff(got, want)
    check(not diff, f"I: final state differs at {diff[:5]}")
    bc, rc = bprobe.counts(), rprobe.counts()
    check(rc["launch_calls"] == bc["launch_calls"]
          and rc["copy_calls"] == bc["copy_calls"] == 2
          and rc["prefetcher_copies"] == 2,
          f"I: the counted step launched {rc} against in-process {bc}")
    check(rlaunch == blaunch, f"I: flash launches {rlaunch} != {blaunch}")
    stats = dict(ring.stats)
    bstep = 1e3 * float(np.median(np.diff(bprobe.ends)[1:]))
    rstep = 1e3 * float(np.median(np.diff(rprobe.ends)[1:]))
    res = dict(
        steps=I_STEPS, workers=I_WORKERS, depth=I_DEPTH,
        mp_context=ring.mp_context, uses_ring=ring.uses_ring,
        final_state_bitwise=True, batches_equal=True,
        counted_step_in_process=bc, counted_step_ring=rc,
        flash_launches=rlaunch, step_ms_in_process=bstep,
        step_ms_ring=rstep, fit_s_in_process=bfit, fit_s_ring=rfit,
        producers_first_batch_s=stats["first_batch_s"],
        ring_bytes=stats["bytes"], ring_batches=stats["batches"],
        ring_pop_s=stats["pop_s"],
        ring_bytes_per_s=stats["bytes"] / stats["pop_s"],
        prefetcher_copies=pref.copies, prefetcher_bytes=pref.bytes,
        card=card)
    print("phaseI input pipeline", json.dumps(res), flush=True)
    del ring_tr, ring_mod, got, want
    release()
    print(f"phaseI took {time.perf_counter() - t_phase:.1f} s", flush=True)
    res["launches"] = {k: blaunch[k] + rlaunch[k] for k in blaunch}
    return res


# -------------------------------------------------------------- phase N
N_LAYOUT = dict(num_slots=8, prefill_len=128, page_size=16, num_pages=512,
                page_native=True, attention_kernel="cuda")
N_REPLICAS, N_STANDBY = 2, 1
# (b): the serve.replica firing that kills a replica -- replica turns are
# counted in tick order, two a tick: fire 5 is tick 2's second turn,
# replica 1 decoding its 4 rows while replica 0 decodes its 4
N_KILL = 5


def n_drive(obj, trace):
    """``obj.serve_trace(trace)`` (a fleet or a client) with the wall
    time of every tick; returns the completions, the serve seconds and
    the tick seconds."""
    ticks = []
    tick = obj.tick

    def timed():
        t0 = time.perf_counter()
        out = tick()                 # every dispatch ends in a host copy
        ticks.append(time.perf_counter() - t0)
        return out

    obj.tick = timed
    t0 = time.perf_counter()
    done = obj.serve_trace(list(trace))
    return done, time.perf_counter() - t0, ticks


def n_rates(done, serve_s, ticks):
    tokens = sum(len(c.tokens) for c in done.values())
    return dict(tokens=tokens, serve_s=serve_s,
                tokens_per_s=tokens / serve_s, ticks=len(ticks),
                tick_ms_median=1e3 * statistics.median(ticks))


def n_fleet(proto, sd, telemetry=None, **kw):
    from ray_lightning_tpu_torch.serve import ReplicaFleet
    return ReplicaFleet(proto, sd, num_replicas=N_REPLICAS,
                        num_standby=N_STANDBY, telemetry=telemetry,
                        device=DEVICE, **dict(N_LAYOUT, **kw))


def n_routes(fleet):
    """Record each admission's replica: ``{request id: replica id}``."""
    routes = {}
    note = fleet.router.note_admission

    def noting(rep, req, load, affine):
        routes[req.id] = (rep.id, affine)
        return note(rep, req, load=load, affine=affine)

    fleet.router.note_admission = noting
    return routes


def n_join_refill(fleet):
    thread = fleet.standby._refill_thread if fleet.standby else None
    if thread is not None:
        thread.join(timeout=120)


# what the allocator may hold outside any tensor (workspaces a library
# allocates per thread and stream) between two reads of N (b): far below
# one replica's ~1.1 GB (f32)
N_ALLOCATOR_SLACK = 64 << 20


def n_allocated() -> dict:
    """The card's allocated bytes, and the bytes of the distinct device
    storages that the process's live tensors hold (after a collection):
    what the replicas own. The allocator also holds a few MB outside any
    tensor, an amount that moved by -2.8 to +5.2 MB between the two reads
    of N (b) as threads built clients."""
    import warnings
    gc.collect()
    torch.cuda.synchronize()
    storages = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                st = obj.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
    return dict(allocated=torch.cuda.memory_allocated(),
                tensors=sum(storages.values()))


def n_bf16(cfg, sd, trace, served, card, out):
    """(a) bf16, 2 replicas and a warm standby, phase 2's trace: where
    each request went, the fleet's tokens/s and ms a fleet tick beside a
    single client of the same layout (and phase 2's), device bytes a
    replica."""
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.serve import ServeClient
    proto = TransformerLM(cfg, device="meta")
    client = ServeClient(proto, sd, device=DEVICE, **N_LAYOUT)
    client.serve_trace(WARM)
    client.shutdown()
    client = ServeClient(proto, sd, device=DEVICE, **N_LAYOUT)
    single = n_rates(*n_drive(client, trace))
    single_tokens = {r: c.tokens for r, c in client.completions.items()}
    client.shutdown()
    del client
    before = n_allocated()["allocated"]
    fleet = n_fleet(proto, sd)
    built = n_allocated()["allocated"] - before
    routes = n_routes(fleet)
    p_reset()
    done, serve_s, ticks = n_drive(fleet, trace)
    add_launches(out["launches"], p_launches())
    check_completions(done, trace, cfg.vocab_size, "N (a)")
    eng = fleet._replicas[0].client.engine
    per = {}
    for rid, (rep, _aff) in routes.items():
        per[rep] = per.get(rep, 0) + 1
    check(len(per) == N_REPLICAS, f"N (a): requests per replica {per}")
    same = sum(done[r].tokens == t for r, t in single_tokens.items())
    res = dict(
        requests_per_replica=per, fleet=n_rates(done, serve_s, ticks),
        single_client=single,
        equal_to_single_client=f"{same}/{len(done)}",
        phase2_decode_tokens_per_s=served["bf16"]["decode_tokens_per_s"],
        phase2_step_ms_median=served["bf16"]["step_ms_median"],
        # each request's arrival, seconds from the run's start (the
        # fleet admits a request due at tick t once t ticks are done):
        # phase X (a) offers the process fleet the same wall-clock load
        arrival_s=[sum(ticks[:t]) for t, _kw in trace],
        device_bytes_fleet=built,
        device_bytes_per_client=built / (N_REPLICAS + N_STANDBY),
        param_bytes_per_replica=eng.param_bytes(),
        kv_bytes_per_replica=storage_bytes(eng), card=card)
    fleet.shutdown()
    print("phaseN (a)", json.dumps(res), flush=True)
    out["runs"]["a"] = res


def n_failover(cfg, sd, trace, card, out, root):
    """(b) f32: one serve.replica raise while 8 rows decode (4 on the
    victim): every token equals the fault-free single client's;
    failover -> replay -> promoted in order; the card's allocated bytes
    once the promoted replica has dispatched and the pool has refilled
    equal those at the crash; ms a failover; request traces exact on
    the tick clock; the fleet's Chrome trace written."""
    from ray_lightning_tpu_torch.obs import Telemetry
    from ray_lightning_tpu_torch.reliability import FaultPlan
    from ray_lightning_tpu_torch.serve import ServeClient
    p32 = f_models(cfg, torch.float32)
    client = ServeClient(p32, sd, device=DEVICE, **N_LAYOUT)
    ref = {r: c.tokens for r, c in client.serve_trace(list(trace)).items()}
    client.shutdown()
    del client
    gc.collect()
    tel = Telemetry()
    fleet = n_fleet(p32, sd, telemetry=tel)
    rec = {}
    fail = fleet._fail_replica

    def failing(rep, *, dead):
        rec["rows"] = sum(r.client.engine.active_count
                          for r in fleet._replicas)
        rec["victim_rows"] = rep.client.engine.active_count
        rec["at_crash"] = n_allocated()
        rec["tick"] = fleet.ops
        done = fail(rep, dead=dead)
        rec["promoted"] = fleet._replicas[-1].client.engine
        return done

    fleet._fail_replica = failing
    tick = fleet.tick

    def measuring():
        # the bytes once the tick holding the failover has ended (the
        # dead replica released, the refill joined), and once the
        # promoted replica has decoded: an engine keeps a few device
        # buffers of its last dispatches, so only then does it hold what
        # the dead one held
        got = tick()
        if "tick" in rec and "after" not in rec:
            n_join_refill(fleet)
            rec["after"] = n_allocated()
        elif ("promoted" in rec and "decoded" not in rec
                and rec["promoted"].decode_substeps > 0):
            rec["decoded"] = n_allocated()
            rec["decoded_tick"] = fleet.ops
            del rec["promoted"]
        return got

    fleet.tick = measuring
    p_reset()
    plan = FaultPlan.at("serve.replica", [N_KILL])
    with tel.activated(), plan.armed():
        done = fleet.serve_trace(list(trace))
    add_launches(out["launches"], p_launches())
    check(plan.fired == 1 and fleet.failovers == 1,
          f"N (b): fired {plan.fired}, failovers {fleet.failovers}")
    check(rec["rows"] == 8 and rec["victim_rows"] == 4,
          f"N (b): the kill saw {rec['rows']} rows in flight, "
          f"{rec['victim_rows']} on the victim")
    got = {r: c.tokens for r, c in done.items()}
    differ = [r for r in ref if got.get(r) != ref[r]]
    check(not differ and got.keys() == ref.keys(), "N (b): the fleet's "
          f"tokens differ from the fault-free single client's at {differ}")
    sites = [e.site for e in tel.events()
             if e.site in ("fleet.failover", "recovery.replay",
                           "fleet.replica_promoted")]
    replays = sites.count("recovery.replay")
    check(sites == ["fleet.failover"] + ["recovery.replay"] * replays
          + ["fleet.replica_promoted"] and replays == 4,
          f"N (b): events {sites}")
    crash, decoded = rec["at_crash"], rec["decoded"]
    check(decoded["tensors"] == crash["tensors"]
          and abs(decoded["allocated"] - crash["allocated"])
          < N_ALLOCATOR_SLACK,
          f"N (b): the card's bytes {decoded} once the promoted replica "
          f"decoded, {crash} at the crash ({rec['after']} after the "
          "failover's tick)")
    traces = fleet.request_traces()
    check(sorted(traces) == sorted(done), "N (b): a request has no trace")
    for rid, tr in traces.items():
        segs = tr.segments
        check(segs[0].start == tr.arrival and segs[-1].end == tr.retired
              and all(a.end == b.start for a, b in zip(segs, segs[1:]))
              and sum(s.dur for s in segs) == tr.total
              and float(tr.total).is_integer()
              and tr.tokens == len(done[rid].tokens),
              f"N (b): request {rid}'s trace does not telescope: {tr}")
    moved = sorted(r for r, tr in traces.items() if tr.resubmits)
    check(len(moved) == 4 and all(
        "failover" in [s.label for s in traces[r].segments] for r in moved),
        f"N (b): displaced traces {moved}")
    path = os.path.join(root, "fleet_trace.json")
    fleet.export_fleet_trace(path)
    with open(path) as f:
        doc = json.load(f)
    check({e["pid"] for e in doc["traceEvents"]} >= {0, 1},
          "N (b): the Chrome trace has no replica tracks")
    res = dict(
        kill_tick=rec["tick"], rows_in_flight=rec["rows"],
        victim_rows=rec["victim_rows"], tokens_equal_single_client=True,
        replays=replays, failover_ms=1e3 * fleet.failover_s_total,
        bytes_at_crash=rec["at_crash"],
        bytes_after_failover_tick=rec["after"],
        bytes_once_promoted_decoded=rec["decoded"],
        promoted_decoded_at_tick=rec["decoded_tick"],
        promoted=[e.payload for e in tel.events("fleet.replica_promoted")],
        trace_bytes=os.path.getsize(path),
        trace_events=len(doc["traceEvents"]),
        displaced=moved, card=card)
    fleet.shutdown()
    print("phaseN (b)", json.dumps(res), flush=True)
    out["runs"]["b"] = res


def n_int8(cfg, sd, trace, card, out):
    """(c) int8 weights on K5 (bf16 x) on 2 replicas: every replica's
    codes and scales byte-equal, K5 on the GEMVs at decode and on
    ``tc`` at prefill."""
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm
    proto = TransformerLM(cfg, device="meta")
    fleet = n_fleet(proto, sd, weight_dtype="int8", matmul_kernel="cuda")
    reps = [r.client.engine.model.named_weights()
            for r in fleet._replicas]
    if fleet.standby is not None:
        reps.append(fleet.standby._idle[0][0].engine.model.named_weights())
    names = sorted(reps[0])
    quantized = [n for n in names if hasattr(reps[0][n], "q")]
    check(quantized and all(
        sorted(w) == names and all(
            torch.equal(w[n].q, reps[0][n].q)
            and torch.equal(w[n].scale, reps[0][n].scale)
            if n in quantized else torch.equal(w[n], reps[0][n])
            for n in names) for w in reps[1:]),
        "N (c): the replicas' quantized weights differ")
    p_reset()
    done, serve_s, ticks = n_drive(fleet, trace)
    launches = p_launches()
    add_launches(out["launches"], launches)
    check_completions(done, trace, cfg.vocab_size, "N (c)")
    k5 = launches["k5"]
    check(k5["gemv_dense"] > 0 and k5["gemv_attend"] > 0 and k5["tc"] > 0
          and k5["tiled_f32"] == 0, f"N (c): K5 routes {k5}")
    res = dict(replicas=len(reps), quantized_leaves=len(quantized),
               codes_equal=True, k5_routes=k5,
               param_bytes_per_replica=fleet._replicas[0].client.engine
               .param_bytes(), **n_rates(done, serve_s, ticks), card=card)
    fleet.shutdown()
    print("phaseN (c)", json.dumps(res), flush=True)
    out["runs"]["c"] = res
    out["k5"] = k5


def n_affinity(cfg, sd, rng_trace, long_prompts, card, out):
    """(d) phase L's layout and trace (chunks of 128, the prefix cache)
    on 2 replicas with prefix affinity: where the 8 shared-prefix
    requests land, the hit rate and pages saved beside phase L's single
    client, K2 on the chunks (``tc``)."""
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.serve import ReplicaFleet
    trace, kinds = rng_trace
    proto = TransformerLM(cfg, device="meta")
    fleet = ReplicaFleet(proto, sd, num_replicas=N_REPLICAS,
                         device=DEVICE, attention_kernel="cuda",
                         **L_SERVE)
    check(fleet.router.affinity_tokens == L_CHUNK,
          f"N (d): affinity over {fleet.router.affinity_tokens} tokens")
    routes = n_routes(fleet)
    p_reset()
    done, serve_s, ticks = n_drive(fleet, trace)
    launches = p_launches()
    add_launches(out["launches"], launches)
    check_completions(done, trace, cfg.vocab_size, "N (d)")
    shared = sorted(r for r, k in enumerate(kinds) if k == "shared")
    homes = {routes[r][0] for r in shared}
    check(len(homes) == 1 and all(routes[r][1] for r in shared[1:]),
          f"N (d): the shared-prefix requests landed on {routes}")
    engines = [r.client.engine for r in fleet._replicas]
    chunks = sum(e.chunk_dispatches for e in engines)
    k2 = launches["k2"]
    check(k2 == {"simt": 0, "tc": cfg.n_layers * chunks},
          f"N (d): K2 routes {k2} for {chunks} chunks")
    hits = sum(e.prefix.hits for e in engines)
    single = long_prompts["runs"]["bf16"]
    check(hits > 0, "N (d): no prefix hits")
    res = dict(
        shared_requests=shared, shared_home=sorted(homes)[0],
        routes={r: routes[r][0] for r in sorted(routes)},
        affinity_hits=fleet.router.affinity_hits,
        pages_saved=hits,
        prefix_hit_rate=[e.prefix.hit_rate for e in engines],
        single_client_pages_saved=single["pages_saved"],
        single_client_hit_rate=single["prefix_hit_rate"],
        chunk_dispatches=chunks, k2_routes=k2,
        **n_rates(done, serve_s, ticks), card=card)
    fleet.shutdown()
    print("phaseN (d)", json.dumps(res), flush=True)
    out["runs"]["d"] = res
    out["k2_chunk_tc"] = k2["tc"]


def phase_n_fleet(cfg, sd, trace, served, long_trace, long_prompts, card):
    """The in-process replica fleet at GPT-2-small width, page-native with
    the kernels on: (a) bf16 spread over 2 replicas, (b) an f32 failover,
    (c) int8 weights on K5, (d) prefix affinity on phase L's trace."""
    import tempfile
    t_phase = time.perf_counter()
    out = {"runs": {}, "launches": {}}
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet-")
    try:
        n_bf16(cfg, sd, trace, served, card, out)
        n_failover(cfg, sd, trace, card, out, root)
        n_int8(cfg, sd, trace, card, out)
        n_affinity(cfg, sd, long_trace, long_prompts, card, out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phaseN took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# -------------------------------------------------------------- phase X
X_REPLICAS = 2
# what may stay missing from the card's free memory once a worker is
# reaped, against what it took when it spawned, and once the fleet is
# shut down, against before it: the survivors' allocators grow as they
# serve (a worker holds ~1.2-1.8 GB)
X_MEM_SLACK = 256 << 20
# (c)'s containment settings, as tests/test_fleet_process.py's
# test_process_poison_contained_exact_implication configures them
X_POISON_CONFIG = dict(max_request_failovers=3, probation_after=2)


def x_free() -> int:
    """The card's free bytes (every process's allocations count)."""
    torch.cuda.synchronize()
    return torch.cuda.mem_get_info()[0]


def x_wall(fleet, trace, tick_s):
    """Phase 2's trace on the wall clock the process fleet runs on, from
    now on: a request due at tick t arrives t x ``tick_s`` seconds from
    now (the fleet's trace times count from its construction)."""
    now = fleet.now()
    return [(now + t * tick_s, kw) for t, kw in trace]


def x_descendants():
    """Every live process under this one (zombies left out), read from
    /proc: pid, parent pid, command line, and whether it holds the card
    (an open ``/dev/nvidia<N>``: a CUDA context). The fork server and
    the resource tracker it started serve until this process exits."""
    procs = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()
        except OSError:
            continue
        if state not in "ZX":
            procs[int(d)] = (int(ppid), cmd)
    mine, frontier = {}, {os.getpid()}
    while frontier:
        frontier = {p for p, (pp, _c) in procs.items()
                    if pp in frontier and p not in mine}
        mine.update((p, procs[p]) for p in frontier)
    out = []
    for pid, (ppid, cmd) in sorted(mine.items()):
        try:
            fds = [os.readlink(f"/proc/{pid}/fd/{fd}")
                   for fd in os.listdir(f"/proc/{pid}/fd")]
        except OSError:
            fds = []
        kind = ("fork server" if "multiprocessing.forkserver" in cmd
                else "resource tracker"
                if "multiprocessing.resource_tracker" in cmd else "other")
        out.append(dict(pid=pid, ppid=ppid, kind=kind, cmd=cmd[:200],
                        card=any(re.fullmatch(r"/dev/nvidia\d+", f)
                                 for f in fds)))
    return out


def x_left_over(what):
    """Check that only the fork server and its resource tracker are left
    under this process, neither holding the card."""
    left = x_descendants()
    print(f"{what} processes left", json.dumps(left), flush=True)
    check(all(p["kind"] != "other" and not p["card"] for p in left),
          f"{what}: processes left under the script: {left}")
    return left


def x_at(fleet, trace, arrival_s):
    """``trace``'s requests arriving ``arrival_s`` seconds from now."""
    now = fleet.now()
    return [(now + a, kw) for a, (_t, kw) in zip(arrival_s, trace)]


@contextlib.contextmanager
def x_spawns(rec):
    """Record every worker a process fleet spawns while this is open
    (construction, standby refills, cold rebuilds): the card's free
    bytes before and after its construction (what it took) and the
    seconds from its spawn to the end of its ``set_replica`` (a
    standby's until its promotion)."""
    from ray_lightning_tpu_torch.serve.process_fleet import \
        ProcessReplicaFleet as PF
    spawn, activate = PF._spawn_actor, PF._activate

    def spawning(self):
        free, t0 = x_free(), time.perf_counter()
        handle = spawn(self)
        rec[id(handle)] = dict(t0=t0, free_before=free,
                               bytes=free - x_free(), pid=handle._proc.pid,
                               construct_s=time.perf_counter() - t0)
        return handle

    def activating(self, handle):
        rep = activate(self, handle)
        got = rec[id(handle)]
        got.update(replica=rep.id,
                   spawn_to_set_replica_s=time.perf_counter() - got["t0"])
        return rep

    PF._spawn_actor, PF._activate = spawning, activating
    try:
        yield rec
    finally:
        PF._spawn_actor, PF._activate = spawn, activate


def x_fleet(proto, sd, **kw):
    """A process fleet on the card, phase N's layout (build it inside
    ``x_spawns``); standby refills run on the calling thread, inside
    the failover (a background spawn would land its bytes inside
    another measurement)."""
    from ray_lightning_tpu_torch.serve import ReplicaFleet
    fleet = ReplicaFleet(proto, sd, backend="process",
                         num_replicas=X_REPLICAS, device=DEVICE,
                         **dict(N_LAYOUT, **kw))
    if fleet.standby is not None:
        fleet.standby.refill_async = fleet.standby.fill
    return fleet


def x_watch(fleet, rec, fos, reaps, killed=None):
    """Wrap ``_fail_replica`` and the kill inside it. Per failover: the
    replica, its crash message and implicated ids (``MSG_CRASH``; None
    after a messageless death), its ms and its re-admissions' ms, and,
    when ``killed`` holds the perf-counter time ``"t"`` of a kill from
    outside, the ms from it to the first failover's start (the verdict)
    and to its last re-admission; the verdicts themselves are the fleet's
    ``replica.dead``/``replica.error`` events. Per reap: after the kill,
    wait (5 s at most) for the card's free memory to take back what the
    worker took at its spawn, and record the bytes freed against the
    free memory just before the kill (``killed["free"]`` for a kill from
    outside: the process may be gone before its failover starts)."""
    fail, kill, readmit = (fleet._fail_replica, fleet._ray.kill,
                           fleet._readmit)
    killed = {} if killed is None else killed
    reaping, readmitted = [], {}

    def readmitting(req, toks):
        got = readmit(req, toks)
        readmitted["t"] = time.perf_counter()
        return got

    def killing(actor, no_restart=False):
        if not reaping:
            return kill(actor, no_restart=no_restart)
        before, t0 = killed.pop("free", None), time.perf_counter()
        if before is None:
            before = x_free()
        kill(actor, no_restart=no_restart)
        took = next(r["bytes"] for r in rec.values()
                    if r["pid"] == actor._proc.pid)
        while True:
            freed = x_free() - before
            if freed >= took - X_MEM_SLACK or \
                    time.perf_counter() - t0 > 5:
                break
            time.sleep(0.01)
        reaps.append(dict(pid=actor._proc.pid,
                          exitcode=actor._proc.exitcode,
                          took_at_spawn=took, freed=freed,
                          reap_ms=1e3 * (time.perf_counter() - t0)))

    def failing(rep):
        t0 = time.perf_counter()
        reaping.append(rep)
        readmitted.clear()
        try:
            done = fail(rep)
        finally:
            reaping.clear()
        t1 = time.perf_counter()
        t_re = readmitted.get("t", t0)
        # the failover's ms include the standby's refill (a spawn, on
        # this thread: x_fleet), the re-admissions' do not
        got = dict(replica=rep.id, crash_msg=rep.crash_msg,
                   implicated=rep.crash_implicated,
                   readmissions_ms=1e3 * (t_re - t0),
                   failover_ms=1e3 * (t1 - t0))
        if "t" in killed and "verdict_ms" not in killed:
            killed["verdict_ms"] = got["kill_to_verdict_ms"] = \
                1e3 * (t0 - killed["t"])
            got["kill_to_readmitted_ms"] = 1e3 * (t_re - killed["t"])
        fos.append(got)
        return done

    fleet._ray.kill = killing
    fleet._fail_replica = failing
    fleet._readmit = readmitting


def x_launch_counts(fleet):
    """Each live replica's K1 launches and decode steps so far, read in
    its worker (``ServeReplicaWorker.launch_counts``)."""
    return {rep.id: fleet._ray.get(rep.actor.launch_counts.remote(),
                                   timeout=30)
            for rep in fleet._replicas}


def x_worker_launches(fleet, cfg, what, decoded=True, base=None):
    """K1's launches the workers that stopped gracefully report, less
    ``base``'s (``x_launch_counts`` after a warm-up), each held to
    n_layers per decode step (one engine a process); with ``decoded``,
    at least one of them must have decoded (in (c) the replica that
    served the probation runs may be the last to crash, and a crashed
    worker reports nothing)."""
    k1 = steps = 0
    for rid, st in sorted(fleet.final_stats.items()):
        b = (base or {}).get(rid, {"kernel_launches": {"paged_attention":
                                                       {}},
                                   "decode_steps": 0})
        was = b["kernel_launches"]["paged_attention"]
        n = {t: c - was.get(t, 0) for t, c in st["kernel_launches"][
            "paged_attention"].items() if c - was.get(t, 0)}
        st = dict(st, decode_steps=st["decode_steps"] - b["decode_steps"])
        check(set(n) <= {1} and n.get(1, 0) == cfg.n_layers
              * st["decode_steps"], f"{what}: replica {rid} launched K1 "
              f"{n} in {st['decode_steps']} decode steps")
        k1 += n.get(1, 0)
        steps += st["decode_steps"]
    check(steps > 0 or not decoded,
          f"{what}: no worker reported a decode step")
    return dict(k1_launches=k1, decode_steps=steps,
                workers_reporting=len(fleet.final_stats))


def x_shutdown(fleet, free_before, what):
    """Shut the fleet down: no live worker, the card's free memory back
    to what it was before the fleet."""
    backend = fleet.process_backend
    fleet.shutdown()
    deadline = time.perf_counter() + 5
    while x_free() < free_before - X_MEM_SLACK and \
            time.perf_counter() < deadline:
        time.sleep(0.01)
    after = x_free()
    check(backend.live_actor_count() == 0, f"{what}: a worker outlived "
          "the fleet")
    check(after >= free_before - X_MEM_SLACK, f"{what}: the card's free "
          f"memory {after} after shutdown, {free_before} before the fleet")
    return dict(free_before_fleet=free_before, free_after_shutdown=after)


def x_single_f32(cfg, sd, trace):
    """The fault-free f32 single client's tokens on ``trace``."""
    from ray_lightning_tpu_torch.serve import ServeClient
    client = ServeClient(f_models(cfg, torch.float32), sd, device=DEVICE,
                         **N_LAYOUT)
    done = client.serve_trace(list(trace))
    client.shutdown()
    return {r: c.tokens for r, c in done.items()}


def x_bf16(cfg, sd, trace, served, fleet_n, card, out):
    """(a) bf16, 2 worker processes, phase 2's trace arriving on the wall
    clock as it arrived at phase N (a)'s in-process fleet (the same
    offered load): requests per replica, each worker's spawn seconds
    and bytes, the fleet's tokens/s and ms a pump tick beside phase 2's
    single client and phase N (a)'s in-process fleet. K1's launches are
    the trace's alone: each worker's counts after the warm-up are taken
    off its final ones."""
    from ray_lightning_tpu_torch.models import TransformerLM
    proto = TransformerLM(cfg, device="meta")
    n_a = fleet_n["runs"]["a"]
    free0, spawns = x_free(), {}
    with x_spawns(spawns):
        fleet = x_fleet(proto, sd)
        # each worker's first dispatches load the CUDA modules, cuBLAS
        # and the kernels (the in-process clients are warm): a greedy
        # and a sampled request on each first
        fleet.serve_trace(x_wall(fleet, WARM[:1] * 2 + WARM[1:] * 2, 0.0))
        warm = x_launch_counts(fleet)
        routes = n_routes(fleet)
        done, serve_s, ticks = n_drive(fleet, x_at(fleet, trace,
                                                   n_a["arrival_s"]))
        mem = x_shutdown(fleet, free0, "X (a)")
    done = {r - len(WARM) * 2: c for r, c in done.items()
            if r >= len(WARM) * 2}
    check_completions(done, trace, cfg.vocab_size, "X (a)")
    per = {}
    for rep, _aff in routes.values():
        per[rep] = per.get(rep, 0) + 1
    check(len(per) == X_REPLICAS, f"X (a): requests per replica {per}")
    rates = n_rates(done, serve_s, ticks)
    res = dict(
        requests_per_replica=per, arrival_s=n_a["arrival_s"],
        workers=[{k: w[k] for k in ("replica", "spawn_to_set_replica_s",
                                    "construct_s", "bytes")}
                 for w in spawns.values()],
        fleet=rates, **x_worker_launches(fleet, cfg, "X (a)", base=warm),
        single_client_decode_tokens_per_s=served["bf16"][
            "decode_tokens_per_s"],
        single_client_step_ms_median=served["bf16"]["step_ms_median"],
        inproc_fleet=n_a["fleet"], inproc_single_client=n_a["single_client"],
        tokens_per_s_vs_inproc_fleet=rates["tokens_per_s"]
        / n_a["fleet"]["tokens_per_s"],
        tokens_per_s_vs_inproc_single_client=rates["tokens_per_s"]
        / n_a["single_client"]["tokens_per_s"], **mem, card=card)
    print("phaseX (a)", json.dumps(res), flush=True)
    out["runs"]["a"] = res
    out["k1"] += res["k1_launches"]


def x_f32(cfg, sd, trace, served, card, out):
    """(b) and (c) on one f32 fleet of 2 workers and a warm standby under
    ``FleetConfig(max_request_failovers=3, probation_after=2)``: the
    kill -9 first, then the poison request once it has been served. No
    worker is alive after its shutdown and the free memory is back."""
    from ray_lightning_tpu_torch.obs import Telemetry
    from ray_lightning_tpu_torch.serve import FleetConfig
    tick_s = served["bf16"]["step_ms_median"] / 1e3
    # (c) seeds the trace's requests explicitly with their (b) ids, the
    # default seeds: one fault-free run is the reference of both
    seeded = [(t, dict(kw, seed=i)) for i, (t, kw) in enumerate(trace)]
    ref = x_single_f32(cfg, sd, seeded)
    tel = Telemetry()
    free0, spawns, reaps, fos, killed = x_free(), {}, [], [], {}
    with x_spawns(spawns):
        t0 = time.perf_counter()
        fleet = x_fleet(f_models(cfg, torch.float32), sd, telemetry=tel,
                        num_standby=1,
                        fleet_config=FleetConfig(**X_POISON_CONFIG))
        built_s = time.perf_counter() - t0
        x_watch(fleet, spawns, fos, reaps, killed)
        x_kill(fleet, trace, tick_s, ref, tel, fos, reaps, killed, card,
               out)
        x_poison(cfg, fleet, seeded, tick_s, ref, tel, fos, reaps, card,
                 out)
        mem = x_shutdown(fleet, free0, "X (b), (c)")
    res = dict(fleet_built_s=built_s, workers=[
        {k: w.get(k) for k in ("replica", "spawn_to_set_replica_s",
                               "construct_s", "bytes")}
        for w in spawns.values()],
        **x_worker_launches(fleet, cfg, "X (b), (c)", decoded=False),
        **mem, card=card)
    print("phaseX (b), (c)", json.dumps(res), flush=True)
    out["runs"]["f32"] = res
    out["k1"] += res["k1_launches"]


def x_kill(fleet, trace, tick_s, ref, tel, fos, reaps, killed, card, out):
    """(b) ``inject("exit")`` into replica 0 once rows of both replicas
    have flushed tokens (its process dies at once, a kill -9 from
    inside): every token equal to the fault-free f32 single client's,
    sampled rows included, verdict ``replica.dead``, the card's free
    memory back after the reap; ms from the kill to the verdict and to
    the re-admissions."""
    tick, seen = fleet.tick, {}

    def killing():
        got = tick()
        if "t" in killed:
            return got
        rows = {}
        for t in fleet._inflight.values():
            if t.tokens:
                rows.setdefault(t.replica, []).append(
                    (t.req.id, t.req.prompt_len, len(t.tokens)))
        if len(rows) == X_REPLICAS:
            victim = fleet._replicas[0]
            seen.update(victim=victim.id, rows_with_tokens=rows)
            killed.update(free=x_free(), t=time.perf_counter())
            victim.actor.inject.remote("exit")
        return got

    fleet.tick = killing
    done = fleet.serve_trace(x_wall(fleet, trace, tick_s))
    fleet.tick = tick
    got = {r: c.tokens for r, c in done.items()}
    differ = [r for r in ref if got.get(r) != ref[r]]
    check("t" in killed and not differ and got.keys() == ref.keys(),
          f"X (b): tokens differ from the fault-free single client's at "
          f"{differ} (kill sent: {'t' in killed})")
    dead = [e.payload["replica"] for e in tel.events("replica.dead")]
    check(fleet.failovers == 1 and dead == [seen["victim"]]
          and not tel.events("replica.error"),
          f"X (b): failovers {fos}, replica.dead {dead}")
    check(len(reaps) == 1 and reaps[0]["freed"]
          >= reaps[0]["took_at_spawn"] - X_MEM_SLACK,
          f"X (b): reaps {reaps}")
    res = dict(**seen, failover=fos[0], reap=reaps[0],
               readmitted=fleet.readmitted,
               replays=len(tel.events("recovery.replay")),
               promoted=[e.payload for e in tel.events(
                   "fleet.replica_promoted")],
               tokens_equal_single_client=True, card=card)
    print("phaseX (b)", json.dumps(res), flush=True)
    out["runs"]["b"] = res


def x_poison(cfg, fleet, seeded, tick_s, ref, tel, fos, reaps, card, out):
    """(c) then, on the same fleet: phase 2's trace with explicit seeds
    after one request at t = 0 whose prompt holds an id >= vocab_size.
    Its embedding gather trips a device-side assert, a sticky CUDA
    error, in every worker that seats it: the request retires
    ``failed`` (``poison_failed == 1``), every other request's tokens
    equal the fault-free single client's, every crash message names a
    CUDA error and every crashed worker held the poison row, the card's
    free memory comes back after each reap."""
    first_fo, first_reap = len(fos), len(reaps)
    failovers0 = fleet.failovers
    errors0 = len(tel.events("replica.error"))
    poison_kw = dict(prompt=[7, cfg.vocab_size + 11, 3, 5],
                     max_new_tokens=8, seed=len(seeded))
    # the poison comes first (the others keep their order and, by their
    # explicit seeds, their streams): it crashes its replicas at their
    # first prefills, while the rows beside it hold few tokens and the
    # trace's 128-token prompt has not arrived (a crashed row re-feeds
    # prompt and tokens through one 128-token prefill, or fails)
    poison_id = fleet._next_id
    index = {poison_id + 1 + i: i for i in range(len(seeded))}
    t0 = time.perf_counter()
    done = fleet.serve_trace(x_wall(fleet, [(0, poison_kw)] + seeded,
                                    tick_s))
    episode_s = time.perf_counter() - t0
    fos, reaps = fos[first_fo:], reaps[first_reap:]
    check(done[poison_id].finish_reason == "failed"
          and fleet.poison_failed == 1,
          f"X (c): the poison request finished "
          f"{done[poison_id].finish_reason}, poison_failed "
          f"{fleet.poison_failed}")
    differ = [(i, done[fid].finish_reason) for fid, i in index.items()
              if done[fid].tokens != ref[i]]
    check(not differ, f"X (c): tokens differ from the fault-free single "
          f"client's at trace rows (row, finish) {differ}")
    errors = [(e.payload["replica"], e.payload["detail"])
              for e in tel.events("replica.error")][errors0:]
    check(fos and fleet.failovers - failovers0 == len(fos)
          <= X_POISON_CONFIG["max_request_failovers"]
          and len(errors) == len(fos) and len(tel.events("replica.dead")) == 1
          and all("CUDA error" in d for _, d in errors)
          and all(poison_id in (f["implicated"] or ()) for f in fos),
          f"X (c): failovers {fos}, replica.error {errors}")
    check(len(reaps) == len(fos) and all(
        r["freed"] >= r["took_at_spawn"] - X_MEM_SLACK for r in reaps),
        f"X (c): reaps {reaps}")
    res = dict(
        poison_id=poison_id, failovers=len(fos), failover_log=fos,
        reaps=reaps, poison_failed=fleet.poison_failed,
        probation=[e.payload for e in tel.events("fleet.probation")],
        episode_s=episode_s, tokens_equal_single_client=True, card=card)
    print("phaseX (c)", json.dumps(res), flush=True)
    out["runs"]["c"] = res


def phase_x_process_fleet(cfg, sd, trace, served, fleet_n, card, started):
    """The process replica fleet at GPT-2-small width, phase N's layout,
    one worker process per replica on this card: (a) bf16 spread over 2
    workers; on one f32 fleet, (b) a kill -9, then (c) a sticky CUDA
    error contained.
    K1's launches come from the workers' own counters (``stop()``)."""
    t_phase = time.perf_counter()
    out = {"runs": {}, "k1": 0}
    x_bf16(cfg, sd, trace, served, fleet_n, card, out)
    x_f32(cfg, sd, trace, served, card, out)
    out["left"] = x_left_over("phaseX")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phaseX took {time.perf_counter() - t_phase:.1f} s; the script "
          f"{time.perf_counter() - started:.1f} s so far", flush=True)
    return out


# -------------------------------------------------------------- phase C
C_STEPS = 3
C_ARGS = ["fit", "--strategy", "ddp_sharded", "--strategy.num_workers", "1",
          "--model.size", "small", "--model.optimizer", "adafactor",
          "--model.vocab_size", "50257", "--model.seq_len", "1024",
          "--model.batch_size", "8", "--trainer.max_epochs", "1",
          "--trainer.limit_train_batches", str(C_STEPS),
          "--trainer.limit_val_batches", "1", "--trainer.seed", "0"]


def phase_c_cli(card):
    """``python -m ray_lightning_tpu_torch.cli`` on the card against the
    same fit built by hand."""
    import tempfile
    from ray_lightning_tpu_torch import GPTModule, RayShardedStrategy, Trainer
    release()
    root = tempfile.mkdtemp(prefix="chip_smoke_cli-")
    try:
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=here)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "ray_lightning_tpu_torch.cli",
             "--model-class", "ray_lightning_tpu_torch.models.GPTModule",
             *C_ARGS, "--trainer.default_root_dir", root],
            capture_output=True, text=True, env=env, cwd=here, timeout=600)
        cli_s = time.perf_counter() - t0
        check(out.returncode == 0,
              f"C: the CLI exited {out.returncode}: {out.stderr[-3000:]}")
        got = json.loads(out.stdout.strip().splitlines()[-1])
        trainer = Trainer(strategy=RayShardedStrategy(num_workers=1),
                          max_epochs=1, limit_train_batches=C_STEPS,
                          limit_val_batches=1, seed=0,
                          default_root_dir=root)
        trainer.fit(GPTModule(size="small", optimizer="adafactor",
                              vocab_size=50257, seq_len=1024, batch_size=8))
        want = dict(trainer.callback_metrics)
        check(got == want, f"C: the CLI's metrics {got} != the fit built "
              f"by hand {want}")
        del trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
        release()
    res = dict(card=card, args=C_ARGS, metrics=got, bitwise=True,
               cli_s=cli_s)
    print("phaseC cli", json.dumps(res), flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    started = time.perf_counter()

    def ended(*phases):
        print(f"phase{'/'.join(phases)} ended at "
              f"{time.perf_counter() - started:.1f} s of the script",
              flush=True)

    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    from ray_lightning_tpu_torch import _build
    from ray_lightning_tpu_torch.interop import load_flax_params
    from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
    from ray_lightning_tpu_torch.models import paged_attention as pa
    from ray_lightning_tpu_torch.models import quantized_matmul as qmm

    # the fork server phase X's workers fork from imports torch, the
    # serving stack and this script while nvcc builds
    from ray_lightning_tpu_torch.serve.process_fleet import \
        start_fork_server
    start_fork_server()
    t0 = time.perf_counter()
    logs = _build.build(_build.SOURCES)
    print(f"phase0 built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log.strip()}", file=sys.stderr)
    hgmma = hgmma_counts()
    tc = {k: hgmma.get(k) for k in sorted(TC_KERNELS)}
    print(f"phase0 HGMMA instructions per tensor-core kernel "
          f"(per instantiation): {json.dumps(tc)}", flush=True)
    check(all(n and all(n) for n in tc.values()),
          f"tensor-core kernels without HGMMA: {tc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase0 allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = phase1_kernel_vs_plain(flush)
    flash = phase_t1_flash_vs_plain(flush)
    qrows = phase_q1_matmul_vs_plain(flush)
    chunk_k2 = phase_l_k2_chunk_shapes(flush)
    del flush
    ended("0", "1", "T1", "Q1", "L (K2)")

    cfg = gpt2_config("small")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    model = load_flax_params(TransformerLM(cfg, device="cpu"),
                             random_flax_params(cfg, rng))
    sd = model.state_dict()
    del model
    print(f"phase2 GPT-2-small {cfg.n_layers}x{cfg.d_model} vocab "
          f"{cfg.vocab_size}: weights made and converted in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    trace = make_trace(rng, cfg.vocab_size)
    served = phase2_main_path(cfg, sd, trace, card)
    launches = served["bf16"]["kernel_launches"]

    phase3_kernel_vs_plain_path(cfg, sd, trace)
    quantized = phase_q2_quantized_serving(cfg, sd, trace, card)
    phase3_kernel_vs_plain_path(cfg, sd, trace, tag="phaseQ3",
                                paths=PATHS_QUANTIZED, weight_dtype="int8")
    ended("2", "3", "Q2", "Q3")
    long_prompts = phase_l_long_prompts(cfg, sd, rng, card)
    ended("L")
    speculative = phase_s_speculative(cfg, sd, trace, served, quantized, card)
    ended("S")
    dense = phase_g_dense(cfg, sd, trace, served, card)
    ended("G")
    pipelined = phase_p_async(cfg, sd, trace, card)
    ended("P")
    adapted = phase_a_adapters(cfg, sd, trace, card)
    ended("A")
    faulted = phase_f_faults(cfg, sd, trace, served, card)
    ended("F")
    fleet = phase_n_fleet(cfg, sd, trace, served, long_prompts["trace"],
                          long_prompts, card)
    ended("N")
    processes = phase_x_process_fleet(cfg, sd, trace, served, fleet, card,
                                      started)
    del sd

    fpath = flash[("path", "bfloat16")]
    trained = phase_t2_training(card, fpath)
    ended("T2")
    piped = phase_i_input_pipeline(card)
    ended("I")
    phase_t3_train_kernel_vs_plain()
    core = phase_m_model_core(card, trained, rng, trace)
    ended("T3", "M")
    _resumed, state_r = phase_r_resume(card)
    presets = phase_o_optimizers(card)
    ended("R", "O")
    release()
    ray, workers, spawn_s = spawn_card_worker()
    try:
        phase_d_data_parallel(card, trained, presets, ray, workers, spawn_s)
        ended("D")
        phase_u_tune(card, ray, workers, spawn_s)
    finally:
        ray.shutdown()
    check(ray.live_actor_count() == 0, "D/U: a worker outlived the phases")
    ended("U")
    phase_c_cli(card)
    ended("C")
    t0 = time.perf_counter()
    health = phase_h_fit_health(card, trained, state_r)
    del state_r
    print(f"phaseH took {time.perf_counter() - t0:.1f} s; the script "
          f"{time.perf_counter() - started:.1f} s so far", flush=True)

    # the main paths' own calls: bf16 q and pages, T=1 (serving); bf16,
    # B=8, T=S=1024, causal (training)
    path = next(r for r in rows
                if (r["q"], r["pages"], r["T"]) == ("bfloat16", "bfloat16",
                                                    1))
    # K1 at the spec verify's T = k+1, launches from phase S (a)'s bf16 run
    verify = next(r for r in rows
                  if (r["q"], r["pages"], r["T"]) == ("bfloat16", "bfloat16",
                                                      S_K + 1))
    # phases P's and A's bf16 runs: K1 by T, K2's chunk route, K5 by route
    pl, al, ac = (pipelined["launches"], adapted["launches"],
                  adapted["chunk_launches"])
    p_k1 = sum(pl[e]["k1_by_t"].get(1, 0)
               for e in ("page-native", "int8-weights", "chunked"))
    a_k1 = al["k1_by_t"].get(1, 0) + ac["k1_by_t"].get(1, 0)
    # phase F: every run's K1 by T, K2's chunk launches on tc (its bf16
    # chunked run), K5 by route
    fl = faulted["launches"]
    # phase N: K1 by T over its four fleets, K2's chunk launches (d), K5
    # by route (c); phase X: K1 as its workers counted it (T = 1)
    nl = fleet["launches"]
    kernels = []
    for name, row, n in (
            (pa.KERNEL, path,
             launches + long_prompts["runs"]["bf16"]["k1_launches"]
             + p_k1 + a_k1 + fl["k1_by_t"].get(1, 0)
             + nl["k1_by_t"].get(1, 0) + processes["k1"]),
            (pa.KERNEL + "_verify", verify,
             speculative["runs"]["bf16"]["k1_launches"]
             + pl["spec"]["k1_by_t"].get(S_K + 1, 0)
             + fl["k1_by_t"].get(S_K + 1, 0))):
        kernels.append(dict(
            name=name, route="cuda",
            source="ray_lightning_tpu_torch/csrc/paged_attention.cu",
            replaces="ray_lightning_tpu/models/pallas_attention.py:83",
            launches=n, max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    flash_source = "ray_lightning_tpu_torch/csrc/flash_attention.cu"
    for name, kind, line, errs, lib in (
            ("flash_fwd", "fwd", 41, ("out",), fpath["library_fwd_ms"]),
            # SDPA's backward (its fastest backend) computes dq, dk and dv
            # together: it stands beside K3, and K4 has no library call of
            # its own
            ("flash_bwd_dkv", "dkv", 130, ("dk", "dv"),
             fpath["library_bwd_ms"]),
            ("flash_bwd_dq", "dq", 173, ("dq",), None)):
        kernels.append(dict(
            name=name, route="cuda", source=flash_source,
            replaces=f"ray_lightning_tpu/ops/pallas_flash.py:{line}",
            launches=(trained["launches"][name]
                      + piped["launches"][name]
                      + core["flash_launches"][name]
                      + health["armed"]["launches"][name]
                      + health["supervised"]["launches"][name]),
            max_abs_err=max(fpath[f"{e}_err"] for e in errs),
            ms=fpath[f"{kind}_ms"], plain_ms=fpath[f"{kind}_plain_ms"],
            bound_ms=fpath[f"{kind}_bound_ms"],
            bound_by=fpath[f"{kind}_bound_by"], library_ms=lib))
    # K2 as phase L's chunk dispatches call it: B=1, T=128, S=1024 keys
    # (the longest row), launches from phase L's bf16 run
    chunk = next(r for r in chunk_k2 if r["S"] == 1024)
    kernels.append(dict(
        name="flash_fwd_chunk", route="cuda", source=flash_source,
        replaces="ray_lightning_tpu/ops/pallas_flash.py:41",
        launches=(long_prompts["runs"]["bf16"]["k2_routes"]["tc"]
                  + pl["chunked"]["k2"]["tc"] + ac["k2"]["tc"]
                  + faulted["k2_chunk_tc"] + fleet["k2_chunk_tc"]),
        **{k: chunk[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}))
    # K5: one forward's calls -- n_layers x (qkv, out, up, down) and the
    # head -- bf16 x, int8 codes: at M=8 (a decode step, the GEMVs;
    # launches from Q2's int8 run, phase L's int8-weights run, the
    # draft's feeds in phase S (d), and phase G's dense decode steps (c),
    # generate()'s steps (d) and the draft's feeds on both dense layouts
    # (e)), at M=1024 (a prefill, the tensor cores; Q2's, and phase G's
    # dense prefills (c) and generate()'s (d)), at M=128 (a chunk, the
    # tensor cores; phase L's) and at M=40 (a spec verify, the tensor
    # cores; phase S (d)'s and phase G (e)'s on both dense layouts)
    q2 = quantized["int8"]["route_launches"]
    ql = long_prompts["runs"]["int8-weights"]["k5_routes"]
    qs = speculative["runs"]["int8-weights"]
    qg = dense["quantized"]["route_launches"]
    qd = dense["generate"]["int8-weights"]["route_launches"]
    qe = [dense["spec"][n]["int8_weights"] for n in G_LAYOUTS]
    qp, qa, qc = pl["int8-weights"]["k5"], al["k5"], ac["k5"]
    qf = fl["k5"]
    qn = fleet["k5"]
    decode = ("gemv_dense", "gemv_attend")
    for name, M, launches5 in (
            (qmm.KERNEL, 8, sum(q2[r] + ql[r] + qs["route_launches"][r]
                                + qg[r] + qd[r]
                                + sum(e["route_launches"][r] for e in qe)
                                + qp[r] + qa[r] + qc[r] + qf.get(r, 0)
                                + qn[r] for r in decode)),
            (qmm.KERNEL + "_prefill", 1024, q2["tc"] + qg["tc"] + qd["tc"]
             + qp["tc"] + qa["tc"] + qn["tc"]),
            (qmm.KERNEL + "_chunk", L_CHUNK, ql["tc"] + qc["tc"]),
            (qmm.KERNEL + "_verify", S_VERIFY_M,
             qs["verify_tc_launches"]
             + sum(e["verify_tc_launches"] for e in qe))):
        fwd = forward_sum(qrows, "int8", M, cfg.n_layers)
        kernels.append(dict(
            name=name, route="cuda",
            source="ray_lightning_tpu_torch/csrc/quantized_matmul.cu",
            replaces="ray_lightning_tpu/models/pallas_matmul.py:123",
            launches=launches5,
            **{k: fwd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}))
    # K5 at the untied head (phase M (e)): one call at decode's M = 8,
    # launches from (e)'s int8 serving run (the head at every M, on tc)
    head = core["untied"]["head"][8]
    kernels.append(dict(
        name=qmm.KERNEL + "_untied_head", route="cuda",
        source="ray_lightning_tpu_torch/csrc/quantized_matmul.cu",
        replaces="ray_lightning_tpu/models/pallas_matmul.py:123",
        launches=core["untied"]["serving"]["head_route_launches"]["tc"],
        **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")}))
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    check(not idle, f"kernels no main path launched: {idle}")
    x_left_over("the script's end")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
