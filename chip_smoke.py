"""Drive the PyTorch/CUDA port (``ray_lightning_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing its result line:

0. Require a CUDA device; print the card's name and power limit; build
   every kernel from ``ray_lightning_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together); turn TF32 off.
1. The paged-attention kernel (K1) against its plain PyTorch version at
   the shapes of the GPT-2-small serving path (B=8 slots, H=12, D=64,
   page_size 16, pages_per_slot 64, ragged positions 0..1000, unmapped −1
   page-table entries, one row with every key masked): f32, bf16 and int8
   pages, T=1 and T=4. Prints each case's max abs error against its
   stated bound, the kernel's time, the plain version's time, the time of
   one PyTorch library call of the same function, and the least time the
   card could take (bytes over 3.35 TB/s or operations over the peak rate
   of their type, whichever is larger).
T1. The flash-attention kernels (K2 forward, K3 dK/dV, K4 dQ) against
   their plain versions at the training path's shapes (B=8, T=S=1024,
   H=12, D=64, causal) in bf16 and f32, and on a ragged length
   (T=S=1000), end-aligned T=512 < S=1024, non-causal, and T=64 > S=32
   (rows that admit no key): the max abs error of out, lse, dq, dk and dv
   against stated bounds. At the path shapes, each kernel's time on a
   cold L2 beside its bound, its plain version's time and the library's
   (``F.scaled_dot_product_attention`` forward; its backward for K3+K4).
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
T2. The training path: ``Trainer(strategy=RayStrategy(num_workers=1),
   max_epochs=1, limit_train_batches=20, limit_val_batches=2,
   seed=0).fit(GPTModule(config=gpt2_config("small",
   attention_impl="flash"), batch_size=8, seq_len=1024))`` -- full width,
   bf16 compute over f32 master weights, AdamW (lr 3e-4, b2 0.95, weight
   decay 0.1). Every loss finite, the last 5 steps' mean below the first
   step's, K2 launched n_layers x (train steps + validation batches)
   times and K3 and K4 n_layers x train steps. Prints the median step,
   tokens/s, the share of bf16 peak, peak memory and the attention
   kernels' share of a step.
T3. Training, kernel path against plain path end to end, in f32: one
   step's loss and gradients of GPT-2-small (B=2, T=1024, the same
   weights) through the kernels (``attention_impl="flash"``) and through
   plain PyTorch attention differentiated by autograd
   (``attention_impl="dot"``); loss to 1e-5 relative, every gradient to
   its stated bound.
4. A ``{"kernels": [...]}`` line, the card line again, and the result
   line ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # f32 outside the tensor cores
FLUSH_BYTES = 256 << 20              # > the 50 MB L2: every launch runs cold
SPIN_CYCLES = 1_000_000              # ~0.5 ms of device spin before a call
TIMED_LAUNCHES = 50
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
            for T in (1, 4):
                args = attention_inputs(dtype, quantized, T, gen)
                out = pa.paged_attention(*args)
                torch.cuda.synchronize()
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
                    T=T, max_abs_err=err, tol=tol,
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


def serve(model, sd, trace, **kw):
    """Replay ``trace`` through a fresh ``ServeClient`` (tick clock), with
    host wall stamps around every engine dispatch. Returns the
    completions, the engine, and the timings."""
    from ray_lightning_tpu_torch.serve import ServeClient
    client = ServeClient(model, sd, device=DEVICE, **SERVE, **kw)
    eng = client.engine
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


def phase2_main_path(cfg, sd, trace, card):
    from ray_lightning_tpu_torch.models import paged_attention as pa
    from ray_lightning_tpu_torch.models import TransformerLM
    proto = TransformerLM(cfg, device="meta")
    # a greedy and a sampled request, run before the counts are reset:
    # CUDA modules load lazily at first use (cuBLAS, the sort and random
    # kernels of sampling, the int8 write path), and that one-time cost
    # would otherwise land in the first measured TTFT
    warm = [(0, dict(prompt=[1, 2, 3], max_new_tokens=4)),
            (0, dict(prompt=[4, 5], max_new_tokens=4, temperature=0.8,
                     top_k=40))]
    results = {}
    for kv_dtype in (None, "int8"):
        label = f"main path kv_dtype={kv_dtype}"
        serve(proto, sd, warm, attention_kernel="cuda", kv_dtype=kv_dtype)
        pa.reset_kernel_launches()
        done, eng, st = serve(proto, sd, trace, attention_kernel="cuda",
                              kv_dtype=kv_dtype)
        launches = pa.kernel_launches()
        check_completions(done, trace, cfg.vocab_size, label)
        expect = cfg.n_layers * eng.decode_substeps
        check(eng.decode_substeps > 0 and launches == expect,
              f"{label}: {launches} kernel launches, expected n_layers x "
              f"decode steps = {expect}")
        decode_tokens = sum(len(c.tokens) - 1 for c in done.values())
        ttft = [st["first"][r] - st["submit"][r] for r in done]
        res = dict(
            kv_dtype=kv_dtype or "bf16", requests=len(done),
            decode_steps=eng.decode_substeps, kernel_launches=launches,
            decode_tokens=decode_tokens,
            decode_tokens_per_s=decode_tokens / sum(st["step_s"]),
            step_ms_median=1e3 * statistics.median(st["step_s"]),
            prefill_ms_median=1e3 * statistics.median(st["prefill_s"]),
            ttft_ms_median=1e3 * statistics.median(ttft),
            ttft_ms_max=1e3 * max(ttft), card=card)
        print("phase2", json.dumps(res), flush=True)
        results[res["kv_dtype"]] = res
    return results


# --------------------------------------------------------------- phase 3
def phase3_kernel_vs_plain_path(cfg, sd, trace):
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.models.generate import (_prefill_impl,
                                                        decode_step_paged)
    from ray_lightning_tpu_torch.models.transformer import PagedKV
    from ray_lightning_tpu_torch.serve.pages import PagePool, scatter_pages
    from ray_lightning_tpu_torch.serve.request import Request
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def model(kernel):
        m = TransformerLM(dataclasses.replace(cfg32, attention_kernel=kernel),
                          device="meta").to_empty(device=DEVICE)
        m.load_state_dict(sd)
        return m.requires_grad_(False).eval()

    models = {k: model(k) for k in ("cuda", "torch")}
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
    print(f"phase3 first decode step f32 logits kernel vs plain: max abs "
          f"{err:.3e} (bound {E2E_LOGITS_TOL})", flush=True)
    check(err <= E2E_LOGITS_TOL, f"end-to-end logits differ by {err}")
    del models, pool, cache

    greedy = [(t, dict(kw, temperature=0.0, top_k=None)) for t, kw in trace]
    proto = TransformerLM(cfg32, device="meta")
    runs = {k: serve(proto, sd, greedy, attention_kernel=k)[0]
            for k in ("cuda", "torch")}
    same = total = 0
    for rid in runs["cuda"]:
        x, y = runs["cuda"][rid].tokens, runs["torch"][rid].tokens
        total += len(x)
        same += sum(int(i == j) for i, j in zip(x, y))
    share = same / total
    print(f"phase3 greedy tokens equal on the kernel and plain paths (f32, "
          f"information only): {same}/{total} = {share:.4f}", flush=True)
    return err, share


# -------------------------------------------------------------- phase T1
FLASH_CASES = [  # (label, B, T, S, causal); H=12, D=64 throughout
    ("path", 8, 1024, 1024, True),
    ("ragged", 8, 1000, 1000, True),
    ("end-aligned", 8, 512, 1024, True),
    ("non-causal", 8, 1024, 1024, False),
    ("empty-rows", 8, 64, 32, True),
]


def flash_tol(dtype, name: str, ref: torch.Tensor, grad: bool) -> float:
    """Bound on |kernel - plain| of one flash output, in f32 units.

    f32: only the order of the f32 sums differs (64-key tiles, an online
    softmax whose running maximum rescales earlier tiles) -- 1e-5 for out
    and lse; 1e-4 of the largest magnitude for a gradient, a sum over up
    to 1024 rows in another order. lse is f32 sums of exact products in
    both dtypes: 1e-5 (rows that admit no key are 1e30 in both, exactly).
    bf16: the kernel rounds the softmax
    weights to bf16 relative to its running maximum and the plain version
    relative to the final one, p and ds are rounded before each product,
    and each output is rounded once -- 2e-2 of max(1, largest magnitude)
    (one output rounding is at most 2**-8 of it, a flipped one 2**-7)."""
    if name == "lse":
        return 1e-5
    top = float(ref.float().abs().max())
    if dtype == torch.float32:
        return 1e-4 * max(top, 1e-30) if grad else 1e-5
    return 2e-2 * max(1.0, top)


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


def sdpa_times(q, k, v, do, causal, flush):
    """``F.scaled_dot_product_attention`` on (B, H, T, D) views of the same
    inputs: its forward, and its backward (forward + backward minus
    forward). The port never calls it; it is the yardstick."""
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

    fwd_ms = time_ms(fwd, flush)
    return fwd_ms, time_ms(fwd_bwd, flush) - fwd_ms


def phase_t1_flash_vs_plain(flush):
    from ray_lightning_tpu_torch.ops import cuda_flash as cf
    rows = {}
    for label, B, T, S, causal in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = flash_inputs(dtype, B, T, S)
            out, lse = cf.flash_fwd(q, k, v, causal)
            delta = cf.flash_delta(out, do)
            dk, dv = cf.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
            dq = cf.flash_bwd_dq(q, k, v, do, lse, delta, causal)
            torch.cuda.synchronize()
            # the same inputs for both: the kernels' lse and delta
            ref_out, ref_lse = cf.flash_fwd_reference(q, k, v, causal)
            ref_dk, ref_dv = cf.flash_bwd_dkv_reference(q, k, v, do, lse,
                                                        delta, causal)
            ref_dq = cf.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                               causal)
            row = dict(case=label, dtype=str(dtype).split(".")[-1], B=B,
                       T=T, S=S, causal=causal)
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
                tol = flash_tol(dtype, name, ref, grad)
                row[f"{name}_err"], row[f"{name}_tol"] = err, tol
                check(err <= tol, f"flash {label} {dtype} {name}: kernel "
                      f"vs plain {err} > {tol}")
            if causal and T > S:
                check(float(out[:, :T - S].abs().max()) == 0.0
                      and bool((lse[:, :, :T - S] == 1e30).all())
                      and float(dq[:, :T - S].abs().max()) == 0.0,
                      "rows that admit no key must give out 0, lse 1e30, "
                      "dq 0")
            if label == "path":
                lib_fwd, lib_bwd = sdpa_times(q, k, v, do, causal, flush)
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
                row["library_fwd_ms"], row["library_bwd_ms"] = (lib_fwd,
                                                                lib_bwd)
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
        first_loss=losses[0], last5_mean_loss=last5,
        val_loss=trainer.callback_metrics["val_loss"],
        expected_first_loss=float(np.log(cfg.vocab_size)),
        launches=launches, params=n_params, fit_s=fit_s,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    from ray_lightning_tpu_torch import _build
    from ray_lightning_tpu_torch.interop import load_flax_params
    from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
    from ray_lightning_tpu_torch.models import paged_attention as pa

    t0 = time.perf_counter()
    logs = _build.build(_build.SOURCES)
    print(f"phase0 built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log.strip()}", file=sys.stderr)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase0 allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = phase1_kernel_vs_plain(flush)
    flash = phase_t1_flash_vs_plain(flush)
    del flush

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
    del sd

    fpath = flash[("path", "bfloat16")]
    trained = phase_t2_training(card, fpath)
    phase_t3_train_kernel_vs_plain()

    # the main paths' own calls: bf16 q and pages, T=1 (serving); bf16,
    # B=8, T=S=1024, causal (training)
    path = next(r for r in rows
                if (r["q"], r["pages"], r["T"]) == ("bfloat16", "bfloat16",
                                                    1))
    kernels = [dict(
        name=pa.KERNEL, route="cuda",
        source="ray_lightning_tpu_torch/csrc/paged_attention.cu",
        replaces="ray_lightning_tpu/models/pallas_attention.py:83",
        launches=launches, max_abs_err=path["max_abs_err"], ms=path["ms"],
        plain_ms=path["plain_ms"], bound_ms=path["bound_ms"],
        bound_by=path["bound_by"], library_ms=path["library_ms"])]
    flash_source = "ray_lightning_tpu_torch/csrc/flash_attention.cu"
    for name, kind, line, errs, lib in (
            ("flash_fwd", "fwd", 41, ("out",), fpath["library_fwd_ms"]),
            # SDPA's backward computes dq, dk and dv together: it stands
            # beside K3, and K4 has no library call of its own
            ("flash_bwd_dkv", "dkv", 130, ("dk", "dv"),
             fpath["library_bwd_ms"]),
            ("flash_bwd_dq", "dq", 173, ("dq",), None)):
        kernels.append(dict(
            name=name, route="cuda", source=flash_source,
            replaces=f"ray_lightning_tpu/ops/pallas_flash.py:{line}",
            launches=trained["launches"][name],
            max_abs_err=max(fpath[f"{e}_err"] for e in errs),
            ms=fpath[f"{kind}_ms"], plain_ms=fpath[f"{kind}_plain_ms"],
            bound_ms=fpath[f"{kind}_bound_ms"],
            bound_by=fpath[f"{kind}_bound_by"], library_ms=lib))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
