"""Chunked prefill and the prefix cache of the port (``ray_lightning_tpu_torch/serve``) against the JAX package.

The port's engine and client with ``prefill_chunk=`` and
``prefix_cache=`` run beside the JAX page-native Pallas engine
(``page_native=True, attention_kernel="pallas"``, interpret mode on the
CPU, as ``tests/test_paged.py`` runs it) on the nano model of the
``serve_nano_family`` fixture (vocab 128, max_seq_len 32, f32), with the
same weights and the same traces, mirroring the chunk and prefix tests
of ``tests/test_paged.py``:

- greedy tokens, finish reasons, tick stamps and ``prefix_hit_tokens``
  identical to the JAX engine's, and the same sequence of chunk and
  decode dispatches; in f32 with both read sides, with int8 KV, and with
  int8 and int4 weights (``matmul_kernel="cuda"``, its plain version on
  the CPU);
- the allocator: page tables, refcounts, free lists and cache entries
  equal to the JAX engine's after every dispatch, through adoption,
  release and eviction; ``admissible_prefix`` FIFO and page-aware;
- the chunk forward itself: the logits at ``valid_len - 1`` and the
  pages written, against the JAX ``_chunk_prefill_impl``'s computation
  (its page gather, block write and masked dense attention) at f32
  atol 1e-5; int8 pages code for code within one, scales at rtol 1e-5;
- inside the port: a sampled stream is the same chunked and batched (the
  first token is the same ``row_seed(engine seed, request seed, 0)``
  draw either way).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_lightning_tpu.obs import Telemetry
from ray_lightning_tpu.serve import PagePool as JaxPagePool
from ray_lightning_tpu.serve import ServeClient as JaxServeClient
from ray_lightning_tpu.serve import ServeEngine as JaxServeEngine
from ray_lightning_tpu.serve.request import Request as JaxRequest
from ray_lightning_tpu.serve.pages import PrefixCache as JaxPrefixCache
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.models.generate import _chunk_prefill_impl
from ray_lightning_tpu_torch.serve import ServeClient, ServeEngine
from ray_lightning_tpu_torch.serve.pages import PagePool, PrefixCache
from ray_lightning_tpu_torch.serve.request import Request

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

PAGED = dict(page_size=4, prefill_chunk=8, prefix_cache=True)
NATIVE = dict(page_native=True)
PROMPTS = [[5, 17, 3, 9], [9, 2, 44], [42, 7], [1]]
LONG = [7, 1, 9, 3, 5, 2, 8, 4, 6, 1, 2, 3, 4, 5, 6, 7, 8, 9, 1, 2]
SYSP = [11, 12, 13, 14, 15, 16, 17, 18]          # 2 pages at page_size 4
# the read side and weights of each variant, on the port and on JAX
VARIANTS = {
    "f32-cuda": ({"attention_kernel": "cuda"}, {}),
    "f32-torch": ({"attention_kernel": "torch"}, {}),
    "int8-kv": ({"attention_kernel": "cuda", "kv_dtype": "int8"},
                {"kv_dtype": "int8"}),
    "int8-weights": ({"attention_kernel": "cuda", "weight_dtype": "int8",
                      "matmul_kernel": "cuda"},
                     {"weight_dtype": "int8", "matmul_kernel": "pallas"}),
    "int4-weights": ({"attention_kernel": "cuda", "weight_dtype": "int4",
                      "weight_group_size": 32, "matmul_kernel": "cuda"},
                     {"weight_dtype": "int4", "weight_group_size": 32,
                      "matmul_kernel": "pallas"}),
}


@pytest.fixture(scope="module")
def nano(serve_nano_family):
    return serve_nano_family[:2]


@pytest.fixture(scope="module")
def port(nano):
    """The port's nano model (f32, CPU) holding the JAX weights."""
    _, params = nano
    cfg = gpt2_config("nano", vocab_size=128, max_seq_len=32,
                      dtype=torch.float32)
    return load_flax_params(TransformerLM(cfg, device="cpu"), params)


def _key(trace, kw):
    return repr((trace, sorted(kw.items())))


_JAX_RUNS = {}


def _as_jax(req: Request) -> JaxRequest:
    return JaxRequest(id=req.id, prompt=list(req.prompt),
                      max_new_tokens=req.max_new_tokens,
                      temperature=req.temperature, top_k=req.top_k,
                      eos_id=req.eos_id, seed=req.seed)


def _run_jax(nano, trace, **kw):
    """The JAX Pallas engine's completions and its sequence of
    dispatches ("prefill", "chunk", "step"), run once per trace and
    arguments in this module."""
    key = _key(trace, kw)
    if key not in _JAX_RUNS:
        dec, params = nano
        tel = Telemetry()
        client = JaxServeClient(dec, params, attention_kernel="pallas",
                                telemetry=tel, **NATIVE, **kw)
        out = client.serve_trace(list(trace))
        sites = [e.site[len("engine."):] for e in tel.events()
                 if e.site in ("engine.prefill", "engine.chunk",
                               "engine.step")]
        stats = {"chunk_dispatches": client.engine.chunk_dispatches}
        if client.engine.prefix is not None:
            stats.update(hits=client.engine.prefix.hits,
                         lookups=client.engine.prefix.lookups)
        client.shutdown()
        _JAX_RUNS[key] = (out, sites, stats)
    return _JAX_RUNS[key]


class _Recorder:
    """The port engine's dispatches, in order, by kind."""

    def __init__(self, engine):
        self.sites = []
        for name, site in (("prefill", "prefill"),
                           ("prefill_chunk_step", "chunk"),
                           ("step", "step")):
            fn = getattr(engine, name)
            setattr(engine, name, self._wrap(engine, fn, site))

    def _wrap(self, engine, fn, site):
        def call(*args):
            before = (engine.prefills, engine.chunk_dispatches,
                      engine.steps)
            out = fn(*args)
            after = (engine.prefills, engine.chunk_dispatches, engine.steps)
            if after != before:
                self.sites.append(site)
            return out
        return call


def _run_port(port, trace, **kw):
    client = ServeClient(port, port.state_dict(), device="cpu", **NATIVE,
                         **kw)
    rec = _Recorder(client.engine)
    out = client.serve_trace(list(trace))
    stats = {"chunk_dispatches": client.engine.chunk_dispatches}
    if client.engine.prefix is not None:
        stats.update(hits=client.engine.prefix.hits,
                     lookups=client.engine.prefix.lookups)
    client.shutdown()
    return out, rec.sites, stats


def _same_completions(ref, out):
    assert sorted(ref) == sorted(out)
    for rid in ref:
        a, b = ref[rid], out[rid]
        assert (b.tokens, b.finish_reason) == (a.tokens, a.finish_reason), rid
        assert (b.arrival_time, b.first_token_time, b.finish_time) == (
            a.arrival_time, a.first_token_time, a.finish_time), rid
        assert b.prefix_hit_tokens == a.prefix_hit_tokens, rid


def _no_chunk_back_to_back(sites):
    for prev, cur in zip(sites, sites[1:]):
        assert not (prev == cur == "chunk"), sites


# --------------------------------------------------------------------- #
# chunked prefill
# --------------------------------------------------------------------- #
INTERLEAVE = [(0, dict(prompt=PROMPTS[0], max_new_tokens=5)),
              (2, dict(prompt=LONG, max_new_tokens=5))]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_chunked_interleaves_and_matches_jax(nano, port, variant):
    """A 20-token prompt (> prefill_len) streams in 3 chunk dispatches
    alternating with the short request's decode: the same completions,
    stamps and dispatch sequence as the JAX engine (``test_paged.py::
    test_chunked_prefill_interleaves_and_matches``)."""
    pkw, jkw = VARIANTS[variant]
    kw = dict(num_slots=3, prefill_len=8, page_size=4, prefill_chunk=8)
    ref, jsites, jstats = _run_jax(nano, INTERLEAVE, **kw, **jkw)
    out, sites, stats = _run_port(port, INTERLEAVE, **kw, **pkw)
    _same_completions(ref, out)
    assert sites == jsites
    assert stats["chunk_dispatches"] == jstats["chunk_dispatches"] == 3
    first = sites.index("chunk")
    assert "step" in sites[first:sites.index("chunk", first + 1)]
    _no_chunk_back_to_back(sites)


def test_chunked_admits_prompts_beyond_prefill_len(nano, port):
    """Chunking lifts the ``prompt <= prefill_len`` limit up to
    ``max_seq_len - max_new_tokens`` (28 + 4 = 32 here, in chunks of 8,
    8, 8 and 4 valid tokens); without it the same submit is refused."""
    long_p = list(range(1, 29))
    trace = [(0, dict(prompt=long_p, max_new_tokens=4))]
    plain = ServeClient(port, port.state_dict(), num_slots=2, prefill_len=8,
                        page_size=4, device="cpu", **NATIVE)
    with pytest.raises(ValueError, match="prefill_len"):
        plain.submit(long_p, max_new_tokens=4)
    kw = dict(num_slots=2, prefill_len=8, page_size=4, prefill_chunk=8)
    chunked = ServeClient(port, port.state_dict(), device="cpu", **NATIVE,
                          **kw)
    with pytest.raises(ValueError, match="max_seq_len"):
        chunked.submit(long_p, max_new_tokens=5)
    ref, _, jstats = _run_jax(nano, trace, **kw)
    out, _, stats = _run_port(port, trace, attention_kernel="cuda", **kw)
    _same_completions(ref, out)
    assert out[0].finish_reason == "length"
    assert out[0].time_to_first_token is not None
    assert stats["chunk_dispatches"] == jstats["chunk_dispatches"] == 4


def test_sampled_stream_is_the_same_chunked_and_batched(port):
    """A sampled request's tokens depend on (engine seed, request seed,
    step) only, not on its route: batched, or through chunks (a prefix
    cache routes every prompt there)."""
    trace = [(0, dict(prompt=PROMPTS[0], max_new_tokens=8)),
             (1, dict(prompt=PROMPTS[1] + SYSP, max_new_tokens=6,
                      temperature=0.9, top_k=20, seed=77))]
    base = dict(num_slots=3, prefill_len=16, page_size=4)
    batched, bsites, _ = _run_port(port, trace, **base)
    chunked, csites, _ = _run_port(port, trace, prefill_chunk=8,
                                   prefix_cache=True, **base)
    assert "chunk" not in bsites and csites.count("chunk") == 3
    assert chunked[1].tokens == batched[1].tokens
    assert chunked[0].tokens == batched[0].tokens
    other = _run_port(port, [(0, dict(trace[1][1], seed=78))],
                      prefill_chunk=8, prefix_cache=True, **base)[0]
    assert other[0].tokens != chunked[1].tokens


# --------------------------------------------------------------------- #
# prefix cache
# --------------------------------------------------------------------- #
def test_prefix_cache_reuse_identity(nano, port):
    """Requests sharing a system prompt adopt its pages: tokens, hits
    and ``prefix_hit_tokens`` as the JAX engine's (``test_paged.py::
    test_prefix_cache_reuse_identity``); adoption stops one token short
    of a whole prompt and at whole chunks."""
    pa, pb = SYSP + [5, 17, 3], SYSP + [9, 2]
    trace = [(0, dict(prompt=pa, max_new_tokens=5)),
             (9, dict(prompt=pb, max_new_tokens=5)),
             (9, dict(prompt=pa, max_new_tokens=5, seed=77))]
    kw = dict(num_slots=3, prefill_len=8, **PAGED)
    ref, jsites, jstats = _run_jax(nano, trace, **kw)
    out, sites, stats = _run_port(port, trace, attention_kernel="cuda", **kw)
    _same_completions(ref, out)
    assert sites == jsites
    assert [out[i].prefix_hit_tokens for i in range(3)] == [0, 8, 8]
    assert out[2].tokens == out[0].tokens
    assert stats == jstats and stats["hits"] == 4


def _pool_state(pool, cache):
    """A pool's allocation state, comparable across the two packages."""
    return (np.array(pool.page_table).tolist(),
            np.array(pool._ref).tolist(), list(pool._free_pages),
            list(pool._free_slots),
            None if cache is None else list(cache._entries.items()))


class _Pair:
    """The JAX and the port engine driven through the same calls, their
    allocation state compared after each."""

    def __init__(self, nano, port, **kw):
        dec, params = nano
        self.jax = JaxServeEngine(dec, params, attention_kernel="pallas",
                                  **NATIVE, **kw)
        self.port = ServeEngine(port, port.state_dict(), device="cpu",
                                attention_kernel="cuda", **NATIVE, **kw)
        self.done = {"jax": {}, "port": {}}

    def check(self):
        assert _pool_state(self.port.pool, self.port.prefix) == \
            _pool_state(self.jax.pool, self.jax.prefix)
        assert self.port.chunk_pending == self.jax.chunk_pending

    def call(self, name, *args):
        """``engine.<name>(*args)`` on both; a list of requests goes to
        the JAX engine as its own requests."""
        for side, eng in (("jax", self.jax), ("port", self.port)):
            a = [[_as_jax(r) if side == "jax" else r for r in args[0]]] \
                if args else []
            for comp in getattr(eng, name)(*a):
                self.done[side][comp.request_id] = comp
        self.check()

    def admissible(self, queue):
        n = self.port.admissible_prefix(queue)
        assert n == self.jax.admissible_prefix([_as_jax(r) for r in queue])
        return n

    def run(self, req, decode=True):
        """Admit ``req``, stream its chunks, decode until idle."""
        self.call("prefill", [req])
        while self.port.chunk_pending:
            self.call("prefill_chunk_step")
        while decode and self.port.active_count:
            self.call("step")

    def same_tokens(self):
        assert sorted(self.done["jax"]) == sorted(self.done["port"])
        for rid, comp in self.done["jax"].items():
            got = self.done["port"][rid]
            assert got.tokens == comp.tokens, rid
            assert got.prefix_hit_tokens == comp.prefix_hit_tokens, rid


def test_prefix_release_ordering(nano, port):
    """Refcounts around retirement (``test_paged.py::
    test_prefix_release_ordering``): a retired publisher's pages stay
    warm, eviction skips pages a live adopter holds, and frees them once
    it retires -- the same tables and refcounts as the JAX engine's
    after every dispatch."""
    pair = _Pair(nano, port, num_slots=3, prefill_len=8, num_pages=8,
                 **PAGED)
    pool, cache = pair.port.pool, pair.port.prefix
    pair.run(Request(id=0, prompt=SYSP, max_new_tokens=4))
    assert len(cache) == 2 and pool.free_pages == 8 - 2
    pair.run(Request(id=1, prompt=SYSP + [9], max_new_tokens=4, seed=5),
             decode=False)
    assert pool.free_pages == 8 - 4
    assert cache.evictable() == pair.jax.prefix.evictable() == 0
    assert cache.evict(10) == pair.jax.prefix.evict(10) == 0
    pair.check()
    while pair.port.active_count:
        pair.call("step")
    assert cache.evictable() == 2
    assert cache.evict(10) == pair.jax.prefix.evict(10) == 2
    pair.check()
    assert len(cache) == 0 and pool.free_pages == 8
    pair.same_tokens()


def test_eviction_under_pressure_matches_jax(nano, port):
    """Least-recently-matched pages go first under pressure
    (``test_paged.py::test_eviction_under_pressure_determinism``): the
    same page tables, refcounts, free lists and cache entries as the JAX
    engine's after every dispatch, the same two evictions, and chain A
    (re-matched) survives where chain B does not."""
    pre_a = [11, 12, 13, 14, 15, 16, 17, 18]
    pre_b = [21, 22, 23, 24, 25, 26, 27, 28]
    pair = _Pair(nano, port, num_slots=3, prefill_len=8, num_pages=8,
                 **PAGED)
    pair.run(Request(id=0, prompt=pre_a, max_new_tokens=4))
    pair.run(Request(id=1, prompt=pre_b, max_new_tokens=4, seed=3))
    pair.run(Request(id=2, prompt=pre_a + [5], max_new_tokens=4, seed=7))
    assert pair.port.prefix.evictable() == 4
    assert pair.port.pool.free_pages == 4
    pair.run(Request(id=3, prompt=list(range(40, 60)), max_new_tokens=4,
                     seed=9))
    assert pair.port.prefix.evictions == pair.jax.prefix.evictions == 2
    keys = [k for k, _ in pair.port.prefix._entries.items()]
    assert not any(k[1] == tuple(pre_b[:4]) for k in keys)
    assert any(k[1] == tuple(pre_a[:4]) for k in keys)
    pair.same_tokens()


def test_admissible_prefix_is_fifo_and_page_aware(nano, port):
    """The scheduler's probe (``test_paged.py::
    test_admissible_prefix_is_fifo_and_page_aware``): a FIFO prefix
    bounded by slots, the batched width (chunk-routed requests take none
    of it) and page demand against free plus evictable pages, as the
    JAX engine counts it."""
    small = lambda i: Request(id=i, prompt=[1], max_new_tokens=4, seed=i)
    big = Request(id=50, prompt=[1, 2], max_new_tokens=22, seed=50)
    long_r = Request(id=60, prompt=LONG, max_new_tokens=4, seed=60)
    cases = [
        (dict(num_slots=4, prefill_len=8, page_size=8, num_pages=4),
         [[small(0), big, small(1)], [big, small(1)]]),
        (dict(num_slots=4, prefill_len=8, page_size=8, num_pages=2),
         [[big, small(1)], [small(0), big]]),
        (dict(num_slots=4, prefill_len=8, page_size=4, num_pages=12,
              prefill_chunk=8, prefill_batch=1),
         [[small(0), small(1), long_r], [long_r, small(0), small(1)],
          [long_r, long_r, small(0)]]),
    ]
    counts = [[_Pair(nano, port, **kw).admissible(q) for q in queues]
              for kw, queues in cases]
    # [small, big (3 pages), small] in 4 pages: the trailing small
    # waits; one page short, nothing admits and nobody skips the head;
    # a chunk-routed request takes no batched width (prefill_batch 1),
    # a second batched one waits
    assert counts == [[2, 2], [0, 1], [1, 2, 2]]
    # evictable pages count: a published chain frees its pages on demand
    pair = _Pair(nano, port, num_slots=3, prefill_len=8, num_pages=8,
                 **PAGED)
    pair.run(Request(id=0, prompt=SYSP, max_new_tokens=4))
    queue = [Request(id=1, prompt=list(range(30, 50)), max_new_tokens=4,
                     seed=1)]                                 # 6 pages
    assert pair.port.pool.free_pages == 6
    assert pair.port.prefix.evictable() == 2
    assert pair.admissible(queue) == 1
    queue.append(small(2))                     # 2 pages: only the cache's
    assert pair.admissible(queue) == 2


# --------------------------------------------------------------------- #
# seed deferral while a prompt streams
# --------------------------------------------------------------------- #
def test_seed_collision_defer_clears_during_chunk_prefill(nano, port):
    """A queued request whose seed collides with one still chunking
    defers without wedging the loop (``test_paged.py::
    test_seed_collision_defer_clears_during_chunk_prefill``)."""
    long_p = LONG[:12]
    trace = [(0, dict(prompt=long_p, max_new_tokens=4, seed=7)),
             (0, dict(prompt=[42, 7], max_new_tokens=4, seed=7))]
    kw = dict(num_slots=4, prefill_len=8, page_size=4, prefill_chunk=8)
    ref, jsites, _ = _run_jax(nano, trace, **kw)
    out, sites, _ = _run_port(port, trace, attention_kernel="cuda", **kw)
    _same_completions(ref, out)
    assert sites == jsites
    assert {c.finish_reason for c in out.values()} == {"length"}


def test_seed_deferral_keeps_chunk_decode_alternation(nano, port):
    """A request deferred for a seed collision with an active decoder
    does not let a co-resident long prompt's chunks run back to back
    (``test_paged.py::test_seed_deferral_keeps_chunk_decode_alternation``)."""
    long_p = list(range(1, 25))                       # 3 chunks at C=8
    trace = [(0, dict(prompt=PROMPTS[0], max_new_tokens=8, seed=7)),
             (1, dict(prompt=long_p, max_new_tokens=8, seed=1)),
             (1, dict(prompt=PROMPTS[2], max_new_tokens=8, seed=7))]
    kw = dict(num_slots=4, prefill_len=8, page_size=4, prefill_chunk=8)
    ref, jsites, _ = _run_jax(nano, trace, **kw)
    out, sites, _ = _run_port(port, trace, attention_kernel="cuda", **kw)
    _same_completions(ref, out)
    assert sites == jsites
    _no_chunk_back_to_back(sites)


# --------------------------------------------------------------------- #
# page-native chunked prefill with the prefix cache
# --------------------------------------------------------------------- #
COMPOSE = [(0, dict(prompt=SYSP + [5, 17], max_new_tokens=5)),
           (6, dict(prompt=SYSP + [9], max_new_tokens=5)),
           (8, dict(prompt=SYSP + [42, 7, 3], max_new_tokens=5))]


@pytest.mark.parametrize("variant", ["f32-cuda", "int8-kv", "int8-weights"])
def test_page_native_chunked_prefix_compose(nano, port, variant):
    """Chunked prefill and prefix adoption feed pages the page-native
    decode then reads (``test_paged.py::
    test_page_native_chunked_prefix_compose``): identical tokens and
    ``prefix_hit_tokens`` to the JAX engine's."""
    pkw, jkw = VARIANTS[variant]
    kw = dict(num_slots=3, prefill_len=8, **PAGED)
    ref, jsites, jstats = _run_jax(nano, COMPOSE, **kw, **jkw)
    out, sites, stats = _run_port(port, COMPOSE, **kw, **pkw)
    _same_completions(ref, out)
    assert sites == jsites and stats == jstats
    assert out[1].prefix_hit_tokens > 0


# --------------------------------------------------------------------- #
# the chunk forward against _chunk_prefill_impl
# --------------------------------------------------------------------- #
def _jax_chunk_logits(eng, st):
    """The logits of the JAX engine's next chunk, computed as its
    ``_chunk_prefill_impl`` computes them: the row's pages gathered into
    the dense view, ``cache_index`` at the offset, the masked forward."""
    from ray_lightning_tpu.models.generate import _logits_only
    from ray_lightning_tpu.models.quant import materialize_for_program
    from ray_lightning_tpu.serve.pages import gather_pages
    C, off = eng.prefill_chunk, st.next_off
    valid = min(C, len(st.fed) - off)
    tokens = np.zeros((1, C), np.int32)
    tokens[0, :valid] = st.fed[off:off + valid]
    pt = np.array(eng.pool.page_table[st.slot])[None]
    view = gather_pages(eng.model, eng.pool.arena, pt)
    view = jax.tree_util.tree_map(
        lambda leaf: (jnp.full(leaf.shape, off, leaf.dtype)
                      if leaf.ndim < 4 else leaf), view)
    out, _ = eng.model.apply(
        {"params": materialize_for_program(eng.params, eng.model.cfg),
         "cache": view}, tokens,
        positions=off + np.arange(C, dtype=np.int32)[None],
        deterministic=True, mutable=["cache"])
    return tokens, valid, np.asarray(_logits_only(out))[0, valid - 1]


def _jax_pages(eng, layer):
    arena = eng.pool.arena
    if isinstance(arena, tuple):
        codes, scales = arena
        attn = codes["stack"][f"block_{layer}"]["attn"]
        sc = scales["stack"][f"block_{layer}"]["attn"]
        return [(np.asarray(attn[k]), np.asarray(sc[k]))
                for k in ("cached_key", "cached_value")]
    attn = arena["stack"][f"block_{layer}"]["attn"]
    return [(np.asarray(attn[k]), None)
            for k in ("cached_key", "cached_value")]


def _port_pages(eng, layer):
    kv = eng.pool.arena[layer]
    k, v, ks, vs = kv.pages()
    return [(k.numpy(), None if ks is None else ks.numpy()),
            (v.numpy(), None if vs is None else vs.numpy())]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_chunk_forward_matches_jax_chunk_prefill_impl(nano, port, kv_dtype):
    """Each chunk of a prompt that adopts a cached prefix: the port's
    ``_chunk_prefill_impl`` logits at ``valid_len - 1`` against the JAX
    computation at atol 1e-5, the same bits as the engine's dispatch
    keeps (``chunk_logits``), then every page of the arena after the
    dispatch. f32 pages at atol 1e-5. int8 pages: codes within one (an
    f32 value a last bit from a rounding edge), scales at rtol 1e-5, and
    the adopted pages another request holds keep their codes: the JAX
    chunk writes every mapped page of the row back, requantized, and the
    port writes only the chunk's."""
    pair = _Pair(nano, port, num_slots=3, prefill_len=8, num_pages=16,
                 kv_dtype=kv_dtype, **PAGED)
    pair.run(Request(id=0, prompt=SYSP + SYSP, max_new_tokens=4),
             decode=False)
    shared = [int(p) for p in pair.port.pool.page_table[0, :4]]
    before = [_port_pages(pair.port, layer) for layer in range(2)]
    jax_before = [_jax_pages(pair.jax, layer) for layer in range(2)]
    req = Request(id=1, prompt=SYSP + SYSP + LONG[:9], max_new_tokens=3,
                  seed=3)
    pair.call("prefill", [req])
    assert pair.port._chunk_queue[0].next_off == 16      # 4 pages adopted
    while pair.port.chunk_pending:
        st = pair.jax._chunk_queue[0]
        tokens, valid, want = _jax_chunk_logits(pair.jax, st)
        arena = [type(kv)(*(t.clone() if t is not None else None
                            for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)))
                 for kv in pair.port.pool.arena]
        with torch.inference_mode():
            got = _chunk_prefill_impl(
                pair.port.model, arena,
                torch.from_numpy(pair.port.pool.page_table[st.slot]),
                torch.from_numpy(tokens.astype(np.int64)), st.next_off,
                valid)
        np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=0)
        pair.call("prefill_chunk_step")
        # the dispatch keeps the logits it computed (and sampled from)
        assert torch.equal(pair.port.chunk_logits, got)
        for layer in range(2):
            for (pc, ps), (jc, js) in zip(_port_pages(pair.port, layer),
                                          _jax_pages(pair.jax, layer)):
                if ps is None:
                    np.testing.assert_allclose(pc, jc, atol=1e-5, rtol=0)
                    continue
                assert np.abs(pc.astype(np.int32)
                              - jc.astype(np.int32)).max() <= 1
                np.testing.assert_allclose(ps, js, rtol=1e-5, atol=0)
    for layer in range(2):
        for (pc, _ps), (bc, _bs) in zip(_port_pages(pair.port, layer),
                                        before[layer]):
            np.testing.assert_array_equal(pc[shared], bc[shared])
        # JAX's round trip of the shared pages keeps their codes (a
        # scale may move by an f32 ulp: ROADMAP.md C)
        for (jc, js), (bc, bs) in zip(_jax_pages(pair.jax, layer),
                                      jax_before[layer]):
            np.testing.assert_array_equal(jc[shared], bc[shared])
            if js is not None:
                np.testing.assert_allclose(js[shared], bs[shared],
                                           rtol=2.0 ** -22, atol=0)
    while pair.port.active_count:
        pair.call("step")
    pair.same_tokens()


# --------------------------------------------------------------------- #
# lifecycle and arguments
# --------------------------------------------------------------------- #
def test_cancel_mid_chunk_frees_the_slot_and_shutdown_drops_the_cache(port):
    """A request cancelled while its prompt still streams leaves the
    chunk queue and gives back its slot and pages; ``shutdown`` releases
    the cache's page references."""
    eng = ServeEngine(port, port.state_dict(), num_slots=2, prefill_len=8,
                      num_pages=16, device="cpu", **NATIVE, **PAGED)
    eng.prefill([Request(id=0, prompt=SYSP + [1], max_new_tokens=2)])
    while eng.chunk_pending:
        eng.prefill_chunk_step()
    while eng.active_count:
        eng.step()
    assert len(eng.prefix) == 2 and eng.free_pages == 14
    eng.prefill([Request(id=1, prompt=SYSP + LONG, max_new_tokens=2)])
    assert eng.chunk_pending_ids == {1}
    eng.prefill_chunk_step()
    comp = eng.cancel(1)
    assert comp.tokens == [] and comp.prefix_hit_tokens == 8
    assert eng.chunk_pending == 0 and eng.free_slots == 2
    assert eng.free_pages == 14 and eng.prefix.evictable() == 2
    pool, cache = eng.pool, eng.prefix
    eng.shutdown()
    assert len(cache) == 0 and pool.free_pages == 16
    assert eng.prefix is None and eng.pool is None


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk=0), "prefill_chunk must be >= 1"),
    (dict(prefill_chunk=6), "multiple of page_size"),
    (dict(prefill_chunk=12), "divide max_seq_len"),
    (dict(prefix_cache=True), "needs prefill_chunk"),
])
def test_chunk_arguments_are_checked(port, kw, match):
    """The JAX engine's checks of the two arguments, with its
    messages."""
    with pytest.raises(ValueError, match=match):
        ServeEngine(port, port.state_dict(), prefill_len=8, page_size=4,
                    device="cpu", **NATIVE, **kw)


@pytest.mark.parametrize("kw", [dict(prefill_chunk=8),
                                dict(prefix_cache=True)])
def test_chunk_arguments_need_the_page_arena(port, kw):
    with pytest.raises(ValueError, match="page_size"):
        ServeClient(port, port.state_dict(), prefill_len=8, device="cpu",
                    **kw)


# --------------------------------------------------------------------- #
# the allocator alone against the JAX package's
# --------------------------------------------------------------------- #
def test_page_pool_and_prefix_cache_match_jax_op_for_op(nano):
    """A seeded sequence of acquires (adopting matched chains),
    publishes, releases and evictions on both packages' ``PagePool`` and
    ``PrefixCache`` (accounting only: no arena is touched) leaves the
    same tables, refcounts, free lists, entries and statistics after
    every operation."""
    dec, _ = nano
    cfg = gpt2_config("nano", vocab_size=128, max_seq_len=32,
                      dtype=torch.float32)
    jpool = JaxPagePool(dec, num_slots=4, page_size=4, num_pages=20)
    ppool = PagePool(cfg, num_slots=4, page_size=4, num_pages=20,
                     device="meta")
    jcache, pcache = JaxPrefixCache(jpool), PrefixCache(ppool)
    rng = np.random.default_rng(0)
    prefixes = [list(rng.integers(0, 128, 12)) for _ in range(3)]
    live = []
    for i in range(40):
        op = rng.integers(0, 4)
        if op <= 1 and len(live) < 4:
            prompt = prefixes[rng.integers(0, 3)][:int(rng.integers(5, 13))]
            prompt = prompt + list(rng.integers(0, 128, rng.integers(1, 6)))
            req = dict(id=i, prompt=prompt,
                       max_new_tokens=int(rng.integers(1, 6)), seed=i)
            pages = [jcache.match(prompt), pcache.match(prompt)]
            assert pages[0] == pages[1]
            try:
                slot = jpool.acquire(JaxRequest(**req), pages[0])
            except Exception as err:           # no pages: both refuse
                with pytest.raises(Exception) as perr:
                    ppool.acquire(Request(**req), pages[1])
                assert type(perr.value).__name__ == type(err).__name__
                continue
            assert ppool.acquire(Request(**req), pages[1]) == slot
            assert jcache.publish(prompt, slot) == \
                pcache.publish(prompt, slot)
            live.append(slot)
        elif op == 2 and live:
            slot = live.pop(int(rng.integers(0, len(live))))
            jpool.release(slot)
            ppool.release(slot)
        else:
            n = int(rng.integers(1, 4))
            assert jcache.evict(n) == pcache.evict(n)
        assert jcache.evictable() == pcache.evictable()
        assert _pool_state(ppool, pcache) == _pool_state(jpool, jcache)
    assert (pcache.hits, pcache.lookups, pcache.publishes,
            pcache.evictions) == (jcache.hits, jcache.lookups,
                                  jcache.publishes, jcache.evictions)
    assert pcache.evictions > 0
    jcache.drop()
    pcache.drop()
    assert _pool_state(ppool, pcache) == _pool_state(jpool, jcache)
