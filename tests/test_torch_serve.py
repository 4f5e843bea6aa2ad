"""The port's serving stack (``ray_lightning_tpu_torch/serve``) against the JAX package.

The port's ``ServeClient`` replays the JAX suite's staggered mid-flight
``TRACE`` (nano model at vocab 128 / max_seq_len 32, f32, unrolled --
the ``serve_nano_family`` fixture, so the JAX legs run programs the
suite already compiles) beside the JAX page-native Pallas engine:
greedy tokens, finish reasons and tick-clock stamps must be identical,
in f32 and with int8 KV. Sampled streams cannot match across the two
frameworks (different random bits), so the sampling contract -- a
stream depends only on (engine seed, request seed, step) -- is held
inside the port.
"""
import numpy as np
import pytest
import torch

from ray_lightning_tpu.serve import ServeClient as JaxServeClient
from ray_lightning_tpu_torch.interop import load_flax_params
from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
from ray_lightning_tpu_torch.models import paged_attention as pa
from ray_lightning_tpu_torch.serve import (ServeClient, ServeEngine,
                                           SlotPoolFull)
from ray_lightning_tpu_torch.serve.client import UNPORTED
from ray_lightning_tpu_torch.serve.engine import UNPORTED as ENGINE_UNPORTED
from ray_lightning_tpu_torch.serve.request import Request
from test_torch_model import paged_logits

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

PROMPTS = [[5, 17, 3, 9], [9, 2, 44], [42, 7], [1]]
TRACE = [
    (0, dict(prompt=PROMPTS[0], max_new_tokens=6)),
    (0, dict(prompt=PROMPTS[1], max_new_tokens=6)),
    (3, dict(prompt=PROMPTS[2], max_new_tokens=6)),
    (5, dict(prompt=PROMPTS[3], max_new_tokens=6)),
]
PAGED = dict(page_size=4, page_native=True)


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


def _run_jax(nano, trace=TRACE, **kw):
    dec, params = nano
    client = JaxServeClient(dec, params, num_slots=3, prefill_len=8,
                            attention_kernel="pallas", **PAGED, **kw)
    out = client.serve_trace(list(trace))
    client.shutdown()
    return out


def _run_port(model, trace=TRACE, **kw):
    kw = dict(dict(num_slots=3, prefill_len=8, device="cpu", **PAGED), **kw)
    client = ServeClient(model, model.state_dict(), **kw)
    out = client.serve_trace(list(trace))
    client.shutdown()
    return out


def _same_completions(ref, out):
    assert sorted(ref) == sorted(out)
    for rid in ref:
        a, b = ref[rid], out[rid]
        assert (b.tokens, b.finish_reason) == (a.tokens, a.finish_reason), rid
        assert (b.arrival_time, b.first_token_time, b.finish_time) == (
            a.arrival_time, a.first_token_time, a.finish_time), rid


@pytest.mark.parametrize("attention_kernel", ["cuda", "torch"])
def test_greedy_tokens_match_jax_pallas_engine(nano, port, attention_kernel):
    """f32: the port's page-native engine emits exactly the JAX Pallas
    engine's greedy tokens on the staggered trace, with the same finish
    reasons and tick stamps (the scheduler is a copy)."""
    _same_completions(_run_jax(nano),
                      _run_port(port, attention_kernel=attention_kernel))


@pytest.mark.parametrize("steps", [1, 3])
def test_int8_greedy_tokens_match_jax_pallas_engine(nano, port, steps):
    """int8 KV (per-token page read-modify-requantize), steps_per_dispatch
    1 and 3. Codes can round differently across frameworks where an f32
    value lands within an ulp of a rounding edge, so where a token
    differs the test shows the JAX top-2 margin at that step is below
    1e-5 and holds the teacher-forced logits there instead (atol 1e-4);
    everywhere else tokens are identical."""
    ref = _run_jax(nano, kv_dtype="int8", steps_per_dispatch=steps)
    out = _run_port(port, kv_dtype="int8", steps_per_dispatch=steps,
                    attention_kernel="cuda")
    dec, params = nano
    for rid, comp in ref.items():
        got = out[rid].tokens
        if got == comp.tokens:
            continue
        i = next(i for i, (a, b) in enumerate(zip(comp.tokens, got))
                 if a != b)
        forced = np.array(comp.tokens[:i], np.int32)[:, None]
        jax_l, port_l = paged_logits(dec, params, [PROMPTS[rid]],
                                     kv_dtype="int8", steps=i,
                                     forced=forced)
        top2 = np.sort(jax_l[i][0])[-2:]
        assert top2[1] - top2[0] < 1e-5, (rid, i, top2)
        np.testing.assert_allclose(port_l[i], jax_l[i], atol=1e-4, rtol=0)


def test_eos_retirement_matches_jax(nano, port):
    """A request that samples its eos id retires with it, mid-flight."""
    free = _run_jax(nano)
    eos = free[0].tokens[2]
    trace = [(t, dict(kw, eos_id=eos)) for t, kw in TRACE]
    ref = _run_jax(nano, trace=trace)
    assert ref[0].finish_reason == "eos"
    _same_completions(ref, _run_port(port, trace=trace,
                                     attention_kernel="cuda"))


def test_deadlines_and_shedding_match_jax(nano, port):
    """Queue and mid-decode deadline expiry, and a request that can never
    fit (shed as rejected), land identically on the tick clock."""
    trace = [
        (0, dict(prompt=PROMPTS[0], max_new_tokens=6, deadline=3)),
        (0, dict(prompt=PROMPTS[1], max_new_tokens=6)),
        (0, dict(prompt=PROMPTS[2], max_new_tokens=6)),
        (0, dict(prompt=PROMPTS[3], max_new_tokens=6, deadline=1)),
        (1, dict(prompt=list(range(9)), max_new_tokens=2)),
    ]
    ref = _run_jax(nano, trace=trace)
    out = _run_port(port, trace=trace)
    assert {c.finish_reason for c in ref.values()} == {
        "timeout", "length", "rejected"}
    _same_completions(ref, out)


def test_kernel_path_counts_one_launch_per_layer_step_on_card(nano, port):
    """On a card the CUDA path launches the kernel once per layer per
    decode token-step (here: CPU, where the wrapper runs the plain
    version and counts nothing)."""
    pa.reset_kernel_launches()
    client = ServeClient(port, port.state_dict(), num_slots=3,
                         prefill_len=8, attention_kernel="cuda",
                         device="cpu", **PAGED)
    client.serve_trace(list(TRACE))
    assert client.engine.decode_substeps > 0
    assert pa.kernel_launches() == 0


def test_pages_lowest_first_and_freed_on_retire(port):
    """Slots and pages go lowest-index-first; a retired request's slot
    and pages return to the free lists, and its table row clears."""
    eng = ServeEngine(port, port.state_dict(), num_slots=3, prefill_len=8,
                      device="cpu", **PAGED)
    pool = eng.pool
    assert pool.pages_per_slot == 8 and pool.num_pages == 24
    reqs = [Request(id=0, prompt=[1, 2, 3], max_new_tokens=6),  # 3 pages
            Request(id=1, prompt=[4], max_new_tokens=3)]        # 1 page
    assert eng.admissible_prefix(reqs) == 2
    eng.prefill(reqs)
    np.testing.assert_array_equal(pool.page_table[0, :4], [0, 1, 2, -1])
    np.testing.assert_array_equal(pool.page_table[1, :2], [3, -1])
    assert pool.free_pages == 20 and pool.free_slots == 1
    done = []
    while len(done) < 2:
        done += eng.step()
    assert sorted(c.request_id for c in done) == [0, 1]
    assert [len(c.tokens) for c in sorted(done, key=lambda c: c.request_id)
            ] == [6, 3]
    assert pool.free_pages == 24 and pool.free_slots == 3
    assert np.all(pool.page_table == -1)
    eng.prefill([Request(id=2, prompt=[7, 7], max_new_tokens=10)])
    np.testing.assert_array_equal(pool.page_table[0, :4], [0, 1, 2, -1])


def test_admission_is_page_aware_and_atomic(port):
    """Admission stops at the first request the free pages cannot hold,
    and a batch that fails mid-way gives back what it took."""
    eng = ServeEngine(port, port.state_dict(), num_slots=3, prefill_len=8,
                      num_pages=5, device="cpu", **PAGED)
    big = Request(id=0, prompt=[1] * 8, max_new_tokens=8)        # 4 pages
    small = Request(id=1, prompt=[2], max_new_tokens=3)          # 1 page
    assert eng.admissible_prefix([big, small, small]) == 2
    clash = Request(id=2, prompt=[3], max_new_tokens=3, seed=0)  # = big's
    with pytest.raises(ValueError, match="seed"):
        eng.prefill([big, clash])
    assert eng.free_pages == 5 and eng.free_slots == 3
    with pytest.raises(SlotPoolFull):
        eng.prefill([Request(id=i, prompt=[1], max_new_tokens=1)
                     for i in range(4)])


def test_positions_clamp_at_the_last_slot_position(port):
    """A row decoding into the last position of the sequence stays
    clamped at max_seq_len − 1 and finishes on its budget."""
    eng = ServeEngine(port, port.state_dict(), num_slots=2, prefill_len=8,
                      device="cpu", **PAGED)
    eng.prefill([Request(id=0, prompt=[1] * 8, max_new_tokens=24)])
    done = []
    while not done:
        done = eng.step()
    assert len(done[0].tokens) == 24 and done[0].finish_reason == "length"
    assert eng._pos[0, 0] == 31


def test_sampled_stream_is_the_same_alone_and_cobatched(port):
    """A sampled request's tokens depend only on (engine seed, its seed,
    step): alone, or sharing the batch with others in another slot."""
    sampled = dict(prompt=PROMPTS[2], max_new_tokens=6, temperature=0.9,
                   top_k=20, seed=77)
    alone = _run_port(port, trace=[(0, sampled)])[0].tokens
    crowd = _run_port(port, trace=[(0, dict(prompt=PROMPTS[0],
                                            max_new_tokens=6)),
                                   (0, dict(prompt=PROMPTS[1],
                                            max_new_tokens=4,
                                            temperature=1.3, seed=5)),
                                   (2, sampled)])
    assert crowd[2].tokens == alone
    other_seed = _run_port(port, trace=[(0, dict(sampled, seed=78))])
    assert other_seed[0].tokens != alone
    assert _run_port(port, trace=[(0, sampled)], seed=1)[0].tokens != alone


def test_engine_defaults_to_the_card(port):
    """``device=None`` means cuda: no card, no engine (never a silent
    CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(port, port.state_dict(), num_slots=2, prefill_len=8,
                    **PAGED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeClient(port, port.state_dict(), num_slots=2, prefill_len=8,
                    **PAGED)


#: the arguments the S6 slice ported (they raised NotImplementedError
#: before it)
S6_ARGUMENTS = ("clock_epoch", "journal", "retry_policy", "telemetry")


def _s6_argument(name, jax_side, tmp_path):
    """A value of ``name`` for the JAX package's client or the port's."""
    from ray_lightning_tpu import obs as jax_obs
    from ray_lightning_tpu import reliability as jax_rel
    from ray_lightning_tpu import serve as jax_serve
    from ray_lightning_tpu_torch import obs, reliability, serve
    o, r, s = (jax_obs, jax_rel, jax_serve) if jax_side else (
        obs, reliability, serve)
    if name == "clock_epoch":
        ticks = iter(range(1000))
        return dict(clock=lambda: float(next(ticks)), clock_epoch=-2.0)
    if name == "journal":
        return dict(journal=s.Journal(tmp_path / f"{jax_side}.jsonl"))
    if name == "retry_policy":
        return dict(retry_policy=r.RetryPolicy(base_delay=0.0))
    return dict(telemetry=o.Telemetry())


@pytest.mark.parametrize("name", S6_ARGUMENTS)
def test_unported_arguments_raise(nano, port, name, tmp_path):
    """Every argument the JAX client takes is ported now (both UNPORTED
    tables are empty): each of the S6 arguments builds and serves the
    trace as the JAX client does -- tokens and stamps equal -- and an
    unknown argument still raises ``TypeError``."""
    assert UNPORTED == {} and ENGINE_UNPORTED == {}
    ref = _run_jax(nano, **_s6_argument(name, True, tmp_path))
    out = _run_port(port, **_s6_argument(name, False, tmp_path))
    _same_completions(ref, out)
    if name == "telemetry":
        eng = ServeEngine(port, port.state_dict(), num_slots=2,
                          prefill_len=8, device="cpu", **PAGED,
                          **_s6_argument(name, False, tmp_path))
        assert eng._tel is not None
        eng.shutdown()
    if name == "journal":
        assert (tmp_path / "False.jsonl").read_bytes() == \
            (tmp_path / "True.jsonl").read_bytes()
    with pytest.raises(TypeError, match="bogus"):
        ServeClient(port, port.state_dict(), device="cpu", bogus=1,
                    **_s6_argument(name, False, tmp_path))


def test_unported_layouts_and_unknown_arguments(port):
    """Every KV layout constructs (the dense slot pool by default, the
    dense-view paged path with ``page_size`` alone); the JAX engine's
    layout rules raise its ``ValueError``\ s; an unknown keyword is a
    ``TypeError``."""
    sd = port.state_dict()
    dense = ServeClient(port, sd, num_slots=2, prefill_len=8, device="cpu")
    assert not dense.engine.paged and dense.engine.free_pages is None
    dense.shutdown()
    view = ServeClient(port, sd, num_slots=2, prefill_len=8, device="cpu",
                       page_size=4)
    assert view.engine.paged and not view.engine.page_native
    view.shutdown()
    with pytest.raises(ValueError, match="page_native=True.*page_size"):
        ServeClient(port, sd, num_slots=2, prefill_len=8, device="cpu",
                    page_native=True)
    for layout in ({}, dict(page_size=4)):
        with pytest.raises(ValueError, match="attention_kernel='cuda'"):
            ServeClient(port, sd, num_slots=2, prefill_len=8, device="cpu",
                        attention_kernel="cuda", **layout)
    with pytest.raises(TypeError, match="bogus"):
        ServeClient(port, sd, device="cpu", bogus=1, **PAGED)
    # the defaults of unported arguments are accepted (None / False)
    ServeClient(port, sd, num_slots=2, prefill_len=8, device="cpu",
                prefix_cache=False, async_dispatch=False, adapters=None,
                **PAGED).shutdown()


def test_engine_validation(port):
    sd = port.state_dict()
    with pytest.raises(ValueError, match="attention_kernel"):
        ServeEngine(port, sd, device="cpu", attention_kernel="xla", **PAGED)
    with pytest.raises(ValueError, match="divide"):
        ServeEngine(port, sd, device="cpu", prefill_len=8, page_size=5,
                    page_native=True)
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeEngine(port, sd, device="cpu", prefill_len=8, kv_dtype="fp8",
                    **PAGED)
    with pytest.raises(ValueError, match="prefill_len"):
        ServeEngine(port, sd, device="cpu", prefill_len=64, **PAGED)
    client = ServeClient(port, sd, num_slots=2, prefill_len=8,
                         device="cpu", **PAGED)
    with pytest.raises(ValueError, match="prefill_len"):
        client.submit(list(range(9)), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_seq_len"):
        client.submit([1, 2], max_new_tokens=31)
    # the engine owns its own model copy, with the requested read side
    eng = ServeEngine(port, sd, device="cpu", prefill_len=8,
                      attention_kernel="cuda", **PAGED)
    assert eng.model is not port
    assert eng.model.cfg.attention_kernel == "cuda"
    assert port.cfg.attention_kernel == "torch"
