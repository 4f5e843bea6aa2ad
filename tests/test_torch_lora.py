"""The port's multi-LoRA (``models/lora.py``, ``serve/adapters.py``, the engine's adapter bank) against the JAX package.

In f32 on the CPU, with the JAX weights and the same numpy adapters:

- the port's ``Dense`` with a bank against JAX's ``LoraDenseGeneral``
  and ``LoraDense`` at 1e-6 of the output's largest magnitude, rows
  under the null adapter (−1) bitwise the port's base projection;
- the bank helpers on a port model read and write the JAX adapter-tree
  layout (an adapter extracted from either package installs into the
  other and round-trips), and ``adapter_bytes`` is JAX's;
- the registry's LRU eviction, pinning and ``UnknownAdapter`` context,
  decision for decision with the JAX registry;
- engines serving a mixed trace (rows under adapters ``a`` and ``b``
  and base rows) give the JAX engine's greedy tokens, finish reasons,
  adapter stamps and tick stamps on the dense pool, the dense view and
  page-native (JAX's Pallas engine in interpret mode), with int8 and
  int4 weights (JAX's Pallas matmul in interpret mode) and with a draft;
  inside the port the mixed run equals each request served alone;
  ``param_bytes()`` and ``adapter_bank_bytes()`` equal the JAX engine's;
- hot load, LRU eviction and unload: registry states and tokens equal
  JAX's;
- one training step of a ``lora=LoraConfig(rank, num_adapters=1)`` GPT:
  loss and every gradient, the banks' included, against
  ``jax.value_and_grad``.

The serving shapes are the JAX LoRA suite's (2 slots, prefill_len 8,
rank 2, a bank of 2) on the ``serve_nano_family`` model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import lora as jax_lora
from ray_lightning_tpu.models.gpt import GPTModule as JaxGPTModule
from ray_lightning_tpu.models.gpt import gpt2_config as jax_gpt2_config
from ray_lightning_tpu.models.quant import param_bytes as jax_param_bytes
from ray_lightning_tpu.serve import AdapterRegistry as JaxRegistry
from ray_lightning_tpu.serve import ServeClient as JaxServeClient
from ray_lightning_tpu_torch.interop import (adapter_to_numpy,
                                             flax_state_dict,
                                             load_flax_params)
from ray_lightning_tpu_torch.models import (GPTModule, TransformerConfig,
                                            TransformerLM, gpt2_config)
from ray_lightning_tpu_torch.models.lora import (LoraConfig, adapter_bytes,
                                                 extract_adapter,
                                                 install_adapter,
                                                 install_lora_bank,
                                                 zero_adapter)
from ray_lightning_tpu_torch.models.transformer import Dense
from ray_lightning_tpu_torch.serve import (AdapterBankFull, AdapterRegistry,
                                           ServeClient, ServeEngine,
                                           TenantClass, UnknownAdapter)

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

RANK, CAP = 2, 2
MK = dict(vocab_size=128, max_seq_len=32)
LTRACE = [
    (0, dict(prompt=[1, 2, 3], max_new_tokens=6, adapter="a", seed=100)),
    (0, dict(prompt=[2, 2, 3], max_new_tokens=6, adapter="b", seed=101)),
    (1, dict(prompt=[3, 2, 3], max_new_tokens=6, seed=102)),
    (2, dict(prompt=[4, 2, 3], max_new_tokens=5, adapter="a", seed=103)),
]
PAGE_NATIVE = (dict(page_size=8, num_pages=16, page_native=True,
                    attention_kernel="cuda"),
               dict(page_size=8, num_pages=16, page_native=True,
                    attention_kernel="pallas"))
LAYOUTS = {"dense": ({}, {}),
           "view": (dict(page_size=8, num_pages=16),
                    dict(page_size=8, num_pages=16)),
           "page_native": PAGE_NATIVE}


def _rand_adapter(params, seed):
    """A JAX-layout adapter tree of non-trivial numpy weights for the
    unrolled ``params`` (the shapes JAX's own bank helpers give)."""
    rng = np.random.default_rng(seed)
    tree = jax_lora.extract_adapter(jax_lora.install_lora_bank(
        params, jax_lora.LoraConfig(rank=RANK, num_adapters=1)), 0)

    def fill(t):
        return {k: fill(v) if isinstance(v, dict) else
                (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in sorted(t.items())}
    return fill(tree)


@pytest.fixture(scope="module")
def env(serve_nano_family):
    dec, params, jdraft, jdparams = serve_nano_family
    target = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, **MK), device="cpu"), params)
    draft = load_flax_params(TransformerLM(gpt2_config(
        "nano", dtype=torch.float32, n_layers=1, **MK), device="cpu"),
        jdparams)
    ads = {"a": _rand_adapter(params, 1), "b": _rand_adapter(params, 2)}
    return dict(dec=dec, params=params, jdraft=jdraft, jdparams=jdparams,
                target=target, draft=draft, ads=ads)


def _bank(adapters):
    return (dict(adapters=adapters, max_resident_adapters=CAP,
                 lora_rank=RANK) if adapters is not None else {})


def _jax_client(env, adapters, layout, draft=False, **kw):
    if draft:
        kw.update(draft_model=env["jdraft"], draft_params=env["jdparams"],
                  spec_k=2)
    return JaxServeClient(env["dec"], env["params"], num_slots=2,
                          prefill_len=8, **layout, **_bank(adapters), **kw)


def _port_client(env, adapters, layout, draft=False, **kw):
    if draft:
        kw.update(draft_model=env["draft"],
                  draft_params=env["draft"].state_dict(), spec_k=2)
    return ServeClient(env["target"], env["target"].state_dict(),
                       num_slots=2, prefill_len=8, device="cpu", **layout,
                       **_bank(adapters), **kw)


def _serve(client, trace):
    out = client.serve_trace(list(trace))
    return out


def _same(ref, out):
    assert sorted(ref) == sorted(out)
    for rid in ref:
        a, b = ref[rid], out[rid]
        assert (b.tokens, b.finish_reason, b.adapter, b.tenant) == (
            a.tokens, a.finish_reason, a.adapter, a.tenant), rid
        assert (b.arrival_time, b.first_token_time, b.finish_time) == (
            a.arrival_time, a.first_token_time, a.finish_time), rid


# ------------------------------------------------------------ the layer
def _dense_pair(general: bool, seed: int):
    """JAX's LoRA layer and the port's Dense holding the same numpy
    weights and bank (random, bank slots 0 and 2 non-zero)."""
    d, H, D, ff = 16, 2, 4, 24
    rng = np.random.default_rng(seed)
    jcfg = jax_lora.LoraConfig(rank=3, num_adapters=3, alpha=6.0)
    if general:
        mod = jax_lora.LoraDenseGeneral(features=(3, H, D), in_features=d,
                                        lora=jcfg, dtype=jnp.float32)
        out = 3 * H * D
    else:
        mod = jax_lora.LoraDense(features=ff, in_features=d, lora=jcfg,
                                 dtype=jnp.float32)
        out = ff
    x = rng.standard_normal((4, 5, d)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, mod.init(
        jax.random.PRNGKey(0), x, np.zeros((4,), np.int32))["params"])
    params = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
              for k, v in params.items()}
    params["lora_A"][1] = 0.0
    params["lora_B"][1] = 0.0
    cfg = TransformerConfig(dtype=torch.float32)
    port = Dense(d, out, cfg, "cpu", lora=jax_lora_to_port(jcfg))
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(params["kernel"].reshape(d, -1).T))
        port.bias.copy_(torch.from_numpy(params["bias"].reshape(-1)))
        port.lora_A.copy_(torch.from_numpy(params["lora_A"]))
        port.lora_B.copy_(torch.from_numpy(params["lora_B"]))
    return mod, params, port, x


def jax_lora_to_port(jcfg):
    """The JAX config as the port's config takes it: by its fields."""
    return TransformerConfig(lora=jcfg).lora


@pytest.mark.parametrize("general", [True, False], ids=["general", "dense"])
def test_lora_dense_matches_jax_and_null_rows_are_the_base(general):
    mod, params, port, x = _dense_pair(general, seed=0)
    for ids in ([0, 2, -1, 1], None):
        jids = None if ids is None else np.asarray(ids, np.int32)
        want = np.asarray(mod.apply({"params": params}, x, jids))
        with torch.no_grad():
            got = port(torch.from_numpy(x), None if ids is None
                       else torch.tensor(ids))
        # 1e-6 of the output's scale: f32 sums in another order
        np.testing.assert_allclose(
            got.numpy(), want.reshape(got.shape),
            atol=1e-6 * max(1.0, float(np.abs(want).max())), rtol=0)
    with torch.no_grad():
        base = torch.nn.functional.linear(torch.from_numpy(x), port.weight,
                                          port.bias)
        mixed = port(torch.from_numpy(x), torch.tensor([-1, 0, -1, 2]))
    assert torch.equal(mixed[0], base[0]) and torch.equal(mixed[2], base[2])
    assert not torch.equal(mixed[1], base[1])


def test_config_takes_the_jax_lora_config_by_its_fields():
    jcfg = jax_lora.LoraConfig(rank=4, num_adapters=2, targets=("qkv", "up"),
                               alpha=8.0)
    cfg = TransformerConfig(lora=jcfg)
    assert cfg.lora == LoraConfig(rank=4, num_adapters=2,
                                  targets=("qkv", "up"), alpha=8.0)
    assert cfg.lora.scale == jcfg.scale == 2.0
    assert hash(cfg) == hash(TransformerConfig(lora=cfg.lora))
    model = TransformerLM(dataclasses.replace(
        gpt2_config("nano", **MK), lora=jcfg), device="cpu")
    banks = sorted({n.split(".")[-2] for n, _ in model.named_parameters()
                    if "lora_" in n})
    assert banks == ["qkv", "up"]
    with pytest.raises(ValueError, match="rank must be >= 1"):
        LoraConfig(rank=0)
    with pytest.raises(ValueError, match="unknown lora targets"):
        LoraConfig(rank=1, targets=("qkv", "bogus"))


# ------------------------------------------------------- bank helpers
def test_bank_helpers_speak_the_jax_adapter_tree(env):
    """A JAX adapter tree installs into a port bank slot and comes back
    out equal; a port-extracted tree installs into a JAX bank equal;
    zeroing a slot leaves zeros; the per-slot bytes are JAX's."""
    params, target = env["params"], env["target"]
    jbank = jax_lora.install_lora_bank(params, jax_lora.LoraConfig(
        rank=RANK, num_adapters=CAP))
    model = load_flax_params(TransformerLM(target.cfg, device="cpu"), params)
    install_lora_bank(model, LoraConfig(rank=RANK, num_adapters=CAP))
    assert model.cfg.lora == LoraConfig(rank=RANK, num_adapters=CAP)
    assert adapter_bytes(model) == jax_lora.adapter_bytes(jbank)
    install_adapter(model, env["ads"]["a"], 1)
    got = adapter_to_numpy(extract_adapter(model, 1))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                           env["ads"]["a"])
    back = jax_lora.extract_adapter(jax_lora.install_adapter(jbank, got, 0),
                                    0)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b), back, env["ads"]["a"])
    zero_adapter(model, 1)
    assert all(not np.any(v) for v in jax.tree_util.tree_leaves(
        adapter_to_numpy(extract_adapter(model, 1))))
    # a model the JAX bank was loaded into carries the banks across
    ported = load_flax_params(TransformerLM(dataclasses.replace(
        target.cfg, lora=LoraConfig(rank=RANK, num_adapters=CAP)),
        device="cpu"), jax_lora.install_adapter(jbank, env["ads"]["b"], 1))
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           adapter_to_numpy(extract_adapter(ported, 1)),
                           env["ads"]["b"])


def test_bank_helpers_validate_as_jax_does(env):
    target = env["target"]
    with pytest.raises(ValueError, match="no lora banks"):
        extract_adapter(target)
    model = TransformerLM(target.cfg, device="cpu")
    install_lora_bank(model, LoraConfig(rank=RANK, num_adapters=CAP))
    with pytest.raises(ValueError, match="out of range"):
        extract_adapter(model, CAP)
    bad = jax_lora.extract_adapter(jax_lora.install_lora_bank(
        env["params"], jax_lora.LoraConfig(rank=3, num_adapters=1)), 0)
    with pytest.raises(ValueError, match="shape mismatch at"):
        install_adapter(model, bad, 0)
    partial = {"stack": {"block_0": env["ads"]["a"]["stack"]["block_0"]}}
    with pytest.raises(ValueError, match="missing an entry"):
        install_adapter(model, partial, 0)


# ---------------------------------------------------------- registry
def _registry_script(cls, unknown, bank_full):
    """The JAX suite's registry scenarios, run on ``cls``; returns every
    observable step."""
    seen = []
    reg = cls(2)
    seen += [reg.admit("a"), reg.admit("b"), reg.admit("c"),
             reg.residents]
    reg.bind("b")
    reg.unbind("b")
    seen += [reg.admit("d"), reg.evictions, reg.loads]
    reg = cls(2)
    reg.admit("a")
    reg.admit("b")
    reg.bind("a")
    reg.bind("b")
    with pytest.raises(bank_full) as exc:
        reg.admit("c")
    seen.append((exc.value.capacity, exc.value.pinned))
    with pytest.raises(Exception, match="in-flight"):
        reg.unload("a")
    reg.unbind("a")
    seen.append(reg.admit("c"))
    with pytest.raises(ValueError, match="without a matching bind"):
        reg.unbind("a")
    reg = cls(1, bytes_per_adapter=10)
    reg.admit("a")
    with pytest.raises(unknown) as exc:
        reg.index_of("ghost")
    err = exc.value
    assert isinstance(err, ValueError)
    seen += [(err.adapter, err.resident, err.capacity),
             reg.resident_bytes()]
    reg.unload("a")
    seen += [reg.resident_bytes(), reg.admit("a")]
    return seen


def test_registry_decides_as_the_jax_registry():
    from ray_lightning_tpu.serve.adapters import AdapterBankFull as JaxFull
    from ray_lightning_tpu.serve.adapters import UnknownAdapter as JaxUnknown
    want = _registry_script(JaxRegistry, JaxUnknown, JaxFull)
    got = _registry_script(AdapterRegistry, UnknownAdapter, AdapterBankFull)
    assert got == want
    assert want[2] == (0, "a") and want[4] == (0, "c")


# ------------------------------------------------------ engines vs JAX
ENGINES = [
    pytest.param("dense", {}, id="dense"),
    pytest.param("view", {}, id="view"),
    pytest.param("page_native", {}, id="page_native"),
    pytest.param("page_native", dict(weight_dtype="int8"),
                 id="page_native-int8"),
    pytest.param("page_native", dict(weight_dtype="int4",
                                     weight_group_size=8),
                 id="page_native-int4"),
]


@pytest.mark.parametrize("layout,weights", ENGINES)
def test_mixed_adapter_engine_matches_jax(env, layout, weights):
    """The mixed trace: the JAX engine's tokens, finish reasons, adapter
    and tick stamps; bytes as JAX counts them; inside the port each
    request's tokens equal its solo run's."""
    port_kw, jax_kw = LAYOUTS[layout]
    pmm = dict(matmul_kernel="cuda") if weights else {}
    jmm = dict(matmul_kernel="pallas") if weights else {}
    jclient = _jax_client(env, env["ads"], jax_kw, **weights, **jmm)
    ref = _serve(jclient, LTRACE)
    jbytes = jax_param_bytes(jclient.engine.params)
    jbank = jclient.engine.adapter_bank_bytes()
    jclient.shutdown()
    client = _port_client(env, env["ads"], port_kw, **weights, **pmm)
    out = _serve(client, LTRACE)
    assert client.engine.param_bytes() == jbytes
    assert client.engine.adapter_bank_bytes() == jbank > 0
    client.shutdown()
    _same(ref, out)
    assert {r: c.adapter for r, c in out.items()} == {
        0: "a", 1: "b", 2: None, 3: "a"}
    for rid, (_, kw) in enumerate(LTRACE):
        solo = _port_client(env, env["ads"], port_kw, **weights, **pmm)
        sid = solo.submit(**kw)
        assert solo.run_until_idle()[sid].tokens == out[rid].tokens, rid
        solo.shutdown()


def test_adapters_bite_and_null_rows_are_the_bankless_engine(env):
    """Adapted rows differ from the base model's stream; a base row on
    the armed engine is the bankless engine's, stamp for stamp."""
    port_kw = PAGE_NATIVE[0]
    armed = _serve(_port_client(env, env["ads"], port_kw), LTRACE)
    plain = [(t, {k: v for k, v in kw.items() if k != "adapter"})
             for t, kw in LTRACE]
    bare = _serve(_port_client(env, None, port_kw), plain)
    assert armed[0].tokens != bare[0].tokens
    assert armed[1].tokens != bare[1].tokens
    assert armed[2].tokens == bare[2].tokens


def test_spec_with_adapters_matches_jax(env):
    """The rows' adapter ids reach the target's verify only; the draft is
    unadapted. Tokens and stamps equal the JAX spec engine's, and the
    non-spec adapted engine's tokens."""
    port_kw, jax_kw = PAGE_NATIVE
    jclient = _jax_client(env, env["ads"], jax_kw, draft=True)
    ref = _serve(jclient, LTRACE)
    jclient.shutdown()
    out = _serve(_port_client(env, env["ads"], port_kw, draft=True), LTRACE)
    _same(ref, out)
    plain = _serve(_port_client(env, env["ads"], port_kw), LTRACE)
    assert {r: c.tokens for r, c in plain.items()} == {
        r: c.tokens for r, c in out.items()}


def test_adapted_rows_equal_a_merged_weight_engine(env):
    """An adapted row's greedy tokens are those of a bankless engine
    whose weights hold W + scale * A @ B (each targeted kernel merged in
    the flax layout)."""
    params, tree = env["params"], env["ads"]["a"]

    def merge(p, t):
        if "lora_A" in t:
            k = np.asarray(p["kernel"])
            delta = (t["lora_A"] @ t["lora_B"]).reshape(k.shape)
            return dict(p, kernel=k + delta)
        return {key: merge(p[key], t[key]) if key in t else p[key]
                for key in p}
    merged = load_flax_params(TransformerLM(env["target"].cfg, device="cpu"),
                              merge(params, tree))
    port_kw = PAGE_NATIVE[0]
    trace = [LTRACE[0]]
    armed = _serve(_port_client(env, {"a": tree}, port_kw), trace)
    client = ServeClient(merged, merged.state_dict(), num_slots=2,
                         prefill_len=8, device="cpu", **port_kw)
    plain = _serve(client, [(0, dict(trace[0][1], adapter=None))])
    assert armed[0].tokens == plain[0].tokens


def test_hot_load_eviction_and_unload_match_jax(env):
    """Loading past capacity evicts the least-recently-bound unpinned
    resident; the evictee sheds with UnknownAdapter carrying the
    residents; a request on the reloaded slot gives JAX's tokens;
    unloading frees the slot. Registry states equal JAX's at every
    step."""
    ads = env["ads"]
    port_kw, jax_kw = LAYOUTS["dense"]
    states = []
    for make, unknown in ((_jax_client, None), (_port_client, None)):
        c = make(env, {"a": ads["a"]}, jax_kw if make is _jax_client
                 else port_kw)
        seen = [c.load_adapter("b", ads["b"]), c.load_adapter("c", ads["a"]),
                list(c.engine.resident_adapters)]
        with pytest.raises(ValueError) as exc:
            c.submit([1, 2, 3], max_new_tokens=4, adapter="a")
        seen.append((type(exc.value).__name__, exc.value.resident))
        rid = c.submit(**dict(LTRACE[0][1], adapter="c"))
        done = c.run_until_idle()[rid]
        seen += [done.tokens, done.adapter, c.engine.adapter_refcount("c")]
        c.unload_adapter("c")
        seen.append(list(c.engine.resident_adapters))
        with pytest.raises(ValueError, match="not resident"):
            c.unload_adapter("c")
        c.shutdown()
        states.append(seen)
    assert states[1] == states[0]
    assert states[0][1] == "a" and states[0][2] == ["b", "c"]


def test_unknown_adapter_sheds_in_a_trace_as_jax_does(env):
    trace = LTRACE + [(3, dict(prompt=[5, 2, 3], max_new_tokens=4,
                               adapter="ghost", seed=109))]
    port_kw, jax_kw = LAYOUTS["dense"]
    jclient = _jax_client(env, env["ads"], jax_kw)
    ref = _serve(jclient, trace)
    jclient.shutdown()
    out = _serve(_port_client(env, env["ads"], port_kw), trace)
    _same(ref, out)
    assert out[4].finish_reason == "rejected" and out[4].adapter == "ghost"


def test_tenant_default_adapter_binds_at_admission(env):
    """``TenantClass.adapter=`` is the class's default, stamped on the
    completion; an explicit adapter wins. Tokens equal the mixed run's."""
    port_kw = LAYOUTS["dense"][0]
    base = _serve(_port_client(env, env["ads"], port_kw), LTRACE)
    client = _port_client(env, env["ads"], port_kw,
                          tenant_classes=[TenantClass("tuned",
                                                      adapter="a")])
    rid = client.submit(prompt=[1, 2, 3], max_new_tokens=6, tenant="tuned",
                        seed=100)
    rid_b = client.submit(prompt=[2, 2, 3], max_new_tokens=6,
                          tenant="tuned", adapter="b", seed=101)
    out = client.run_until_idle()
    client.shutdown()
    assert (out[rid].adapter, out[rid].tenant) == ("a", "tuned")
    assert out[rid].tokens == base[0].tokens
    assert out[rid_b].adapter == "b" and out[rid_b].tokens == base[1].tokens


def test_engine_arming_validation_and_disarmed_surface(env):
    target = env["target"]
    sd = target.state_dict()
    for kw, match in ((dict(adapters={"a": env["ads"]["a"]}),
                       "max_resident_adapters"),
                      (dict(max_resident_adapters=2), "lora_rank"),
                      (dict(lora_rank=2), "max_resident_adapters"),
                      (dict(max_resident_adapters=1, lora_rank=RANK,
                            adapters=env["ads"]), "max_resident_adapters")):
        with pytest.raises(ValueError, match=match):
            ServeEngine(target, sd, num_slots=2, prefill_len=8,
                        device="cpu", **kw)
    client = ServeClient(target, sd, num_slots=2, prefill_len=8,
                         device="cpu")
    eng = client.engine
    assert eng._registry is None and eng.resident_adapters == []
    assert eng.adapter_bank_bytes() == 0
    with pytest.raises(ValueError, match="no adapter bank"):
        client.load_adapter("a", {})
    with pytest.raises(UnknownAdapter):
        client.submit([1, 2, 3], max_new_tokens=4, adapter="a")
    client.shutdown()


def test_quantized_engine_keeps_the_bank_full_precision(env):
    """int8 weights: the bank is grafted after quantization, f32, and the
    base projections stay quantized codes (the delta rides outside)."""
    port_kw = PAGE_NATIVE[0]
    client = _port_client(env, env["ads"], port_kw, weight_dtype="int8",
                          matmul_kernel="cuda")
    eng = client.engine
    qkv = eng.model.stack.blocks[0].attn.qkv
    assert qkv.qweight is not None and qkv.lora_A.dtype == torch.float32
    assert not hasattr(qkv, "weight") or qkv.weight is None
    client.shutdown()


# ------------------------------------------------------------ training
def test_lora_training_step_matches_jax_value_and_grad():
    """One step of a nano GPT with ``lora=LoraConfig(rank=2,
    num_adapters=1)`` (every row trains bank slot 0): the loss and every
    gradient, the banks' included, against ``jax.value_and_grad``."""
    nano = dict(vocab_size=256, max_seq_len=32)
    jlora = jax_lora.LoraConfig(rank=2, num_adapters=1)
    jmod = JaxGPTModule(config=jax_gpt2_config(
        "nano", attention_impl="flash", dtype=jnp.float32, lora=jlora,
        **nano), batch_size=4)
    jmodel = jmod.configure_model()
    batch = next(iter(jmod.train_dataloader()))
    params = jmodel.init(jax.random.PRNGKey(0), batch[0])["params"]
    # a trained-looking bank: both halves non-zero, so every bank
    # gradient is non-trivial
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (0.1 * rng.standard_normal(v.shape)).astype(
            np.float32) if "lora_" in jax.tree_util.keystr(path)
        else np.asarray(v), params)

    def loss_fn(p):
        return jmod._loss(jmodel, {"params": p}, batch,
                          jax.random.PRNGKey(1), True)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    module = GPTModule(config=gpt2_config(
        "nano", attention_impl="flash", dtype=torch.float32, lora=jlora,
        **nano), batch_size=4)
    model = load_flax_params(TransformerLM(module.cfg, device="cpu"), params)
    loss, _ = module._loss(model, tuple(torch.from_numpy(np.asarray(x))
                                        for x in batch))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-6
    want = flax_state_dict(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    assert any("lora_A" in n for n in got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g, atol=1e-6, rtol=0,
                                   err_msg=name)
