"""The port's optimizer presets (``core/optim.py``) against optax.

``make_optimizer("adamw_bf16m")`` and ``make_optimizer("adafactor")`` --
with ``moment_dtype=`` and ``factored=`` overrides -- against the JAX
package's ``make_optimizer`` (optax) on one fixed gradient sequence, over
a tree whose adafactor state meets both branches (params with two
dimensions of at least 128 are factored, the rest keep a full second
moment):

- step for step from optax's own state: after each of 5 steps the params
  at atol 1e-6; the f32 state at rtol 1e-5 and the bf16 state within one
  bf16 ulp (2**-7 relative), each plus 1e-6 of the tensor's largest
  magnitude for elements where the momentum's two terms cancel;
- free-running for 5 steps: params at atol 1e-6. Adafactor's bf16
  momentum is the exception: its f32 means (the factored second moment,
  the clipping RMS) sum in another order than XLA's, which turns an
  occasional bf16 rounding of the stored momentum the other way; the
  update uses the momentum before that rounding, so each such flip moves
  a later update by at most one bf16 ulp of the momentum, and the bound
  is 1e-6 plus one such ulp per step.

Then ``opt_state_bytes`` against JAX's, the JAX package's
memory-ordering, weight-decay and ``b2`` contracts, the bf16 state
surviving a ``state_dict`` round trip, and each preset training nano GPT.
"""
import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp
from ray_lightning_tpu.core.optim import make_optimizer as jax_make_optimizer
from ray_lightning_tpu.core.optim import opt_state_bytes as jax_state_bytes
from ray_lightning_tpu_torch import GPTModule, RayStrategy, Trainer
from ray_lightning_tpu_torch.core.optim import (OPTIMIZER_NAMES,
                                                make_optimizer,
                                                opt_state_bytes)

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

# (256, 200) and (130, 4, 140) factor (two dims >= 128); (64, 32), (200,)
# and (3, 130) keep a full second moment
SHAPES = {"w": (256, 200), "t": (130, 4, 140), "m": (64, 32), "b": (200,),
          "r": (3, 130)}
STEPS = 5


def _params_and_grads(seed=0):
    rng = np.random.default_rng(seed)
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
    grads = [{n: (scale * rng.standard_normal(s)).astype(np.float32)
              for n, s in SHAPES.items()}
             for scale in (0.05, 2.0, 0.1, 1.0, 3.0)]
    return init, grads


class _Params(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        for n, v in init.items():
            self.register_parameter(n, torch.nn.Parameter(
                torch.from_numpy(v.copy())))


def _run_optax(tx, init, grads):
    """optax's params and state after each step (the initial pair first)."""
    params = {n: jnp.asarray(v) for n, v in init.items()}
    state = tx.init(params)
    out = [(params, state)]
    for g in grads:
        updates, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        out.append((params, state))
    return out


def _step(model, opt, grad):
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(grad[n])
    opt.step()


# the port's per-param state key -> optax's state field
STATE_KEYS = {"mu": "mu", "nu": "nu", "v_row": "v_row", "v_col": "v_col",
              "v": "v", "ema": "ema"}


def _optax_state(state, key):
    return optax.tree_utils.tree_get(state, key)


def _force_state(model, opt, state, count):
    """Make the port's optimizer state optax's ``state``."""
    for key in opt._COUNTS:
        opt.state[key] = torch.tensor(count, dtype=torch.int32)
    for n, p in model.named_parameters():
        for key in opt.state[p]:
            opt.state[p][key] = torch.from_numpy(np.array(
                _optax_state(state, STATE_KEYS[key])[n].astype(
                    jnp.float32))).to(opt.state[p][key].dtype)


CASES = {
    "adamw_bf16m": dict(name="adamw_bf16m", weight_decay=0.1, b2=0.95),
    "adamw_moment_bf16": dict(name="adamw", moment_dtype="bfloat16"),
    "adamw_bf16m_f32_override": dict(name="adamw_bf16m",
                                     moment_dtype="float32"),
    "adafactor": dict(name="adafactor", weight_decay=0.1),
    "adafactor_unfactored": dict(name="adafactor", factored=False),
    "adamw_factored": dict(name="adamw", factored=True),
    "adafactor_f32_momentum": dict(name="adafactor",
                                   moment_dtype="float32"),
}
LR = 1e-2


def _jax_kwargs(kw):
    kw = dict(kw)
    if "moment_dtype" in kw:
        kw["moment_dtype"] = getattr(jnp, kw["moment_dtype"])
    return kw


def _both(case):
    kw = CASES[case]
    init, grads = _params_and_grads()
    ref = _run_optax(jax_make_optimizer(learning_rate=LR, **_jax_kwargs(kw)),
                     init, grads)
    model = _Params(init)
    return kw, grads, ref, model, make_optimizer(learning_rate=LR, **kw)(
        model.parameters())


@pytest.mark.parametrize("case", sorted(CASES))
def test_presets_match_optax_step_for_step(case):
    kw, grads, ref, model, opt = _both(case)
    _step(model, opt, {n: np.zeros(s, np.float32)
                       for n, s in SHAPES.items()})  # materialize the state
    for k, g in enumerate(grads):
        params, state = ref[k]
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(torch.from_numpy(np.asarray(params[n])))
        _force_state(model, opt, state, k)
        _step(model, opt, g)
        want_p, want_s = ref[k + 1]
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(want_p[n]), atol=1e-6,
                                       rtol=0, err_msg=f"{case} step {k}: {n}")
            for key, t in opt.state[p].items():
                want = np.asarray(_optax_state(want_s, STATE_KEYS[key])[n]
                                  .astype(jnp.float32))
                rtol = 2.0 ** -7 if t.dtype == torch.bfloat16 else 1e-5
                np.testing.assert_allclose(
                    t.float().numpy(), want, rtol=rtol,
                    atol=1e-6 * np.abs(want).max(),
                    err_msg=f"{case} step {k}: {n} {key}")
    assert opt_state_bytes(opt) == jax_state_bytes(ref[-1][1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_presets_match_optax_free_running(case):
    kw, grads, ref, model, opt = _both(case)
    for g in grads:
        _step(model, opt, g)
    want = ref[-1][0]
    flips = kw["name"] == "adafactor" or kw.get("factored")
    flips = flips and kw.get("moment_dtype") != "float32"
    for n, p in model.named_parameters():
        atol = 1e-6
        if flips:
            ema = opt.state[p]["ema"].float().abs().max().item()
            atol += STEPS * 2.0 ** -8 * ema
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]),
                                   atol=atol, rtol=0, err_msg=f"{case}: {n}")
    assert opt_state_bytes(opt) == jax_state_bytes(ref[-1][1])


def test_adafactor_meets_both_branches():
    init, _ = _params_and_grads()
    model = _Params(init)
    opt = make_optimizer("adafactor")(model.parameters())
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    full = {n for n, p in model.named_parameters()
            if opt.state[p]["v"].shape == p.shape}
    assert full == {"m", "b", "r"}
    # optax keeps the mean over the largest dimension as the "row"
    assert tuple(opt.state[model.w]["v_row"].shape) == (200,)
    assert tuple(opt.state[model.w]["v_col"].shape) == (256,)
    assert tuple(opt.state[model.t]["v_row"].shape) == (130, 4)
    assert tuple(opt.state[model.t]["v_col"].shape) == (4, 140)
    assert opt.state[model.w]["ema"].dtype == torch.bfloat16


def test_adamw_state_bytes_beside_optax():
    """torch's AdamW keeps a step count per tensor where optax keeps one:
    the moments' bytes are equal."""
    init, grads = _params_and_grads()
    jstate = _run_optax(jax_make_optimizer("adamw", 1e-3), init, grads)[-1][1]
    model = _Params(init)
    opt = make_optimizer("adamw", 1e-3)(model.parameters())
    _step(model, opt, grads[0])
    assert opt_state_bytes(opt) == jax_state_bytes(jstate) + 4 * (
        len(SHAPES) - 1)


def test_state_memory_ordering():
    """adafactor << adamw_bf16m < adamw state bytes, as the JAX package's
    contract on a transformer-shaped tree."""
    shapes = {"wte": (512, 256), "in": (256, 1024), "out": (1024, 256),
              "scale": (256,), "bias": (256,)}
    n_params = sum(int(np.prod(s)) for s in shapes.values())
    model = _Params({n: np.ones(s, np.float32) for n, s in shapes.items()})
    sizes = {}
    for name in OPTIMIZER_NAMES:
        opt = make_optimizer(name, 1e-3)(model.parameters())
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        sizes[name] = opt_state_bytes(opt)
    assert sizes["adamw"] >= 8 * n_params
    assert sizes["adamw_bf16m"] <= 0.80 * sizes["adamw"]
    assert sizes["adafactor"] <= 0.40 * sizes["adamw"]


def test_weight_decay_parity_across_presets():
    """With zero gradients one step shrinks params by lr * wd in every
    preset (adafactor's decay rate is scaled by the learning rate)."""
    lr, wd = 3e-4, 0.1
    for name in OPTIMIZER_NAMES:
        model = _Params({"w": np.ones((4, 4), np.float32)})
        opt = make_optimizer(name, lr, weight_decay=wd)(model.parameters())
        model.w.grad = torch.zeros_like(model.w)
        opt.step()
        shrink = 1.0 - float(model.w.detach().mean())
        np.testing.assert_allclose(shrink, lr * wd, rtol=1e-3,
                                   err_msg=name)


def test_factored_override_is_honored():
    model = _Params({"w": np.ones((256, 256), np.float32)})
    sizes = {}
    for factored in (False, None):
        opt = make_optimizer("adafactor", 1e-3, factored=factored)(
            model.parameters())
        model.w.grad = torch.ones_like(model.w)
        opt.step()
        sizes[factored] = opt_state_bytes(opt)
    assert sizes[False] > 2 * sizes[None]


def test_unknown_name_and_ignored_b2():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd", 1e-3)
    with pytest.warns(UserWarning, match="b2=0.95 is ignored"):
        make_optimizer("adafactor", 1e-3, b2=0.95)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        make_optimizer("adafactor", 1e-3)


@pytest.mark.parametrize("name", ["adamw_bf16m", "adafactor"])
def test_low_precision_state_survives_a_round_trip(name):
    """``Optimizer.load_state_dict`` casts floating state to the param's
    dtype; the presets put bf16 back, so a resumed run continues bit for
    bit."""
    init, grads = _params_and_grads()
    a = _Params(init)
    opt_a = make_optimizer(name, 1e-2)(a.parameters())
    for g in grads[:3]:
        _step(a, opt_a, g)
    b = _Params({n: p.detach().numpy() for n, p in a.named_parameters()})
    opt_b = make_optimizer(name, 1e-2)(b.parameters())
    opt_b.load_state_dict(opt_a.state_dict())
    key = "mu" if name == "adamw_bf16m" else "ema"
    assert opt_b.state[b.w][key].dtype == torch.bfloat16
    assert opt_b.state["count"].dtype == torch.int32
    for model, opt in ((a, opt_a), (b, opt_b)):
        for g in grads[3:]:
            _step(model, opt, g)
    for n in SHAPES:
        assert torch.equal(getattr(a, n), getattr(b, n)), n


@pytest.mark.parametrize("name", ["adamw_bf16m", "adafactor"])
def test_memory_efficient_presets_learn_gpt(name, tmp_path):
    """The JAX package's gate on the training path: nano GPT's validation
    perplexity drops under each preset."""
    module = GPTModule(size="nano", batch_size=8, seq_len=32,
                       num_samples=64, vocab_size=64, lr=1e-2,
                       optimizer=name)
    trainer = Trainer(strategy=RayStrategy(device="cpu"), max_epochs=3,
                      seed=0, limit_val_batches=2, num_sanity_val_steps=0,
                      default_root_dir=str(tmp_path))
    trainer.fit(module)
    ppl = float(trainer.callback_metrics["val_ppl"])
    assert ppl < 40, f"{name}: val perplexity did not drop (ppl={ppl})"


def _scanned_nano_gpt():
    """The JAX nano GPT as it trains (layers scanned: one leaf of each
    block parameter over both layers), f32, and the port's GPTModule
    config of the same sizes."""
    import jax
    from ray_lightning_tpu.models.gpt import GPTModule as JaxGPTModule
    from ray_lightning_tpu.models.gpt import gpt2_config as jax_gpt2_config
    from ray_lightning_tpu_torch.models import gpt2_config
    sizes = dict(vocab_size=256, max_seq_len=32)
    jcfg = jax_gpt2_config("nano", dtype=jnp.float32, **sizes)
    assert jcfg.scan_layers
    params = JaxGPTModule(config=jcfg).configure_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return params, gpt2_config("nano", dtype=torch.float32, **sizes)


# per step: the scale of layer 0's gradients, of layer 1's, and of the
# unstacked leaves'. Layer 0's grow and layer 1's shrink, so their
# update RMS differ, and the clip of a stacked leaf binds on their joint
# RMS, which clipping each layer alone would not give
GPT_SCALES = [(0.1, 1.0, 0.5), (1.0, 0.3, 2.0), (3.0, 0.2, 0.1),
              (0.5, 1.0, 1.0), (4.0, 0.1, 3.0)]


def _gpt_grads(params, seed=1):
    import jax
    rng = np.random.default_rng(seed)
    paths = jax.tree_util.tree_flatten_with_path(params)[0]
    out = []
    for s0, s1, s_flat in GPT_SCALES:
        leaves = []
        for path, x in paths:
            g = rng.standard_normal(x.shape).astype(np.float32)
            if "layers" in jax.tree_util.keystr(path):
                g[0] *= s0
                g[1] *= s1
            else:
                g *= s_flat
            leaves.append(g)
        out.append(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params), leaves))
    return out


def test_adafactor_matches_optax_step_for_step_on_the_scanned_gpt():
    """``GPTModule``'s adafactor, on the leaves of the JAX model
    (``transformer.jax_leaves``), against optax on the scanned nano GPT
    tree: the same gradients (each leaf's numpy array, in the port's
    layout by ``interop.flax_state_dict``), 5 steps, params after every
    step at atol 1e-6. The fused qkv weight keeps its second moment
    whole and each stacked leaf is clipped by its joint RMS, which
    binds (checked on optax's own scaled updates). Momentum in f32: a
    bf16 one may round the other way (``test_presets_match_optax_free_running``).
    With each tensor a leaf of its own (``leaves=None``) the port
    departs from optax here: the leaves decide the update."""
    import jax
    from ray_lightning_tpu_torch.interop import (flax_state_dict,
                                                 load_flax_params)
    from ray_lightning_tpu_torch.models import TransformerLM
    from ray_lightning_tpu_torch.models.transformer import jax_leaves
    params, cfg = _scanned_nano_gpt()
    grads = _gpt_grads(params)
    kw = dict(weight_decay=0.1, moment_dtype="float32")
    tx = jax_make_optimizer("adafactor", LR, **_jax_kwargs(kw))
    jp, state = params, tx.init(params)
    want = []
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        want.append(flax_state_dict(jax.tree_util.tree_map(np.asarray, jp)))
    # the clip binds: optax's scaled update has a block RMS above 1
    srms = optax.scale_by_factored_rms()
    sst = srms.init(params)
    rms = []
    for g in grads:
        u, sst = srms.update(g, sst, params)
        rms += [float(jnp.sqrt(jnp.mean(jnp.square(x))))
                for x in jax.tree_util.tree_leaves(u)]
    assert max(rms) > 1.5

    def run(leaves):
        model = load_flax_params(TransformerLM(cfg, device="cpu"), params)
        opt = make_optimizer("adafactor", LR, leaves=leaves, **kw)(
            model.parameters())
        errs = []
        for g, w in zip(grads, want):
            gsd = flax_state_dict(g)
            for n, p in model.named_parameters():
                p.grad = torch.from_numpy(np.array(gsd[n]))
            opt.step()
            errs.append(max(float(np.abs(p.detach().numpy() - w[n]).max())
                            for n, p in model.named_parameters()))
        return opt, errs

    opt, errs = run(jax_leaves(cfg))
    assert max(errs) < 1e-6, errs
    assert opt_state_bytes(opt) == jax_state_bytes(state)
    _, errs = run(None)
    assert max(errs) > 1e-4, errs


def test_adafactor_state_of_other_leaves_does_not_load():
    """A state saved with each tensor a leaf of its own (the port's
    adafactor before it followed the JAX leaves) does not load into
    ``GPTModule``'s optimizer, nor the other way: a ``ValueError`` that
    says so, before any tensor is touched."""
    from ray_lightning_tpu_torch.models import TransformerLM, gpt2_config
    from ray_lightning_tpu_torch.models.transformer import jax_leaves
    cfg = gpt2_config("nano", vocab_size=64, max_seq_len=16)
    model = TransformerLM(cfg, device="cpu")
    old = make_optimizer("adafactor", LR)(model.parameters())
    new = make_optimizer("adafactor", LR, leaves=jax_leaves(cfg))(
        model.parameters())
    for opt in (old, new):
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
    for src, dst in ((old, new), (new, old)):
        with pytest.raises(ValueError, match="other parameter leaves"):
            dst.load_state_dict(src.state_dict())
    new.load_state_dict(new.state_dict())
