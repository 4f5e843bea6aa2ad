"""The port's checkpoint and resume (``core/checkpoint.py``, ``Trainer``) against the JAX package.

Mirrors ``tests/test_reliability.py``'s trainer cases and the checkpoint
cases of ``tests/test_loggers_checkpoint.py`` one for one, with the
port's ``BoringModel`` started from the JAX run's initial params
(``Linear``'s weight is flax's kernel transposed):

- a fit killed by a ``train.step`` fault and resumed with
  ``resume="auto"`` -- from an epoch-end checkpoint and from a mid-epoch
  periodic one, in the stream and the directory format, under SGD and
  each AdamW/adafactor preset -- ends with params *bitwise* equal to the
  port's uninterrupted run and replays its losses bit for bit; the
  uninterrupted run's per-step losses equal the JAX trainer's at
  ``tests/test_torch_train.py``'s tolerances (SGD 1e-5, AdamW 1e-4), and
  at 1e-3 under the presets that keep a moment in bf16: the two
  frameworks' f32 gradients differ in their last bits, which now and
  then rounds a stored bf16 moment the other way and moves later updates
  by up to one bf16 ulp of it (``tests/test_torch_optim.py`` holds those
  optimizers to optax step for step at 1e-6); nano GPT on the flash
  path resumes bitwise from a save taken in the middle of a gradient
  accumulation, and with ``dropout=0.1`` replays its masks bitwise;
- a save killed at ``ckpt.save`` leaves nothing resume picks up, and a
  marker-less directory or a truncated stream file is skipped;
- the directory writers' round trip and atomicity, periodic saves that
  never take the best slot, ``async_save``, ``keep_last_n``;
- the non-finite guard's three actions, ``skip_batch``'s final params
  against JAX's at 1e-5.
"""
import os
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
from ray_lightning_tpu import RayStrategy as JaxRayStrategy
from ray_lightning_tpu import Trainer as JaxTrainer
from ray_lightning_tpu.core.callbacks import LambdaCallback as JaxLambda
from ray_lightning_tpu.core.optim import make_optimizer as jax_make_optimizer
from ray_lightning_tpu.models import BoringModel as JaxBoringModel
from ray_lightning_tpu.reliability import FaultPlan as JaxFaultPlan
from ray_lightning_tpu_torch import (BoringModel, GPTModule, ModelCheckpoint,
                                     NonFiniteError, RayStrategy, Trainer,
                                     gpt2_config)
from ray_lightning_tpu_torch.core import LambdaCallback, make_optimizer
from ray_lightning_tpu_torch.core.checkpoint import (
    CorruptCheckpointError, find_resume_candidates, have_dcp,
    is_committed_checkpoint, load_sharded_checkpoint, save_sharded_checkpoint,
    wait_for_async_saves)
from ray_lightning_tpu_torch.reliability import FaultPlan, InjectedFault

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

FIT = dict(max_epochs=3, limit_train_batches=4, limit_val_batches=2, seed=0)
OPTS = {  # name: (JAX transform, port factory, loss tolerance vs JAX)
    "sgd": (lambda: optax.sgd(0.1),
            lambda: (lambda p: torch.optim.SGD(p, lr=0.1)), 1e-5),
    "adamw": (lambda: jax_make_optimizer("adamw", 1e-2),
              lambda: make_optimizer("adamw", 1e-2), 1e-4),
    "adamw_bf16m": (lambda: jax_make_optimizer("adamw_bf16m", 1e-2),
                    lambda: make_optimizer("adamw_bf16m", 1e-2), 1e-3),
    "adafactor": (lambda: jax_make_optimizer("adafactor", 1e-2),
                  lambda: make_optimizer("adafactor", 1e-2), 1e-3),
}


def _to_port(params):
    """The JAX BoringModel's Dense params as the port Linear's."""
    dense = params["Dense_0"]
    return {"weight": torch.from_numpy(np.array(dense["kernel"]).T.copy()),
            "bias": torch.from_numpy(np.array(dense["bias"]))}


class _JaxBoring(JaxBoringModel):
    def __init__(self, opt="sgd"):
        super().__init__()
        self.opt = opt

    def configure_optimizers(self):
        return OPTS[self.opt][0]()


class _Boring(BoringModel):
    """The port's BoringModel from given initial params."""

    def __init__(self, init, opt="sgd"):
        super().__init__()
        self.init, self.opt = init, opt

    def init_variables(self, model, generator, batch):
        model.load_state_dict(self.init)

    def configure_optimizers(self):
        return OPTS[self.opt][1]()


def _losses(into):
    return LambdaCallback(on_train_batch_end=lambda tr, m, out, b, i:
                          into.append((tr.global_step, out["loss"].item())))


def _trainer(root, **kw):
    kw.setdefault("strategy", RayStrategy(device="cpu"))
    for k, v in FIT.items():
        kw.setdefault(k, v)
    return Trainer(default_root_dir=root, **kw)


def _jax_trainer(root, **kw):
    kw.setdefault("strategy", JaxRayStrategy(num_workers=1))
    for k, v in FIT.items():
        kw.setdefault(k, v)
    return JaxTrainer(default_root_dir=root, **kw)


def _jax_run(root, opt="sgd", fault=None, **kw):
    """A JAX fit: its initial params (as the port's), per-step losses and
    the trainer."""
    out = {"losses": []}

    def grab(tr, m):
        out["init"] = _to_port(jax.tree_util.tree_map(
            np.array, tr.train_state.params))

    rec = JaxLambda(
        on_fit_start=grab,
        on_train_batch_end=lambda tr, m, logs, b, i: out["losses"].append(
            float(np.asarray(logs["loss"]))))
    trainer = _jax_trainer(root, callbacks=[rec], **kw)
    if fault is None:
        trainer.fit(_JaxBoring(opt))
    else:
        with fault.armed():
            trainer.fit(_JaxBoring(opt))
    out["trainer"] = trainer
    out["final"] = _to_port(jax.tree_util.tree_map(
        np.array, trainer.train_state.params))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """One uninterrupted JAX fit per optimizer."""
    cache = {}

    def get(opt):
        if opt not in cache:
            cache[opt] = _jax_run(str(tmp_path_factory.mktemp(f"j-{opt}")),
                                  opt, enable_checkpointing=False)
        return cache[opt]

    return get


@pytest.fixture(scope="module")
def port_ref(tmp_path_factory, jax_ref):
    """One uninterrupted port fit per optimizer, from JAX's init."""
    cache = {}

    def get(opt):
        if opt not in cache:
            losses = []
            trainer = _trainer(str(tmp_path_factory.mktemp(f"p-{opt}")),
                               callbacks=[_losses(losses)])
            trainer.fit(_Boring(jax_ref(opt)["init"], opt))
            cache[opt] = dict(trainer=trainer, losses=losses,
                              state=trainer.train_state.state_dict())
        return cache[opt]

    return get


def _assert_bitwise(got, want, where=""):
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_bitwise(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bitwise(g, w, f"{where}/{i}")
    else:
        assert got == want, where


def _kill_and_resume(root, opt, init, cb_kw, tick):
    ck = os.path.join(root, "ck")
    killed = _trainer(root, callbacks=[ModelCheckpoint(dirpath=ck, **cb_kw)])
    with pytest.raises(InjectedFault):
        with FaultPlan.at("train.step", [tick]).armed():
            killed.fit(_Boring(init, opt))
    losses = []
    resumed = _trainer(root, callbacks=[ModelCheckpoint(dirpath=ck, **cb_kw),
                                        _losses(losses)], resume="auto")
    resumed.fit(_Boring(init, opt))
    return ck, resumed, losses


def _check_resumed(resumed, losses, ref, jref, opt):
    assert resumed.global_step == ref["trainer"].global_step == 12
    _assert_bitwise(resumed.train_state.state_dict(), ref["state"])
    assert losses == ref["losses"][-len(losses):]
    assert resumed.callback_metrics["x"] == \
        ref["trainer"].callback_metrics["x"]
    np.testing.assert_allclose([v for _, v in ref["losses"]],
                               jref["losses"], atol=OPTS[opt][2], rtol=0)


@pytest.mark.parametrize("fmt", ["stream", "orbax"])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_kill_and_auto_resume_matches_uninterrupted(tmp_path, jax_ref,
                                                    port_ref, fmt, opt):
    """A train.step crash in epoch 1 (batch 2), then resume='auto' from
    the epoch-0 checkpoint: bitwise the uninterrupted run."""
    jref = jax_ref(opt)
    _ck, resumed, losses = _kill_and_resume(
        str(tmp_path), opt, jref["init"], dict(save_format=fmt), tick=6)
    assert [s for s, _ in losses] == list(range(5, 13))
    _check_resumed(resumed, losses, port_ref(opt), jref, opt)
    assert resumed.current_epoch == 2


@pytest.mark.parametrize("fmt", ["stream", "orbax"])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_mid_epoch_periodic_checkpoint_resume(tmp_path, jax_ref, port_ref,
                                              fmt, opt):
    """every_n_train_steps saves record their batch in the epoch; resume
    re-enters the epoch and fast-forwards the loader."""
    jref = jax_ref(opt)
    ck, resumed, losses = _kill_and_resume(
        str(tmp_path), opt, jref["init"],
        dict(save_format=fmt, every_n_train_steps=2, save_top_k=2), tick=7)
    assert any("step=6" in n for n in os.listdir(ck))
    assert [s for s, _ in losses] == list(range(7, 13))
    _check_resumed(resumed, losses, port_ref(opt), jref, opt)


@pytest.mark.parametrize("fmt", ["stream", "orbax"])
def test_gpt_resume_inside_an_accumulation_is_bitwise(tmp_path, fmt):
    """Nano GPT on the flash path, AdamW, 2-batch gradient accumulation:
    a save at step 3 holds half an accumulation (its running mean and
    position) and the generator state; the resumed fit equals the
    uninterrupted one bit for bit, optimizer state included."""
    cfg = gpt2_config("nano", attention_impl="flash", dtype=torch.float32,
                      vocab_size=256, max_seq_len=32)
    kw = dict(max_epochs=2, limit_train_batches=4, limit_val_batches=1,
              accumulate_grad_batches=2, gradient_clip_val=0.5)

    def module():
        return GPTModule(config=cfg, batch_size=4, num_samples=32)

    ref = _trainer(str(tmp_path / "ref"), **kw)
    ref.fit(module())
    root = str(tmp_path)
    cb = dict(dirpath=os.path.join(root, "ck"), save_format=fmt,
              every_n_train_steps=3, save_top_k=-1)
    killed = _trainer(root, callbacks=[ModelCheckpoint(**cb)], **kw)
    with pytest.raises(InjectedFault):
        with FaultPlan.at("train.step", [3]).armed():
            killed.fit(module())
    newest = find_resume_candidates(cb["dirpath"])[0]
    assert "step=3" in newest
    saved = killed._read_checkpoint(newest)["state"]
    # 3 batches at 2 a update: one update, then half an accumulation
    assert (saved["updates"], saved["mini_step"]) == (1, 1)
    assert saved["acc"] is not None
    resumed = _trainer(root, callbacks=[ModelCheckpoint(**cb)],
                       resume="auto", **kw)
    resumed.fit(module())
    assert resumed.global_step == ref.global_step == 8
    _assert_bitwise(resumed.train_state.state_dict(),
                    ref.train_state.state_dict())


@pytest.mark.parametrize("fmt", ["stream", "orbax"])
def test_gpt_dropout_resume_replays_the_masks_bitwise(tmp_path, fmt):
    """Nano GPT with ``dropout=0.1``: every step draws its mask seed from
    the step generator, whose state the checkpoint carries, so a fit
    killed in its second epoch and resumed from the mid-epoch save at
    step 4 draws the same masks as the uninterrupted fit: params,
    optimizer state and losses bit for bit."""
    cfg = gpt2_config("nano", attention_impl="flash", dtype=torch.float32,
                      vocab_size=256, max_seq_len=32, dropout=0.1)
    kw = dict(max_epochs=2, limit_train_batches=3, limit_val_batches=1)

    def module():
        return GPTModule(config=cfg, batch_size=4, num_samples=32)

    ref_losses, losses = [], []
    ref = _trainer(str(tmp_path / "ref"), callbacks=[_losses(ref_losses)],
                   **kw)
    ref.fit(module())
    root = str(tmp_path)
    cb = dict(dirpath=os.path.join(root, "ck"), save_format=fmt,
              every_n_train_steps=2, save_top_k=-1)
    killed = _trainer(root, callbacks=[ModelCheckpoint(**cb)], **kw)
    with pytest.raises(InjectedFault):
        with FaultPlan.at("train.step", [4]).armed():
            killed.fit(module())
    assert "step=4" in find_resume_candidates(cb["dirpath"])[0]
    resumed = _trainer(root, callbacks=[ModelCheckpoint(**cb),
                                        _losses(losses)],
                       resume="auto", **kw)
    resumed.fit(module())
    assert resumed.global_step == ref.global_step == 6
    assert [s for s, _ in losses] == [5, 6]
    assert losses == ref_losses[-2:]
    _assert_bitwise(resumed.train_state.state_dict(),
                    ref.train_state.state_dict())


@pytest.mark.parametrize("fmt", ["stream", "orbax"])
def test_auto_resume_skips_corrupt_candidate(tmp_path, fmt):
    """A ckpt.save fault kills the second epoch-end save before its
    commit: nothing of it is left for resume. A torn newer candidate (a
    directory without its commit marker, or a truncated stream file) is
    skipped with a warning and the older valid checkpoint restored."""
    root = str(tmp_path)
    ck = os.path.join(root, "ck")
    cb = dict(dirpath=ck, save_format=fmt, save_top_k=-1)
    t1 = _trainer(root, max_epochs=2, callbacks=[ModelCheckpoint(**cb)])
    with pytest.raises(InjectedFault):
        with FaultPlan.at("ckpt.save", [1]).armed():
            t1.fit(BoringModel())
    names = sorted(os.listdir(ck))
    assert len(names) == 1 and "step=4" in names[0]   # no tmp left
    torn = os.path.join(ck, names[0].replace("epoch=0-step=4",
                                             "epoch=1-step=8"))
    if fmt == "orbax":
        shutil.copytree(os.path.join(ck, names[0]), torn)
        os.remove(os.path.join(torn, "tl_meta.pt"))
        assert not is_committed_checkpoint(torn)
        with pytest.raises(CorruptCheckpointError, match="commit marker"):
            load_sharded_checkpoint(torn)
    else:
        with open(os.path.join(ck, names[0]), "rb") as f:
            data = f.read()
        with open(torn, "wb") as f:
            f.write(data[:len(data) // 2])
    assert find_resume_candidates(ck)[0] == torn
    t2 = _trainer(root, max_epochs=2, callbacks=[ModelCheckpoint(**cb)],
                  resume="auto")
    t2.fit(BoringModel())  # falls back to the epoch-0 checkpoint
    assert t2.current_epoch == 1 and t2.global_step == 8


@pytest.mark.parametrize("dcp_available", [True, False])
def test_directory_checkpoint_roundtrip_and_atomicity(tmp_path, monkeypatch,
                                                      dcp_available):
    """Both directory writers, chosen by whether torch has distributed
    support (DCP, else one torch.save): a bit-exact round trip, staged in
    a tmp sibling and os.replace-committed -- a mid-save kill leaves
    nothing visible -- and unreadable contents read as corrupt."""
    root = str(tmp_path)
    t = _trainer(root, max_epochs=1, limit_train_batches=2,
                 limit_val_batches=0)
    t.fit(BoringModel())
    t._module.extra_state["my_counter"] = 7
    ckpt = t.dump_checkpoint()
    monkeypatch.setattr(torch.distributed, "is_available",
                        lambda: dcp_available)
    assert have_dcp() is dcp_available
    path = os.path.join(root, "dir_ck")
    save_sharded_checkpoint(path, ckpt)
    assert os.path.exists(os.path.join(
        path, "state/.metadata" if dcp_available else "state.pt"))
    out = load_sharded_checkpoint(path)
    assert out["global_step"] == 2 and out["module"]["my_counter"] == 7
    assert out["loop"] == {"batch_in_epoch": -1}
    assert out["world"] == {"world_size": 1}
    _assert_bitwise(out["state"], ckpt["state"])
    save_sharded_checkpoint(path, ckpt)  # overwrite
    assert sorted(os.listdir(root)) == ["dir_ck"]

    path2 = os.path.join(root, "dir_ck2")
    with pytest.raises(InjectedFault):
        with FaultPlan.at("ckpt.save", [0]).armed():
            save_sharded_checkpoint(path2, ckpt)
    assert not os.path.exists(path2)
    assert sorted(os.listdir(root)) == ["dir_ck"]
    assert all("dir_ck2" not in c for c in find_resume_candidates(root))

    if not dcp_available:  # the plain writer has no async form
        with pytest.raises(ValueError, match="async_save"):
            save_sharded_checkpoint(path2, ckpt, async_save=True)
        assert not os.path.exists(path2)

    bad = os.path.join(root, "bad_ck")
    os.makedirs(os.path.join(bad, "state"))
    for name in ("state/.metadata" if dcp_available else "state.pt",
                 "tl_meta.pt"):
        with open(os.path.join(bad, name), "wb") as f:
            f.write(b"\x93truncated")
    with pytest.raises(CorruptCheckpointError):
        load_sharded_checkpoint(bad)


def test_periodic_saves_do_not_hijack_monitored_best(tmp_path):
    """every_n_train_steps with a monitored ModelCheckpoint: periodic
    saves roll (only the newest survives) and never enter best-model
    tracking or top-k."""
    ck = os.path.join(str(tmp_path), "ck")
    cb = ModelCheckpoint(dirpath=ck, monitor="x", mode="min",
                         save_top_k=1, every_n_train_steps=2)
    t = _trainer(str(tmp_path), max_epochs=2, callbacks=[cb])
    t.fit(BoringModel())
    assert "x=" in os.path.basename(cb.best_model_path)
    assert cb.best_model_score is not None and cb.best_model_score > 0
    periodic = [n for n in os.listdir(ck) if "x=" not in n]
    assert len(periodic) == 1  # rolling: older periodic saves deleted
    assert "step=8" in periodic[0]


def test_async_save_and_keep_last_n(tmp_path, monkeypatch):
    """async_save overlaps the directory write with training in one
    process, as the JAX package's orbax save does: every save returns
    with its commit still pending on the commit thread, writing host
    copies of the tensors through DCP's one-process save (never DCP's
    ``async_save``, which needs a process group); the fit-end wait
    leaves every directory committed, keep_last_n prunes the rest, and
    the best checkpoint restores the final params."""
    import torch.distributed.checkpoint as dcp
    from ray_lightning_tpu_torch.core import checkpoint as ckpt_mod

    def refused(*a, **k):
        raise AssertionError("the one-process path must not need "
                             "DCP's async_save")

    monkeypatch.setattr(dcp, "async_save", refused)
    pending, staged = [], []
    real_copy = ckpt_mod.host_copy

    def recording_copy(tree):
        out = real_copy(tree)
        if isinstance(tree, dict):      # a save's flat tensor dict
            staged.append(out)
        return out

    monkeypatch.setattr(ckpt_mod, "host_copy", recording_copy)
    ck = os.path.join(str(tmp_path), "ck")
    cb = ModelCheckpoint(dirpath=ck, save_format="orbax", async_save=True,
                         save_top_k=-1, every_n_train_steps=1, keep_last_n=2)
    t = _trainer(str(tmp_path), callbacks=[cb, LambdaCallback(
        on_train_batch_end=lambda *a: pending.append(
            len(ckpt_mod._PENDING)))])
    t.fit(BoringModel())
    wait_for_async_saves()
    assert len(staged) == 15 and any(pending)   # 12 periodic, 3 epoch-end
    live = {t_.data_ptr() for t_ in t.model.state_dict().values()}
    assert not any(x.data_ptr() in live for s in staged for x in s.values())
    names = sorted(os.listdir(ck))
    assert all(is_committed_checkpoint(os.path.join(ck, n)) for n in names)
    assert not any(".tmp-" in n for n in names)
    assert cb.best_model_path.endswith("epoch=2-step=12.orbax")
    t2 = _trainer(str(tmp_path), max_epochs=0)
    t2.fit(BoringModel(), ckpt_path=cb.best_model_path)
    _assert_bitwise(t2.model.state_dict(), t.model.state_dict())
    with pytest.raises(ValueError, match="async_save"):
        ModelCheckpoint(save_format="stream", async_save=True)
    with pytest.raises(ValueError, match="async_save"):
        t.save_checkpoint(os.path.join(str(tmp_path), "x.ckpt"),
                          async_save=True)


def test_stream_and_directory_agree_and_meta_survives(tmp_path):
    """Both formats restore the same params; the directory's meta keeps
    epoch and step."""
    root = str(tmp_path)
    t1 = _trainer(os.path.join(root, "a"), max_epochs=2,
                  callbacks=[ModelCheckpoint(save_format="stream")])
    t1.fit(BoringModel())
    t2 = _trainer(os.path.join(root, "b"), max_epochs=2,
                  callbacks=[ModelCheckpoint(save_format="orbax")])
    t2.fit(BoringModel())
    s1 = t1._read_checkpoint(t1.checkpoint_callback.best_model_path)
    s2 = load_sharded_checkpoint(t2.checkpoint_callback.best_model_path)
    assert s2["epoch"] == 1 and s2["global_step"] == 8
    _assert_bitwise(s1["state"]["params"], s2["state"]["params"])


def test_evaluate_and_predict_from_a_checkpoint(tmp_path):
    """validate, test and predict with ckpt_path= (a path or "auto") run
    on the restored weights in a fresh trainer."""
    root = str(tmp_path)
    t = _trainer(root, enable_checkpointing=True)
    t.fit(BoringModel())
    best = t.checkpoint_callback.best_model_path
    assert os.path.basename(best) == "epoch=2-step=12.ckpt"
    x = t.callback_metrics["x"]
    for ckpt_path in (best, "auto"):
        fresh = _trainer(root, limit_test_batches=2)
        assert fresh.validate(BoringModel(), ckpt_path=ckpt_path)[0]["x"] \
            == x
        assert fresh.test(BoringModel(), ckpt_path=ckpt_path)[0]["y"] == x
        out = _trainer(root, limit_predict_batches=2).predict(
            BoringModel(), ckpt_path=ckpt_path)
        assert len(out) == 2
        with torch.no_grad():
            want = t.model(torch.from_numpy(BoringModel()._data()[:8]))
        assert torch.equal(out[0], want)


@pytest.fixture(scope="module")
def jax_skip(tmp_path_factory):
    return _jax_run(str(tmp_path_factory.mktemp("j-skip")), max_epochs=2,
                    limit_val_batches=0, nonfinite_action="skip_batch",
                    fault=JaxFaultPlan.at("loader.next", [1], mode="nan"))


@pytest.mark.parametrize("action", ["skip_batch", "raise",
                                    "restore_last_ckpt", "restore_none"])
def test_nonfinite_guard_actions(tmp_path, jax_skip, action):
    """loader.next NaN-poison: 'skip_batch' drops the update and keeps
    training (its final params equal JAX's), 'raise' fails fast,
    'restore_last_ckpt' rolls back to the newest periodic checkpoint, and
    fails loudly when there is none."""
    callbacks, tick = [], 1
    if action == "restore_last_ckpt":
        callbacks = [ModelCheckpoint(dirpath=str(tmp_path / "ck"),
                                     every_n_train_steps=1)]
        tick = 2
    t = _trainer(str(tmp_path), max_epochs=2, limit_val_batches=0,
                 callbacks=callbacks,
                 nonfinite_action=action.replace("_none", "_last_ckpt"))
    plan = FaultPlan.at("loader.next", [tick], mode="nan")
    if action in ("raise", "restore_none"):
        with pytest.raises(NonFiniteError,
                           match="no checkpoint" if action ==
                           "restore_none" else "non-finite"):
            with plan.armed():
                t.fit(_Boring(jax_skip["init"]))
        return
    with plan.armed():
        t.fit(_Boring(jax_skip["init"]))
    assert t.nonfinite_batches == 1
    assert t.nonfinite_restores == (action == "restore_last_ckpt")
    assert all(torch.isfinite(p).all() for p in t.model.parameters())
    if action == "skip_batch":
        assert jax_skip["trainer"].nonfinite_batches == 1
        for n, w in jax_skip["final"].items():
            np.testing.assert_allclose(t.model.state_dict()[n].numpy(),
                                       w.numpy(), atol=1e-5, rtol=0,
                                       err_msg=n)
