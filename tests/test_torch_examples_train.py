"""The port's training example scripts (``examples/*_torch.py``) against their JAX twins.

- **Flag parity**: every script's ``add_argument`` calls, read from the
  syntax trees (no import), equal its JAX twin's; the device flags are
  the one difference allowed (``--use-tpu`` out, ``--cpu`` and
  ``--use-gpu`` in), and the kernel choices take the port's names
  (``xla`` -> ``torch``, ``pallas`` -> ``cuda``).
- **Each training script runs here**: ``main([..., "--smoke-test",
  "--cpu"])`` in-process reaches its end, with finite metrics.
- **No card, no run**: without ``--cpu`` every script raises
  ``RuntimeError`` before it builds anything; ``--impl ring`` and
  ``--impl ulysses`` raise ``NotImplementedError`` naming item 9.
- **Cross-framework parity**, in f32 from the JAX module's initial
  params (``interop.load_flax_params``), each side run through its own
  script's ``main`` with the JAX script's arguments: the long-context
  script's per-step losses (``--impl flash --smoke-test``) and the MNIST
  script's ``callback_metrics`` (``--smoke-test``) at the tolerance
  ``tests/test_torch_train.py`` holds an AdamW fit to.

The spawned-worker runs of two scripts are in
``tests/test_torch_examples_serve.py`` (that file has the room).
"""
import dataclasses
import math
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_examples as tx
from ray_lightning_tpu_torch.interop import load_flax_params

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

#: an AdamW fit's tolerance (tests/test_torch_train.py)
FIT_TOL = 1e-4

#: the argv each training script's smoke run takes here: one worker, so
#: the run stays in this process
SMOKE = {
    "mnist_ddp_example": [],
    "allreduce_example": [],
    "resnet_example": ["--num-workers", "1"],
    "bert_finetune_example": ["--num-workers", "1"],
    "vit_example": ["--num-workers", "1"],
    "gpt_sharded_example": ["--num-workers", "1", "--generate", "4"],
    "long_context_example": ["--impl", "flash", "--generate", "4"],
}


@pytest.mark.parametrize("stem", tx.SCRIPTS)
def test_flags_match_the_jax_twin(stem):
    jax_flags = tx.flags(tx.EXAMPLES / f"{stem}.py")
    port_flags = tx.flags(tx.EXAMPLES / f"{stem}_torch.py")
    for spec in jax_flags.values():
        if isinstance(spec["choices"], list):
            spec["choices"] = [tx.KERNEL_NAMES.get(c, c)
                               for c in spec["choices"]]
    want = {k: v for k, v in jax_flags.items()
            if k not in tx.JAX_DEVICE_FLAGS}
    got = {k: v for k, v in port_flags.items()
           if k not in tx.PORT_DEVICE_FLAGS}
    assert got == want
    assert tx.PORT_DEVICE_FLAGS <= set(port_flags)


@pytest.mark.parametrize("stem", sorted(SMOKE))
def test_training_script_runs_on_the_cpu(stem, capsys):
    trainer = tx.script(stem).main(["--cpu", "--smoke-test", *SMOKE[stem]])
    assert trainer.global_step > 0
    metrics = {k: float(v) for k, v in trainer.callback_metrics.items()}
    assert metrics and all(math.isfinite(v) for v in metrics.values())
    out = capsys.readouterr().out
    if "--generate" in SMOKE[stem]:
        assert "generated:" in out or "decoded 4 tokens" in out


@pytest.mark.parametrize("stem", tx.SCRIPTS)
def test_without_a_card_a_script_raises(stem, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--impl", "flash", "--smoke-test"]
            if stem == "long_context_example" else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tx.script(stem).main(argv)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_impls_name_item_9(impl):
    with pytest.raises(NotImplementedError, match="item 9"):
        tx.script("long_context_example").main(
            ["--cpu", "--impl", impl, "--smoke-test"])


# ------------------------------------------------- cross-framework parity
def _recording(trainer_cls, callback_cls, record):
    """A ``Trainer`` that appends a callback keeping the initial params
    (JAX) and every step's loss, and keeps itself in ``record``."""

    class Recorder(callback_cls):
        def on_fit_start(self, trainer, pl_module):
            if getattr(trainer, "train_state", None) is not None and \
                    hasattr(trainer.train_state, "params"):
                record["init"] = jax.tree_util.tree_map(
                    np.array, trainer.train_state.params)

        def on_train_batch_end(self, trainer, pl_module, outputs, batch,
                               batch_idx):
            record["losses"].append(float(np.asarray(outputs["loss"])))

    class Recording(trainer_cls):
        def __init__(self, *args, callbacks=None, **kwargs):
            super().__init__(*args, callbacks=[*(callbacks or []),
                                               Recorder()], **kwargs)
            record["trainer"] = self

    record.setdefault("losses", [])
    return Recording


def _run_jax(stem, argv, monkeypatch, **cfg_overrides):
    """The JAX script's ``main()`` on ``argv`` with f32 compute, its
    trainer, initial params and per-step losses recorded."""
    from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
    mod = tx.jax_script(stem)
    record = {}
    monkeypatch.setattr(mod, "Trainer",
                        _recording(mod.Trainer, JaxCallback, record))
    if hasattr(mod, "gpt2_config"):
        base = mod.gpt2_config
        monkeypatch.setattr(mod, "gpt2_config", lambda *a, **k: base(
            *a, **{**k, "dtype": jnp.float32, **cfg_overrides}))
    monkeypatch.setattr(sys, "argv", [f"{stem}.py", *argv])
    mod.main()
    return record


def _run_port(stem, argv, init, monkeypatch):
    """The port script's ``main(argv)`` with the module from its
    ``build(args)`` made f32 and started from the JAX ``init``."""
    from ray_lightning_tpu_torch.core.callbacks import Callback
    mod = tx.script(stem)
    record = {}
    monkeypatch.setattr(mod, "Trainer",
                        _recording(mod.Trainer, Callback, record))
    build = mod.build

    def built(args):
        module = build(args)
        if hasattr(module, "cfg"):
            module.cfg = dataclasses.replace(module.cfg,
                                             dtype=torch.float32)
        module.init_variables = (
            lambda model, generator, batch: load_flax_params(model, init))
        return module

    monkeypatch.setattr(mod, "build", built)
    mod.main(["--cpu", *argv])
    return record


def _assert_metrics_match(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        w = float(w)
        np.testing.assert_allclose(float(got[name]), w,
                                   atol=FIT_TOL * max(1.0, abs(w)), rtol=0,
                                   err_msg=name)


def test_long_context_losses_match_the_jax_script(monkeypatch):
    argv = ["--impl", "flash", "--smoke-test"]
    jax_run = _run_jax("long_context_example", argv, monkeypatch)
    port_run = _run_port("long_context_example", argv, jax_run["init"],
                         monkeypatch)
    assert len(port_run["losses"]) == len(jax_run["losses"]) == 4
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"],
                               atol=FIT_TOL, rtol=0)
    _assert_metrics_match(port_run["trainer"].callback_metrics,
                          jax_run["trainer"].callback_metrics)


def test_mnist_metrics_match_the_jax_script(monkeypatch):
    argv = ["--smoke-test"]
    jax_run = _run_jax("mnist_ddp_example", argv, monkeypatch)
    port_run = _run_port("mnist_ddp_example", argv, jax_run["init"],
                         monkeypatch)
    assert port_run["trainer"].global_step \
        == jax_run["trainer"].global_step == 16
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"],
                               atol=FIT_TOL, rtol=0)
    _assert_metrics_match(port_run["trainer"].callback_metrics,
                          jax_run["trainer"].callback_metrics)
