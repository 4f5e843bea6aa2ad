"""The port's command line against the JAX package's ``cli.py``.

The counterparts of ``tests/test_cli.py``: the strategy registry (the
JAX package's names and aliases for the four ported strategies, its
multi-axis mesh strategies' names raising ``NotImplementedError``
naming ``ROADMAP.md`` A, item 9), a strategy built from flags with passthrough
keyword arguments (the reference's ``tests/test_lightning_cli.py:11-27``),
``=`` syntax, YAML config and flags over it, an unknown strategy,
``_parse_value``'s coercions (held against the JAX function), and the
delayed CUDA accelerator (the JAX package's delayed TPU one). A CLI
``fit`` of the nano GPT module, in process and through ``python -m
ray_lightning_tpu_torch.cli``, equals the same fit built by hand.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_lightning_tpu.cli import STRATEGY_REGISTRY as JAX_REGISTRY
from ray_lightning_tpu.cli import _parse_value as jax_parse_value
from ray_lightning_tpu_torch import (BoringModel, FSDPStrategy, GPTModule,
                                     HorovodRayStrategy, RayShardedStrategy,
                                     RayStrategy, Trainer)
from ray_lightning_tpu_torch.accelerators import (ACCELERATOR_REGISTRY,
                                                  CPUAccelerator,
                                                  CUDAAccelerator,
                                                  DelayedCUDAAccelerator,
                                                  resolve_accelerator)
from ray_lightning_tpu_torch.cli import (STRATEGY_REGISTRY,
                                         UNPORTED_STRATEGIES,
                                         TpuLightningCLI, _parse_value)

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_strategy_registry_names():
    assert STRATEGY_REGISTRY["ddp_ray"] is RayStrategy
    assert STRATEGY_REGISTRY["ddp"] is RayStrategy
    assert STRATEGY_REGISTRY["fsdp"] is FSDPStrategy
    assert STRATEGY_REGISTRY["zero1"] is RayShardedStrategy
    assert STRATEGY_REGISTRY["allreduce"] is HorovodRayStrategy


def test_strategy_registry_matches_the_jax_package():
    """The JAX package's names, each to the port's class of the same
    strategy name, less its mesh strategies', which raise."""
    assert set(STRATEGY_REGISTRY) | set(UNPORTED_STRATEGIES) == set(
        JAX_REGISTRY)
    assert not set(STRATEGY_REGISTRY) & set(UNPORTED_STRATEGIES)
    for name, cls in STRATEGY_REGISTRY.items():
        assert cls.__name__ == JAX_REGISTRY[name].__name__, name


@pytest.mark.parametrize("name", UNPORTED_STRATEGIES)
def test_mesh_strategies_raise_naming_their_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A, item 9"):
        TpuLightningCLI(BoringModel, run=False, args=["--strategy", name])


def test_cli_builds_strategy_from_args():
    """Strategy arguments from flags, unknown ones passed through to the
    strategy's keyword arguments (``DistributedDataParallel``'s)."""
    cli = TpuLightningCLI(
        BoringModel, run=False,
        args=["fit", "--strategy", "ddp_ray",
              "--strategy.num_workers", "2",
              "--strategy.num_cpus_per_worker", "3",
              "--strategy.bucket_cap_mb", "25",
              "--strategy.device", "cpu",
              "--trainer.max_epochs", "2"])
    assert isinstance(cli.strategy, RayStrategy)
    assert cli.strategy.num_workers == 2
    assert cli.strategy.num_cpus_per_worker == 3
    assert cli.strategy.extra_kwargs == {"bucket_cap_mb": 25}
    assert cli.trainer.max_epochs == 2
    assert isinstance(cli.model, BoringModel)


def test_cli_equals_syntax_and_defaults():
    cli = TpuLightningCLI(
        BoringModel, run=False,
        args=["--strategy.num_workers=4", "--model.batch_size=16"])
    assert cli.subcommand == "fit"
    assert cli.strategy.num_workers == 4
    assert cli.model.batch_size == 16


def test_cli_yaml_config(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        "trainer:\n  max_epochs: 5\n"
        "strategy:\n  name: fsdp\n  num_workers: 8\n"
        "model:\n  batch_size: 4\n")
    cli = TpuLightningCLI(BoringModel, run=False,
                          args=["--config", str(cfg)])
    assert isinstance(cli.strategy, FSDPStrategy)
    assert cli.strategy.num_workers == 8
    assert cli.trainer.max_epochs == 5
    assert cli.model.batch_size == 4


def test_cli_flag_overrides_config(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("trainer:\n  max_epochs: 5\n")
    cli = TpuLightningCLI(BoringModel, run=False,
                          args=["--config", str(cfg),
                                "--trainer.max_epochs", "9",
                                "--strategy.device", "cpu"])
    assert cli.trainer.max_epochs == 9


@pytest.mark.parametrize("args", [
    ["--strategy", "nope"], ["--bogus"], ["--trainer.max_epochs"],
    ["--section.x", "1"]])
def test_cli_bad_arguments_exit(args):
    with pytest.raises(SystemExit):
        TpuLightningCLI(BoringModel, run=False, args=args)


def test_cli_run_fit(tmp_path):
    cli = TpuLightningCLI(
        BoringModel, run=True,
        args=["fit", "--trainer.max_epochs", "1",
              "--trainer.limit_train_batches", "2",
              "--trainer.default_root_dir", str(tmp_path),
              "--strategy.device", "cpu"])
    assert cli.trainer.state == "finished"
    assert cli.trainer.global_step == 2
    assert np.isfinite(cli.trainer.callback_metrics["train_loss"])


@pytest.mark.parametrize("raw,default", [
    ("3", 1), ("true", False), ("off", True), ("0.5", 1.0), ("none", "x"),
    ("1e-3", None), ("hello", None), ("7", None), ("x", 2), ("FALSE", None),
])
def test_parse_value_coercions_match_the_jax_package(raw, default):
    got = _parse_value(raw, default)
    want = jax_parse_value(raw, default)
    assert got == want and type(got) is type(want)


def test_parse_value_rejects_a_bad_boolean():
    with pytest.raises(SystemExit):
        _parse_value("maybe", True)


# ----------------------------------------------------------- the fit
FLAGS = ["--strategy", "ddp_sharded", "--strategy.num_workers", "1",
         "--strategy.device", "cpu", "--model.size", "nano",
         "--model.seq_len", "32", "--model.vocab_size", "256",
         "--model.optimizer", "adafactor", "--trainer.max_epochs", "1",
         "--trainer.limit_train_batches", "3",
         "--trainer.limit_val_batches", "1", "--trainer.seed", "0"]


def _by_hand(tmp_path):
    trainer = Trainer(strategy=RayShardedStrategy(num_workers=1,
                                                  device="cpu"),
                      max_epochs=1, limit_train_batches=3,
                      limit_val_batches=1, seed=0,
                      default_root_dir=str(tmp_path / "hand"))
    trainer.fit(GPTModule(size="nano", seq_len=32, vocab_size=256,
                          optimizer="adafactor"))
    return trainer


def test_cli_fit_equals_the_fit_built_by_hand(tmp_path):
    want = _by_hand(tmp_path)
    cli = TpuLightningCLI(GPTModule, run=True, args=[
        "fit", *FLAGS, "--trainer.default_root_dir", str(tmp_path / "cli")])
    assert cli.trainer.callback_metrics == want.callback_metrics
    for name, t in want.model.state_dict().items():
        assert torch.equal(cli.trainer.model.state_dict()[name], t), name


@pytest.mark.multiproc
def test_python_m_cli_prints_the_fit_metrics(tmp_path):
    """``python -m ray_lightning_tpu_torch.cli`` with flags only: its
    last line is the fit's ``callback_metrics`` as JSON, equal to the
    fit built by hand."""
    want = _by_hand(tmp_path)
    # one CPU thread, as this process: the same sums in the same order
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "ray_lightning_tpu_torch.cli",
         "--model-class", "ray_lightning_tpu_torch.models.GPTModule",
         "fit", *FLAGS, "--trainer.default_root_dir",
         str(tmp_path / "cli")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == want.callback_metrics


# ------------------------------------------------------- accelerators
def test_registry_contains_all():
    assert set(ACCELERATOR_REGISTRY) >= {"cpu", "gpu", "_gpu"}


def test_delayed_cuda_always_available():
    """The driver-side check passes with no card visible, and sets
    nothing up there (the JAX package's ``DelayedTPUAccelerator``)."""
    assert DelayedCUDAAccelerator.is_available() is True
    DelayedCUDAAccelerator().setup_environment()


def test_strict_cuda_matches_the_machine():
    assert CUDAAccelerator.is_available() is torch.cuda.is_available()


def test_delayed_cuda_raises_at_train_start_without_a_card():
    if torch.cuda.is_available():
        DelayedCUDAAccelerator().on_train_start()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DelayedCUDAAccelerator().on_train_start()


def test_strategy_selects_delayed_cuda():
    assert RayStrategy(num_workers=2).accelerator_name == "_gpu"
    assert RayStrategy(num_workers=1, device="cpu").accelerator_name == \
        "cpu"
    assert isinstance(resolve_accelerator("cpu"), CPUAccelerator)
