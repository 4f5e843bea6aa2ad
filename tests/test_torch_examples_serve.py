"""The port's serving and LoRA example scripts on the CPU, and two training scripts through spawned workers.

- ``serve_example_torch.py`` in each of its modes -- the dense slot
  pool, page-native with the paged-attention kernel's route, quantized
  weights with the fused matmul's route, async dispatch, the journal's
  simulated driver kill with ``--trace-out``, the in-process and process
  fleets, published adapters under tenant classes -- reaches its end
  with its own gates: greedy rows token-identical to one-shot
  ``generate()`` (skipped by the script under ``--weight-dtype``, as in
  JAX), adapter rows identical to solo engines.
- ``lora_lifecycle_example_torch.py``: base weights bitwise frozen, the
  adapter moved, the hot load token-identical to build-time residency,
  the null row to a bankless engine; its published adapter then serves
  through the serve script's ``--adapter``.
- **Spawned workers**: ``mnist_ddp_example_torch.py --num-workers 2
  --data-workers 1`` (a loader subclass defined in the script, its
  producers started inside a spawned worker) and
  ``gpt_sharded_example_torch.py --fsdp --num-workers 2 --generate 4``
  run through two spawned gloo workers, and end where the one-process
  runs end.
"""
import ast
import math

import pytest
import torch

import torch_examples as tx

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

SERVE_MODES = {
    "dense": [],
    "page_native": ["--attention-kernel", "cuda"],
    "int8_fused": ["--weight-dtype", "int8", "--matmul-kernel", "cuda"],
    "async": ["--async-dispatch", "--attention-kernel", "cuda"],
    "fleet": ["--fleet-replicas", "2"],
}


def _serve(argv):
    return tx.script("serve_example").main(["--cpu", *argv])


@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
def test_serve_script_modes(mode):
    res = _serve(SERVE_MODES[mode])
    assert len(res["completions"]) == 12
    assert all(len(c.tokens) == 24 for c in res["completions"].values())
    if mode == "int8_fused":
        assert res["identical"] is None       # the script skips it
    else:
        assert res["identical"] is True and res["greedy_rows"] == 6


def test_serve_script_journal_kill_and_trace(tmp_path):
    trace = tmp_path / "trace.json"
    res = _serve(["--journal", str(tmp_path / "serve.wal"),
                  "--trace-out", str(trace)])
    assert res["identical"] is True
    assert res["replayed"] > 0 and res["retired_before_kill"] >= 2
    assert trace.stat().st_size > 0


@pytest.mark.multiproc
def test_serve_script_process_fleet():
    res = _serve(["--fleet-replicas", "2", "--fleet-backend", "process",
                  "--requests", "6"])
    assert res["identical"] is True and len(res["completions"]) == 6


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    path = tmp_path_factory.mktemp("lora") / "tuned"
    res = tx.script("lora_lifecycle_example").main(
        ["--cpu", "--publish-dir", str(path)])
    return path, res


def test_lora_script_gates(published):
    _, res = published
    assert res["frozen"] and res["adapter_moved"] and res["identical"]
    # the successor rule the adapter learned dominates the tuned row
    assert res["hits"] > len(res["tuned"]) // 2
    assert res["tuned"] != res["base"]


def test_serve_script_serves_the_published_adapter(published):
    path, _ = published
    res = _serve(["--adapter", f"tuned={path}",
                  "--tenant-classes", "fast:interactive@tuned,bulk:batch"])
    assert res["adapter_rows"] == 6
    assert {c.tenant for c in res["completions"].values()} \
        == {"fast", "bulk"}


# ------------------------------------------------------- spawned workers
def _one_process_run(stem, argv):
    return tx.script(stem).main(["--cpu", *argv])


@pytest.mark.multiproc
def test_mnist_loader_subclass_crosses_to_spawned_workers():
    argv = ["--smoke-test", "--data-workers", "1"]
    spawned = tx.script("mnist_ddp_example").main(
        ["--cpu", "--num-workers", "2", *argv])
    single = _one_process_run("mnist_ddp_example", argv)
    assert spawned.train_state is None               # the fit ran remotely
    assert spawned.global_step == single.global_step == 16
    for name, value in single.callback_metrics.items():
        got = float(spawned.callback_metrics[name])
        assert math.isfinite(got)
        assert got == pytest.approx(float(value), rel=1e-4, abs=1e-4), name


@pytest.mark.multiproc
def test_fsdp_gpt_trains_in_spawned_workers_and_generates(capsys):
    argv = ["--fsdp", "--smoke-test", "--generate", "4"]
    spawned = tx.script("gpt_sharded_example").main(
        ["--cpu", "--num-workers", "2", *argv])
    got = capsys.readouterr().out
    single = _one_process_run("gpt_sharded_example", argv)
    want = capsys.readouterr().out
    assert spawned.train_state is None
    assert spawned.global_step == single.global_step == 4
    for name, value in single.callback_metrics.items():
        assert float(spawned.callback_metrics[name]) == pytest.approx(
            float(value), rel=1e-4, abs=1e-4), name
    tokens = [line for line in got.splitlines()
              if line.startswith("generated:")]
    assert len(tokens) == 1 and len(ast.literal_eval(
        tokens[0].split(":", 1)[1].strip())) == 8
    assert tokens == [line for line in want.splitlines()
                      if line.startswith("generated:")]
