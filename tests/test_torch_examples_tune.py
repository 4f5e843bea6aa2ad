"""The port's hyperparameter-search example scripts on the CPU.

Under ``--smoke-test`` both scripts take their Ray-less branch, as the
JAX scripts do (and so they do wherever Ray is not installed):

- ``mnist_tune_example_torch.py --smoke-test``: ``sweep_mnist`` runs the
  Tune trainable ``train_mnist`` (``RayStrategy`` with an ``init_hook``)
  over its one-point grid and picks the best point;
- ``resnet_pbt_example_torch.py --smoke-test``: ``mini_pbt`` runs two
  ResNet-18 members for two generations; each generation's exploit step
  clones the better member's checkpoint into the worse one, which the
  next generation resumes through ``Trainer.fit(ckpt_path=)``.
"""
import pytest
import torch

import torch_examples as tx

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port


def test_mnist_sweep_picks_its_best_point(capsys):
    best, acc = tx.script("mnist_tune_example").main(["--cpu", "--smoke-test"])
    assert best == {"lr": 1e-3, "batch_size": 64}
    assert 0.5 <= acc <= 1.0
    assert "Best hyperparameters:" in capsys.readouterr().out


def test_mini_pbt_exploits_and_resumes(capsys):
    members, exploits = tx.script("resnet_pbt_example").main(
        ["--cpu", "--smoke-test"])
    out = capsys.readouterr().out
    assert [g for g, _, _ in exploits] == [0, 1]
    for gen, worst, best in exploits:
        assert worst != best
        assert f"gen {gen}: member {worst} exploits member {best}" in out
    # the exploited member took the best member's config with its lr
    # perturbed by 0.8x or 1.25x
    gen, worst, best = exploits[-1]
    ratio = members[worst]["lr"] / members[best]["lr"]
    assert ratio == pytest.approx(0.8) or ratio == pytest.approx(1.25)
    # every member of the second generation resumed from a checkpoint
    # (one epoch further) and validated
    assert out.count("gen 1 member") == 2
