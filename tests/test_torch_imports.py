"""The port stays free of JAX: no module of ``ray_lightning_tpu_torch/``
(nor ``chip_smoke.py``, the port's report tools or its example scripts)
imports jax, flax, optax or the JAX package, and importing the port --
the native ring, the multiprocess loader, the fleet and the process
fleet's driver and worker included -- loads none of them."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "ray_lightning_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_lightning_tpu")
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tools").glob("*_torch.py"))
         + sorted((ROOT / "examples").glob("*_torch.py")))


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.relative_to(ROOT)}:{line} imports {name}"
           for line, name in _imports(tree) if _forbidden(name)]
    assert not bad, bad


def test_scanner_sees_forbidden_imports():
    # the scan itself must catch each import shape it polices
    src = ("import jax\nfrom flax import linen\n"
           "from ray_lightning_tpu.serve import ServeClient\n"
           "import importlib\nimportlib.import_module('optax')\n"
           "import ray_lightning_tpu_torch\n")
    names = [n for _, n in _imports(ast.parse(src)) if _forbidden(n)]
    assert names == ["jax", "flax", "ray_lightning_tpu.serve", "optax"]


def test_import_loads_no_jax():
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import ray_lightning_tpu_torch\n"
            "import ray_lightning_tpu_torch.serve.client\n"
            "import ray_lightning_tpu_torch._native\n"
            "import ray_lightning_tpu_torch.data.multiproc\n"
            "import ray_lightning_tpu_torch.serve.fleet\n"
            "import ray_lightning_tpu_torch.serve.process_fleet\n"
            "import ray_lightning_tpu_torch.launchers.serve_worker\n"
            "import ray_lightning_tpu_torch.obs.tracing\n"
            "new = sorted(m for m in set(sys.modules) - before\n"
            "             if m.split('.')[0] in %r)\n"
            "print(new)\n"
            "sys.exit(1 if new else 0)\n" % (FORBIDDEN,))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
