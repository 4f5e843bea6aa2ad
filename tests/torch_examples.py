"""The port's example scripts (``examples/*_torch.py``) as the tests import them.

A script is imported under its file name with ``examples/`` on
``sys.path``: the name a spawned worker can import it by too (spawned
processes inherit the parent's ``sys.path``). No jax here.
"""
import ast
import importlib
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"

#: every port script, by its JAX twin's stem (``moe_example`` waits for
#: ROADMAP.md A, item 9)
SCRIPTS = ("mnist_ddp_example", "allreduce_example", "resnet_example",
           "bert_finetune_example", "vit_example", "gpt_sharded_example",
           "long_context_example", "mnist_tune_example",
           "resnet_pbt_example", "lora_lifecycle_example", "serve_example")

#: the flags the port adds in place of the JAX scripts' ``--use-tpu``
PORT_DEVICE_FLAGS = {"--cpu", "--use-gpu"}
JAX_DEVICE_FLAGS = {"--use-tpu"}
#: the JAX kernel choices' names in the port
KERNEL_NAMES = {"xla": "torch", "pallas": "cuda"}


def script(stem: str):
    """The port twin of ``examples/<stem>.py``, imported."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(f"{stem}_torch")


def jax_script(stem: str):
    """The JAX script ``examples/<stem>.py``, imported under a name of
    its own (it imports the JAX package)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{stem}", EXAMPLES / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _literal(node):
    if node is None:
        return None
    if isinstance(node, ast.Name):          # type=int, type=float
        return node.id
    try:
        return ast.literal_eval(node)
    except ValueError:
        return ast.dump(node)


def flags(path: pathlib.Path) -> dict:
    """``{option: {type, default, action, choices, metavar}}`` of every
    ``add_argument`` call in ``path``, read from its syntax tree (no
    import, so no jax)."""
    out = {}
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            names = [a.value for a in node.args
                     if isinstance(a, ast.Constant)]
            kw = {k.arg: k.value for k in node.keywords}
            spec = {k: _literal(kw.get(k))
                    for k in ("type", "default", "action", "choices",
                              "metavar")}
            for name in names:
                out[name] = spec
    return out
