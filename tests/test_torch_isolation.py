"""The port package stands alone: no file under reve_tpu_torch/ (nor
chip_smoke.py) imports jax or anything of the JAX package reve_tpu.

The scan is static (AST), because importing a module here cannot show
it: the test process has jax and reve_tpu loaded already.
"""

import ast
import os

import pytest
import torch

torch.set_num_threads(2)

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "reve_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "reve_tpu")


def _py_files():
    """Every module of the port, and chip_smoke.py, which drives it."""
    out = [os.path.join(os.path.dirname(PKG), "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
                # `from reve_tpu import x` names reve_tpu as module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in FORBIDDEN


def test_package_has_python_files():
    files = _py_files()
    assert len(files) > 20
    assert any(f.endswith(os.path.join("kernels", "conv3x3.py"))
               for f in files)


@pytest.mark.parametrize("path", _py_files(),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_or_reve_tpu_import(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{os.path.relpath(path, PKG)} imports {bad}"


def test_scan_catches_forbidden_imports(tmp_path):
    """The scanner itself: each spelling of a forbidden import is found,
    and the port's own name is not mistaken for the JAX package."""
    src = tmp_path / "m.py"
    src.write_text(
        "import jax.numpy as jnp\n"
        "from reve_tpu.models import srvgg\n"
        "from reve_tpu import cli\n"
        "import importlib\nimportlib.import_module('reve_tpu.ops')\n"
        "from reve_tpu_torch.models import srvgg as ok\n"
        "def f():\n    import jaxlib\n")
    found = sorted(m for m in _imported_modules(str(src)) if _forbidden(m))
    assert found == ["jax.numpy", "jaxlib", "reve_tpu", "reve_tpu.models",
                     "reve_tpu.ops"]
