"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole, so ``ipoke_tpu_torch`` is not taken for ``ipoke_tpu``."""
import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "ipoke_tpu"}
PORT = {"ipoke_tpu_torch"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not top_level_imports(path) & (JAX | PORT)
    assert top_level_imports(path) <= {"__future__", "math", "numpy", "torch", "portbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("portbench"):
            assert node.module.startswith("portbench.reference")


def test_scan_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import ipoke_tpu_torch.models\nfrom jax import numpy\n")
    assert top_level_imports(src) == {"ipoke_tpu_torch", "jax"}
    assert top_level_imports(src) & JAX == {"jax"}
