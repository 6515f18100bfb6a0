"""The import guard: nothing under ``portbench/`` imports JAX or the JAX
package (compared by the whole top-level name, since the port's name
begins with the JAX package's), and the reference imports nothing of the
program."""

import ast
from pathlib import Path

import pytest

BASE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "client_tpu"}
SOURCES = sorted(BASE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BASE)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BASE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "client_tpu_torch" not in top_level_imports(path)


def test_the_guard_catches_what_it_names(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom client_tpu.models import x\n"
                   "import client_tpu_torch\n")
    assert top_level_imports(bad) & FORBIDDEN == {"jax", "client_tpu"}
