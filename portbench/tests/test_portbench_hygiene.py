"""Nothing of portbench/ imports JAX or the JAX package `repro` (top-level
names compared whole: the port `repro_torch` is allowed), nor the
reference benchmarks; the reference imports nothing of the port."""
import ast
from pathlib import Path

import pytest

import run

PB = Path(run.HERE)
NEVER = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                    node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


FILES = sorted(p for p in PB.rglob("*.py") if "_cache" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & NEVER


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "contextlib", "dataclasses", "hashlib",
               "typing", "torch", "numpy", "reference"}
    assert set(top_level_imports(path)) <= allowed


def test_the_names_are_compared_whole():
    assert "repro_torch" not in NEVER
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
