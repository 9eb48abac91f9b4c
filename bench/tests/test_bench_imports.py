"""No module of the benchmark imports JAX, Flax, the JAX package or the
JAX package's harness; the reference imports nothing of the program.
Top-level names are compared whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import sys

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "contextlib",
                                       "dataclasses", "torch", "reference"}


def test_the_run_check_compares_whole_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert run.forbidden_modules() == ["repro"]
