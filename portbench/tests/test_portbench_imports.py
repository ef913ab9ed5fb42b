"""No module of the harness imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level names are compared
whole: ``p2igan_tpu_torch`` begins with ``p2igan_tpu`` and is allowed."""

from __future__ import annotations

import ast

import pytest

from conftest import HARNESS
from portbench import core

SOURCES = sorted(p for p in HARNESS.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HARNESS)))
def test_no_jax(path):
    assert not top_level_imports(path) & core.FORBIDDEN_MODULES


@pytest.mark.parametrize("path", sorted((HARNESS / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "p2igan_tpu_torch" not in top_level_imports(path)


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import p2igan_tpu_torch.models\nfrom p2igan_tpu_torch import x\n")
    assert not top_level_imports(src) & core.FORBIDDEN_MODULES
    src.write_text("from p2igan_tpu.models import p2igan\n")
    assert top_level_imports(src) & core.FORBIDDEN_MODULES == {"p2igan_tpu"}


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert core.forbidden_loaded() == ["jax"]
