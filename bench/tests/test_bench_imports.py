"""Nothing under bench/ imports JAX or the JAX package, compared by whole
top-level names (``repro_torch`` is not ``repro``), and the reference
imports nothing of the program either."""

from __future__ import annotations

import ast

import pytest

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in (ROOT / "bench").rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax(path):
    assert not BANNED & set(_imports(path))


@pytest.mark.parametrize("path", sorted((ROOT / "bench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "contextlib", "math", "torch", "bench"}
    assert not any(m.startswith("bench.harness") for m in _modules(path))


def _modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_banned_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    from bench.harness import env

    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("repro_torch_like"))
    assert "repro" not in env.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.x", types.ModuleType("repro.x"))
    assert env.banned_modules() == ["repro"]


def test_run_fails_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import runpy

    with pytest.raises(SystemExit) as stop:
        import sys
        argv = sys.argv
        sys.argv = ["run.py", "--workload", "glm4-9b.train-4k", "--seed", "1", "--seconds", "1"]
        try:
            runpy.run_path(str(ROOT / "bench" / "run.py"), run_name="__main__")
        finally:
            sys.argv = argv
    assert stop.value.code == 2
    out = capsys.readouterr()
    assert out.out == "" and "cuda" in out.err
