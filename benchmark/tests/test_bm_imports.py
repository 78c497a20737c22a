"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name, and the plain references import nothing of the
port."""

from __future__ import annotations

import ast

import pytest

from bm_util import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "dwarf_bench_tpu"}
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN
    assert "import_module(\"jax" not in path.read_text()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"dwarf_bench_tpu_torch"})
    assert top_level_imports(path) <= {"__future__", "torch", "numpy"}


def test_whole_names_are_compared():
    # the port's name begins with the JAX package's, and is allowed
    src = BENCH / "queries" / "sort.py"
    assert "dwarf_bench_tpu_torch" in top_level_imports(src)
    assert "dwarf_bench_tpu_torch" not in FORBIDDEN


def test_the_process_check_compares_whole_names(monkeypatch):
    import sys
    import types

    from benchmark import spec

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "dwarf_bench_tpu_torch.ops",
                        types.ModuleType("x"))
    assert spec.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dwarf_bench_tpu.ops",
                        types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("z"))
    assert spec.forbidden_modules() == ["dwarf_bench_tpu", "jaxlib"]
