"""The import guard: no file of the benchmark imports JAX, the JAX package
(`repro`) or `benchmarks/`, and the reference imports nothing of the
program.  Top-level module names are compared whole: `repro_torch` is the
port, `repro` the JAX package."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_repro_or_benchmarks(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "dataclasses", "typing", "torch"}


def test_the_guard_sees_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import repro_torch.models\nfrom repro.core import fabric\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert top_level_imports(f) == {"repro_torch", "repro", "importlib", "jax"}


def test_the_run_time_guard_sees_whole_names(monkeypatch):
    """`run.py` refuses to print a result while the process holds these."""
    import sys
    import types

    from bench import harness

    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert harness.loaded_forbidden() == ["repro"]
