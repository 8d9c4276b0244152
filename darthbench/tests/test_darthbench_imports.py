"""Nothing under darthbench/ imports JAX, flax or the JAX package, compared
by whole top-level name (``repro_torch`` starts with ``repro``), and
nothing reads the JAX package's harness (``benchmarks/``); the reference
imports nothing of the program."""
import ast
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported_tops(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_nor_the_jax_package(path):
    tops = imported_tops(path)
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    if path != pathlib.Path(__file__).resolve():
        assert "benchmarks/" not in path.read_text()


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "roofline.py", "stats.py"):
        assert "repro_torch" not in imported_tops(BENCH / name)


def test_the_run_time_check_compares_whole_names(monkeypatch):
    from darthbench import run

    import repro_torch  # noqa: F401
    assert "repro" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.loaded_forbidden() == ["repro"]
