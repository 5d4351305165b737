"""The import boundary: nothing under ``portbench/`` imports JAX or the
JAX package ``repro`` (compared by whole top-level name: the port is
``repro_torch``), and the plain reference imports nothing of the port."""
import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in imported(path)


def test_benchmarks_folder_is_not_read():
    for path in SOURCES:
        if path.parent.name != "tests":
            assert "benchmarks" not in imported(path)


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    import repro_torch  # noqa: F401  (the port: its name begins "repro")

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.banned_modules()
