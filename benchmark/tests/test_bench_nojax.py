"""The no-JAX check compares whole top-level module names, and nothing the
benchmark runs imports JAX, the JAX package, or the program from its
reference."""

import ast
import sys
import types

from conftest import BENCH
from harness import cell


def test_top_level_names_compared_whole(monkeypatch):
    for name in ("groot_tpu_torch", "groot_tpu_torch.cli", "jaxtyping", "groot_tpux"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert cell.loaded_forbidden() == []
    for name in ("jax", "jaxlib.xla_client", "groot_tpu.config", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert cell.loaded_forbidden() == ["flax", "groot_tpu.config", "jax", "jaxlib.xla_client"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "groot_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "bamread.py", "judge.py", "data.py"):
        tops = {m.split(".")[0] for m in _imports(BENCH / "harness" / name)}
        assert "groot_tpu_torch" not in tops, name
