"""Nothing under portbench/ imports JAX or the JAX package, and nothing
under portbench/reference/ imports the program: the top-level name of each
import (the part before the first dot) is compared whole, since the
port's name begins with the JAX package's."""

import ast
import os

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "ofa_sr_tpu"}


def sources(sub=""):
    root = os.path.join(harness.BENCH_DIR, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p))
def test_no_jax_import(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")), ids=lambda p: os.path.relpath(p))
def test_reference_imports_nothing_of_the_program(path):
    assert "ofa_sr_tpu_torch" not in set(top_level_imports(path))


def test_the_run_check_compares_whole_top_level_names(monkeypatch):
    """The run's own check (after the window) flags JAX and the JAX
    package, never the port whose name begins with the package's."""
    import sys
    import types
    monkeypatch.setitem(sys.modules, "ofa_sr_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ofa_sr_tpu.models", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["ofa_sr_tpu"]
