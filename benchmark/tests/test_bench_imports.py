"""What the benchmark imports: never JAX or the JAX package (top-level
names compared whole), and from its reference nothing of the program."""

import ast
import os
import sys

import pytest

from conftest import BENCH
from core.main import FORBIDDEN, forbidden_modules


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        bad = set(_imports(path)) & set(FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "mm2d3d_tpu_torch" not in set(_imports(path)), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mm2d3d_tpu_torch_fake", object())
    assert "mm2d3d_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "mm2d3d_tpu.sub", object())
    assert "mm2d3d_tpu" in forbidden_modules()


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "mm2d3d_tpu"])
def test_each_forbidden_name_is_found(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, object())
    assert name in forbidden_modules()
