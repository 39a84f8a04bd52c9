"""Nothing under gbench/ imports JAX, the JAX package or the JAX
harnesses, the modules found by name (gbench/checks, the reference's
scenes) among them: each import's top-level name (before the first dot)
is compared whole, since the port's name gvpm_tpu_torch begins with the
JAX package's."""

import ast
import os

import pytest

from gbench import run

GBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "gvpm_tpu", "bench", "chip_smoke"}


def _sources():
    for d, _, files in os.walk(GBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, GBENCH))
def test_no_forbidden_import(path):
    assert not set(_top_names(path)) & FORBIDDEN


def test_found_modules_are_scanned():
    """The modules found by name (check modules, reference scenes, metric
    readers) are among the sources scanned."""
    scanned = {os.path.relpath(p, GBENCH) for p in _sources()}
    for folder in ("checks", os.path.join("reference", "scenes"), "metrics"):
        found = {os.path.join(folder, f)
                 for f in os.listdir(os.path.join(GBENCH, folder))
                 if f.endswith(".py")}
        assert found and found <= scanned, folder
    assert {os.path.join("checks", "distance.py"),
            os.path.join("checks", "plane0d.py"),
            os.path.join("reference", "scenes", "box_medium.py")} <= scanned


def test_whole_name_compare():
    assert run.forbidden_modules(["gvpm_tpu_torch", "gvpm_tpu_torch.ops",
                                  "jaxtyping", "benchmark"]) == []
    assert run.forbidden_modules(["jax.numpy", "gvpm_tpu.ops",
                                  "chip_smoke"]) == [
        "chip_smoke", "gvpm_tpu", "jax"]
    assert set(run.FORBIDDEN) == FORBIDDEN
