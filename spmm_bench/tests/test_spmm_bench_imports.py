"""A static walk over the benchmark's sources: no module whose top-level
name, compared whole, is ``jax``, ``jaxlib``, ``flax`` or ``flex_tpu``, and
nothing under ``reference/`` but the standard numerics and the reference
itself."""
import ast
import os

from spmm_bench.tests.small import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "flex_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _sources(root):
    for d, _, files in os.walk(root):
        if "cache" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {(p, m) for p in _sources(BENCH) for m in _imports(p)
             if m.split(".")[0] in FORBIDDEN}
    assert not found


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    found = {(p, m) for p in _sources(ref) for m in _imports(p)
             if m.split(".")[0] not in {"__future__", "math", "numpy",
                                        "torch"}
             and m.split(".")[:2] != ["spmm_bench", "reference"]}
    assert not found


def test_the_walk_sees_imports():
    here = os.path.join(BENCH, "models", "gcn2.py")
    assert "flex_tpu_torch.models.gcn" in set(_imports(here))
