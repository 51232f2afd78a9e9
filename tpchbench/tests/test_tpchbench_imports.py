"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the engine under test."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "duckdb_cubit_tpu"}
ENGINE = "duckdb_cubit_tpu_torch"


def _sources():
    for d, _, files in os.walk(HERE):
        if "_cache" in d or "_build" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(_sources())


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, HERE) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    bad = set(_top_level_imports(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_engine():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(_top_level_imports(os.path.join(ref, f)))
            assert ENGINE not in names, f
            # nor, through a relative import, a benchmark module that does
            assert "torch" not in names, f


def test_the_guard_compares_whole_names():
    """`duckdb_cubit_tpu_torch` starts with `duckdb_cubit_tpu` but is not
    it; the run's own check of sys.modules compares the same way."""
    from tpchbench import run
    assert ENGINE.split(".")[0] not in FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN
