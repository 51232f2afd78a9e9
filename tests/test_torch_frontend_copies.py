"""The backend-free frontend modules the torch port copies from the reference
must not drift: line for line equal, except import lines.

The machine with the card has no jax, and importing any reference module
runs the reference's `import jax`, so the port carries its own copies.  A
fix to the reference frontend has to be copied across; this test says where.
"""

import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["types.py", "config.py", "sql/lexer.py", "sql/ast.py",
          "sql/parser.py", "sql/binder.py", "tpch/schema.py",
          "plan/optimizer.py", "tpch/dists.json", "tpch/answers.py",
          "testing/__init__.py", "testing/sqllogic.py"]


def _body(path: str) -> list[str]:
    with open(path) as f:
        lines = f.read().splitlines()
    return [ln for ln in lines
            if not ln.lstrip().startswith(("import ", "from "))]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    ref = _body(os.path.join(ROOT, "duckdb_cubit_tpu", rel))
    port = _body(os.path.join(ROOT, "duckdb_cubit_tpu_torch", rel))
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"{rel}: first difference at body line {i + 1}"
    assert len(ref) == len(port), f"{rel}: line count differs"


@pytest.mark.parametrize("rel", COPIES)
def test_copy_imports_stay_inside_the_port(rel):
    path = os.path.join(ROOT, "duckdb_cubit_tpu_torch", rel)
    with open(path) as f:
        imports = [ln.strip() for ln in f
                   if ln.lstrip().startswith(("import ", "from "))]
    for ln in imports:
        assert "jax" not in ln and "duckdb_cubit_tpu" not in ln, (rel, ln)
