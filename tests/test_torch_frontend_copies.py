"""The backend-free frontend modules the torch port copies from the reference
must not drift: line for line equal, except import lines and the port's own
blocks.

The machine with the card has no jax, and importing any reference module
runs the reference's `import jax`, so the port carries its own copies.  A
fix to the reference frontend has to be copied across; this test says where.
What the port parses and binds beyond the reference (an aggregate's name
as a column, `sql/aggregates.py`) lies in blocks between a `# port-only {`
and a `# port-only }` line, which the comparison leaves out of the port's
side; every other line still has to equal the reference's.
"""

import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["types.py", "config.py", "sql/lexer.py", "sql/ast.py",
          "sql/parser.py", "sql/binder.py", "tpch/schema.py",
          "plan/optimizer.py", "tpch/dists.json", "tpch/answers.py",
          "testing/__init__.py", "testing/sqllogic.py"]


PORT_ONLY = ("# port-only {", "# port-only }")


def _body(path: str) -> list[str]:
    with open(path) as f:
        lines = f.read().splitlines()
    out, inside = [], False
    for ln in lines:
        mark = ln.strip()
        if mark in PORT_ONLY:
            assert inside == (mark == PORT_ONLY[1]), f"{path}: unbalanced {ln}"
            inside = not inside
        elif not inside and not ln.lstrip().startswith(("import ", "from ")):
            out.append(ln)
    assert not inside, f"{path}: a port-only block is not closed"
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    ref = os.path.join(ROOT, "duckdb_cubit_tpu", rel)
    with open(ref) as f:
        assert PORT_ONLY[0] not in f.read(), f"{rel}: a block in the reference"
    ref = _body(ref)
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
