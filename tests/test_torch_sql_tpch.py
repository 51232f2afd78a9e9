"""The 22 TPC-H queries as SQL text: the torch port's `conn.sql(SQL[n])`
against the JAX package's SQL path and against the port's own plan
builders, at SF0.01 on the CPU.

The twin of `tests/test_sql_tpch.py` without its golden mount: the texts are
the port's `tpch/sql_queries.py`, the reference binds and runs the same text
eagerly, and the port's builder of query n (`tpch/queries.run`) pins the
text to TPC-H's query n.  Rows must match as `to_strings` renders them, in
order, exactly, except DOUBLE cells, which get the 1e-9 relative tolerance
of `tpch/answers.cells_equal`.
"""

import pytest

from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu.sql.parser import parse as ref_parse
from duckdb_cubit_tpu_torch.api import connect
from duckdb_cubit_tpu_torch.exec import result as PR
from duckdb_cubit_tpu_torch.tpch import queries
from duckdb_cubit_tpu_torch.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL

# the texts whose plans hold the binder's subquery operators (the other
# EXISTS / IN texts decorrelate into semi / anti joins, the correlated scalar
# subqueries of q2, q17 and q20 into grouping and joins)
SUBQUERY_OPS = {11: "BroadcastScalar", 15: "BroadcastScalar",
                21: "MarkJoin", 22: "BroadcastScalar"}


@pytest.fixture(scope="module")
def ref_conn():
    return ref_connect(sf=0.01)


@pytest.fixture(scope="module")
def port_conn():
    return connect(sf=0.01, device="cpu")


def rows_match(got, want) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(w) and all(cells_equal(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


@pytest.mark.parametrize("n", sorted(SQL))
def test_sql_text_matches_reference_and_builder(ref_conn, port_conn, n):
    got = port_conn.sql(SQL[n]).strings()
    want = RR.to_strings(ref_conn.executor.execute(
        ref_conn.binder.bind_sql(SQL[n]), compiled=False))
    assert rows_match(got, want), (got[:3], want[:3])
    built = PR.to_strings(queries.run(port_conn.executor, n))
    assert rows_match(got, built), (got[:3], built[:3])


def test_all_22_texts_parse_in_the_reference():
    assert sorted(SQL) == list(range(1, 23))
    for n in SQL:
        ref_parse(SQL[n])


@pytest.mark.parametrize("n", sorted(SUBQUERY_OPS))
def test_subquery_texts_bind_to_their_operators(port_conn, n):
    kinds = {type(op).__name__
             for op in port_conn.binder.bind_sql(SQL[n]).walk()}
    assert SUBQUERY_OPS[n] in kinds, kinds
