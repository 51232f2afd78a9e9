"""The SQL frontend end to end: the torch port's parse -> bind -> execute
against the JAX package's, at SF0.01 on the CPU.

The twin of `tests/test_sql.py` without its golden CSVs: Q1 and Q6 as SQL,
a join aggregate, select / limit, a scalar subquery, the interval fold and
EXPLAIN, each held to the reference's rows (DOUBLE cells within the 1e-9
relative tolerance of `tpch/answers.cells_equal`).
"""

import pytest

from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu_torch.api import connect
from duckdb_cubit_tpu_torch.sql.parser import parse
from duckdb_cubit_tpu_torch.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL


@pytest.fixture(scope="module")
def conns():
    return ref_connect(sf=0.01), connect(sf=0.01, device="cpu")


def both(conns, sql):
    ref, port = conns
    got, want = port.sql(sql).strings(), ref.sql(sql).strings()
    assert len(got) == len(want) and all(
        len(g) == len(w) and all(cells_equal(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want)), (got[:3], want[:3])
    return got


def test_parse_all_tpch_queries():
    for n in SQL:
        parse(SQL[n])


@pytest.mark.parametrize("n", [1, 6])
def test_sql_q1_q6_match_reference(conns, n):
    assert len(both(conns, SQL[n])) == {1: 4, 6: 1}[n]


def test_sql_join_aggregate(conns):
    # revenue per nation for one month, via SQL joins
    rows = both(conns, """
        SELECT n_name, count(*) AS cnt
        FROM lineitem, supplier, nation
        WHERE l_suppkey = s_suppkey AND s_nationkey = n_nationkey
          AND l_shipdate >= date '1994-01-01'
          AND l_shipdate < date '1994-02-01'
        GROUP BY n_name
        ORDER BY cnt DESC, n_name
        LIMIT 5
    """)
    assert len(rows) == 5
    assert int(rows[0][1]) >= int(rows[1][1])


def test_sql_simple_select_limit(conns):
    rows = both(conns, "SELECT n_name, n_regionkey FROM nation "
                "ORDER BY n_name LIMIT 3")
    assert rows[0][0] == "ALGERIA"
    assert len(rows) == 3


def test_sql_scalar_subquery(conns):
    rows = both(conns, """
        SELECT count(*) AS n FROM orders
        WHERE o_totalprice > (SELECT avg(o_totalprice) FROM orders)
    """)
    n = int(rows[0][0])
    total = int(both(conns, "SELECT count(*) AS n FROM orders")[0][0])
    assert 0 < n < total


def test_sql_date_interval_fold(conns):
    a = both(conns, "SELECT count(*) AS n FROM orders "
             "WHERE o_orderdate < date '1998-12-01' - interval '90' day")
    b = both(conns, "SELECT count(*) AS n FROM orders "
             "WHERE o_orderdate < date '1998-09-02'")
    assert a == b


def test_explain(conns):
    ref, port = conns
    sql = "SELECT count(*) AS n FROM lineitem WHERE l_quantity < 10"
    text = port.explain(sql)
    assert "table_scan" in text and "group_aggregate" in text
    assert text == ref.explain(sql)
