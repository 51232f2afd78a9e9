"""The Q6 slice end to end: the torch port's `connect(...).sql(...)` against
the JAX package's, at SF0.01 on the CPU.

Rows must match as `to_strings` renders them, exactly, except DOUBLE cells,
which get the 1e-9 relative tolerance of `tpch/answers.cells_equal` (the two
engines sum floats in different orders).  Each query also runs over the
catalog carried from the reference (`from_reference_catalog`).
"""

import pytest

from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.api import Connection, connect
from duckdb_cubit_tpu_torch.ops import fused_scan as fs
from duckdb_cubit_tpu_torch.tpch.load import from_reference_catalog

Q6 = """
    SELECT sum(l_extendedprice * l_discount) AS revenue
    FROM lineitem
    WHERE l_shipdate >= CAST('1994-01-01' AS date)
      AND l_shipdate < CAST('1995-01-01' AS date)
      AND l_discount BETWEEN 0.05 AND 0.07
      AND l_quantity < 24
"""

QUERIES = {
    "q6": Q6,
    # bounds off the bin edges: refine/residual filters, no fused path
    "q6_off_edges": """
        SELECT sum(l_extendedprice * l_discount) AS revenue
        FROM lineitem
        WHERE l_shipdate >= CAST('1994-01-10' AS date)
          AND l_shipdate < CAST('1994-12-20' AS date)
          AND l_discount BETWEEN 0.05 AND 0.07
          AND l_quantity < 23.5
    """,
    "ungrouped_aggregates": """
        SELECT count(*) AS c, min(l_extendedprice) AS mn,
               max(l_shipdate) AS mx, avg(l_quantity) AS aq,
               sum(l_tax) AS st, min(l_shipmode) AS sm
        FROM lineitem
        WHERE l_shipdate >= CAST('1995-03-01' AS date)
          AND l_shipdate < CAST('1995-09-01' AS date)
          AND l_discount = 0.04
    """,
    "single_column_sum": """
        SELECT sum(l_quantity) AS q FROM lineitem
        WHERE l_returnflag = 'R' AND l_shipmode = 'AIR'
    """,
    # low selectivity: decode to row ids, gather the projected columns
    "decode_path": """
        SELECT l_orderkey, l_extendedprice, l_shipdate FROM lineitem
        WHERE l_shipdate >= CAST('1995-03-01' AS date)
          AND l_shipdate < CAST('1995-04-01' AS date)
          AND l_discount = 0.04 AND l_quantity < 5
    """,
    "projection_arithmetic": """
        SELECT l_orderkey, l_extendedprice * (1 - l_discount) AS net,
               l_quantity + 1 AS q1, l_extendedprice / 100 AS d,
               CASE WHEN l_tax > 0.04 THEN l_tax ELSE 0 END AS t
        FROM lineitem
        WHERE l_orderkey < 400 AND l_shipmode IN ('AIR', 'RAIL', 'X')
          AND NOT l_linestatus = 'O'
    """,
    "empty_sum": """
        SELECT sum(l_extendedprice) AS s FROM lineitem
        WHERE l_shipdate < CAST('1980-01-01' AS date)
    """,
}


@pytest.fixture(scope="module")
def ref_conn():
    return ref_connect(sf=0.01)


@pytest.fixture(scope="module")
def port_conns(ref_conn):
    return {"generated": connect(sf=0.01, device="cpu"),
            "carried": Connection(from_reference_catalog(ref_conn.catalog,
                                                         device="cpu"),
                                  device="cpu")}


def _assert_rows_match(port_result, ref_result):
    got, want = port_result.strings(), ref_result.strings()
    kinds = [c.dtype.id.value for c in port_result.relation.columns.values()]
    assert kinds == [c.dtype.id.value
                     for c in ref_result.relation.columns.values()]
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        for g, w, kind in zip(g_row, w_row, kinds):
            if kind == "double":
                assert cells_equal(g, w), (g, w)
            else:
                assert g == w


@pytest.mark.parametrize("source", ["generated", "carried"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_query_matches_reference(ref_conn, port_conns, source, name):
    _assert_rows_match(port_conns[source].sql(QUERIES[name]),
                       ref_conn.sql(QUERIES[name]))


def test_in_list_on_char1_column_follows_sql(ref_conn, port_conns):
    """IN over a one-byte CHAR1 column matches its OR form.  The reference
    compares the byte codes with the strings and returns no row, so it is
    held to the OR form here."""
    got = port_conns["generated"].sql(
        "SELECT count(*) AS c FROM lineitem WHERE l_returnflag IN ('A', 'N')")
    want = ref_conn.sql("SELECT count(*) AS c FROM lineitem "
                        "WHERE l_returnflag = 'A' OR l_returnflag = 'N'")
    assert got.strings() == want.strings() != [["0"]]


def test_q6_answer(port_conns):
    assert port_conns["generated"].sql(Q6).strings() == [["1193053.2253"]]


@pytest.mark.parametrize("name", [n for n in QUERIES if n != "empty_sum"])
def test_query_returns_rows(port_conns, name):
    rows = port_conns["generated"].sql(QUERIES[name]).strings()
    assert 0 < len(rows) < 1000


@pytest.mark.parametrize("name", list(QUERIES))
def test_explain_matches_reference(ref_conn, port_conns, name):
    assert port_conns["generated"].explain(QUERIES[name]) == \
        ref_conn.explain(QUERIES[name])


@pytest.mark.parametrize("use_kernel", [True, False])
def test_fused_path_without_decode(ref_conn, port_conns, monkeypatch,
                                   use_kernel):
    """Decoding off: Q6 runs the fused scan-sum (through the kernel wrapper
    unless SET use_pallas = false) and still matches the reference."""
    conn = port_conns["generated"]
    calls = []
    real = fs.fused_scan_sum
    monkeypatch.setattr(fs, "fused_scan_sum",
                        lambda *a: calls.append(a) or real(*a))
    for c in (conn.config, ref_conn.config):
        monkeypatch.setattr(c, "index_scan_max_count", 0)
        monkeypatch.setattr(c, "index_scan_percentage", 0.0)
        monkeypatch.setattr(c, "use_pallas", use_kernel)
    _assert_rows_match(conn.sql(Q6), ref_conn.sql(Q6))
    assert len(calls) == (1 if use_kernel else 0)
    if use_kernel:
        _, payloads, packed = calls[0]
        assert packed and len(payloads) == 1


@pytest.mark.parametrize("sql,name", [
    # a two-column key: no direct-address PK build side
    ("SELECT count(*) FROM lineitem, partsupp "
     "WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey", "HashJoin"),
    ("SELECT l_orderkey, row_number() OVER (ORDER BY l_orderkey) AS r "
     "FROM lineitem", "WindowFunc"),
    ("SELECT count(*) FROM lineitem WHERE l_comment LIKE '%foo%'", "Like"),
    ("CREATE TABLE t (a INTEGER)", "CreateTable"),
])
def test_unported_parts_raise_by_name(port_conns, sql, name):
    with pytest.raises(NotImplementedError, match=name):
        port_conns["generated"].sql(sql)


def test_connection_refuses_a_catalog_on_another_device(port_conns):
    with pytest.raises(ValueError, match="cpu"):
        Connection(port_conns["generated"].catalog, device="meta")


def test_entry_points_default_to_the_card(monkeypatch):
    """connect, Connection and load_catalog run on "cuda" unless the caller
    asks for the CPU; read here without a card and without a launch."""
    import inspect

    import torch

    from duckdb_cubit_tpu_torch.storage.table import Catalog
    from duckdb_cubit_tpu_torch.tpch import load

    for fn in (connect, Connection.__init__, load.load_catalog):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    asked = []
    monkeypatch.setattr(load, "load_catalog",
                        lambda sf, *, device: asked.append((sf, device))
                        or Catalog())
    assert connect(0.01).device == torch.device("cuda")
    assert asked == [(0.01, torch.device("cuda"))]


def test_tensors_on_the_requested_device(port_conns):
    for t in port_conns["generated"].catalog.tables.values():
        assert all(c.data.device.type == "cpu" for c in t.columns.values())
        assert all(ix.words.device.type == "cpu" for ix in t.indexes.values())
