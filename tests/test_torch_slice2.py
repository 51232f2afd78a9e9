"""Slice 2 end to end: grouped aggregation, ORDER BY / LIMIT and PK-FK joins
(TPC-H Q1, Q12, Q3 and smaller queries) through the torch port's
`connect(...).sql(...)` against the JAX package's, at SF0.01 on the CPU.

The reference runs eagerly (`staged_execution = False`), the executor the
port mirrors.  Rows must match as `to_strings` renders them, exactly, except
DOUBLE cells, which get the 1e-9 relative tolerance of
`tpch/answers.cells_equal` (the two engines sum and divide floats in
different orders).  Each query also runs over the catalog carried from the
reference (`from_reference_catalog`).  On the CPU the kernel branch of the
PK probe runs K2's plain body; a counter on the wrapper shows it ran.

The tests that count calls or read the prepare cache do not depend on
what ran before them in the same process: they run on a catalog of their
own (`load_catalog(..., cache=False)`: its tables have uids no other
connection shares, so no prepare-cache entry made elsewhere matches), each
with an empty `Executor._prepare_cache`.
"""

from collections import OrderedDict

import pytest

from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.api import Connection, connect
from duckdb_cubit_tpu_torch.exec.executor import Executor
from duckdb_cubit_tpu_torch.ops import fused_scan as fs
from duckdb_cubit_tpu_torch.ops import probe
from duckdb_cubit_tpu_torch.tpch.load import (from_reference_catalog,
                                              load_catalog)

Q1 = """
    SELECT l_returnflag, l_linestatus,
           sum(l_quantity) AS sum_qty,
           sum(l_extendedprice) AS sum_base_price,
           sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
           avg(l_quantity) AS avg_qty,
           avg(l_extendedprice) AS avg_price,
           avg(l_discount) AS avg_disc,
           count(*) AS count_order
    FROM lineitem
    WHERE l_shipdate <= CAST('1998-09-02' AS date)
    GROUP BY l_returnflag, l_linestatus
    ORDER BY l_returnflag, l_linestatus
"""
Q3 = """
    SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
           o_orderdate, o_shippriority
    FROM customer, orders, lineitem
    WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
      AND l_orderkey = o_orderkey
      AND o_orderdate < CAST('1995-03-15' AS date)
      AND l_shipdate > CAST('1995-03-15' AS date)
    GROUP BY l_orderkey, o_orderdate, o_shippriority
    ORDER BY revenue DESC, o_orderdate
    LIMIT 10
"""
Q12 = """
    SELECT l_shipmode,
           sum(CASE WHEN o_orderpriority = '1-URGENT'
                     OR o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END)
               AS high_line_count,
           sum(CASE WHEN o_orderpriority <> '1-URGENT'
                    AND o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END)
               AS low_line_count
    FROM orders, lineitem
    WHERE o_orderkey = l_orderkey
      AND l_shipmode IN ('MAIL', 'SHIP')
      AND l_commitdate < l_receiptdate
      AND l_shipdate < l_commitdate
      AND l_receiptdate >= CAST('1994-01-01' AS date)
      AND l_receiptdate < CAST('1995-01-01' AS date)
    GROUP BY l_shipmode
    ORDER BY l_shipmode
"""
Q6 = """
    SELECT sum(l_extendedprice * l_discount) AS revenue
    FROM lineitem
    WHERE l_shipdate >= CAST('1994-01-01' AS date)
      AND l_shipdate < CAST('1995-01-01' AS date)
      AND l_discount BETWEEN 0.05 AND 0.07
      AND l_quantity < 24
"""

QUERIES = {
    "q1": Q1,
    "q3": Q3,
    "q12": Q12,
    # dense path over a dictionary key; ORDER BY ... DESC
    "grouped_varchar_desc": """
        SELECT l_shipmode, count(*) AS c, sum(l_quantity) AS q,
               min(l_extendedprice) AS mn, max(l_shipdate) AS mx,
               avg(l_extendedprice / l_quantity) AS unit
        FROM lineitem GROUP BY l_shipmode ORDER BY c DESC, l_shipmode
    """,
    # FK-dense grouping into orders' row space, top-N
    "fk_dense_group": """
        SELECT l_orderkey, sum(l_quantity) AS q, count(*) AS c,
               max(l_discount) AS md
        FROM lineitem GROUP BY l_orderkey ORDER BY q DESC, l_orderkey LIMIT 7
    """,
    # a small int (date) domain with more groups than the unrolled limit
    "date_domain_group": """
        SELECT l_shipdate, count(*) AS c, sum(l_extendedprice) AS s
        FROM lineitem WHERE l_shipmode = 'AIR'
        GROUP BY l_shipdate ORDER BY s DESC LIMIT 9
    """,
    # sort-based grouping on two keys
    "two_key_sort_group": """
        SELECT l_returnflag, l_extendedprice, count(*) AS c
        FROM lineitem WHERE l_quantity > 49
        GROUP BY l_returnflag, l_extendedprice
        ORDER BY c DESC, l_extendedprice LIMIT 10
    """,
    # NULL group keys from a left PK join: NULL is a group of its own
    "null_group_keys": """
        SELECT o_orderpriority, count(*) AS c, sum(l_quantity) AS q
        FROM lineitem LEFT JOIN
             (SELECT o_orderkey, o_orderpriority FROM orders
              WHERE o_totalprice < 100000) o
          ON l_orderkey = o_orderkey
        GROUP BY o_orderpriority ORDER BY o_orderpriority
    """,
    "left_pk_join": """
        SELECT count(*) AS c, count(o_orderdate) AS d,
               sum(o_shippriority) AS s, min(o_totalprice) AS mn
        FROM lineitem LEFT JOIN
             (SELECT o_orderkey, o_orderdate, o_shippriority, o_totalprice
              FROM orders WHERE o_totalprice > 250000) o
          ON l_orderkey = o_orderkey
    """,
    # ORDER BY a nullable key, DESC, with a LIMIT
    "order_nullable_limit": """
        SELECT l_orderkey, l_linenumber, o_orderdate
        FROM lineitem LEFT JOIN
             (SELECT o_orderkey, o_orderdate FROM orders
              WHERE o_totalprice > 300000) o
          ON l_orderkey = o_orderkey
        WHERE l_orderkey < 200
        ORDER BY o_orderdate DESC, l_orderkey, l_linenumber LIMIT 15
    """,
    "join_group_doubles": """
        SELECT o_orderpriority,
               avg(l_extendedprice * (1 - l_discount)) AS a,
               min(l_extendedprice / l_quantity) AS mn,
               max(o_totalprice) AS mt, count(*) AS c
        FROM lineitem, orders
        WHERE l_orderkey = o_orderkey
          AND l_shipdate < CAST('1995-01-01' AS date)
        GROUP BY o_orderpriority ORDER BY a DESC
    """,
    # a DOUBLE sort key, DESC
    "order_double_desc": """
        SELECT l_orderkey, l_linenumber, l_extendedprice / l_quantity AS unit
        FROM lineitem WHERE l_shipmode = 'AIR' AND l_quantity < 3
        ORDER BY unit DESC, l_orderkey LIMIT 12
    """,
    # semi join against a PK build side
    "semi_join_pk": """
        SELECT count(*) AS c FROM lineitem
        WHERE l_orderkey IN (SELECT o_orderkey FROM orders
                             WHERE o_totalprice > 350000)
    """,
    "limit_only": """
        SELECT l_orderkey, l_quantity FROM lineitem
        WHERE l_shipmode = 'RAIL' LIMIT 6
    """,
}


@pytest.fixture(scope="module")
def ref_conn():
    conn = ref_connect(sf=0.01)
    conn.config.staged_execution = False
    return conn


@pytest.fixture(scope="module")
def ref_rows(ref_conn):
    """The reference's result per query, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = ref_conn.sql(QUERIES[name])
        return cache[name]
    return get


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
def test_query_matches_reference(ref_rows, port_conns, source, name):
    _assert_rows_match(port_conns[source].sql(QUERIES[name]), ref_rows(name))


@pytest.mark.parametrize("name", list(QUERIES))
def test_explain_matches_reference(ref_conn, port_conns, name):
    assert port_conns["generated"].explain(QUERIES[name]) == \
        ref_conn.explain(QUERIES[name])


def test_tpch_answers_at_sf001(port_conns):
    """Spot values of the three TPC-H queries (the reference's results)."""
    conn = port_conns["generated"]
    assert conn.sql(Q12).strings() == [["MAIL", "64", "86"],
                                       ["SHIP", "61", "96"]]
    assert conn.sql(Q3).strings()[0] == ["47714", "267010.5894",
                                         "1995-03-11", "0"]
    q1 = conn.sql(Q1).strings()
    assert [r[:2] for r in q1] == [["A", "F"], ["N", "F"], ["N", "O"],
                                   ["R", "F"]]
    assert q1[0][9] == "14876"


@pytest.fixture(scope="module")
def own_conn():
    """A connection on a catalog no other connection shares (uncached)."""
    return Connection(load_catalog(0.01, device="cpu", cache=False),
                      device="cpu")


@pytest.fixture
def counting_conn(own_conn, monkeypatch):
    """`own_conn` with an empty prepare cache of the test's own."""
    monkeypatch.setattr(Executor, "_prepare_cache", OrderedDict())
    return own_conn


@pytest.fixture
def gather_calls(monkeypatch):
    """The lut count of each call of the many-lut gather wrapper by the
    operators."""
    calls = []
    real = probe.monotone_gather_many

    def counting(luts, keys):
        calls.append(len(luts))
        return real(luts, keys)
    monkeypatch.setattr(probe, "monotone_gather_many", counting)
    return calls


@pytest.mark.parametrize("name,least", [("q12", 2), ("q3", 1),
                                        ("join_group_doubles", 2),
                                        ("left_pk_join", 2)])
def test_kernel_branch_of_the_pk_probe_runs(counting_conn, gather_calls,
                                            name, least):
    """Sorted l_orderkey probes take the kernel branch of _pk_probe and fetch
    build values through value luts in the same pass: each join makes one
    call with the row lut and every value lut it reads; Q12 makes one call
    with 2 luts (the row, and o_orderpriority)."""
    counting_conn.sql(QUERIES[name]).strings()
    assert len(gather_calls) == 1
    assert gather_calls[0] >= least
    if name == "q12":
        assert gather_calls == [2]


@pytest.mark.parametrize("name,luts", [("q12", [2]), ("q3", [4]),
                                       ("semi_join_pk", [1])])
def test_one_gather_call_per_pk_join(ref_rows, counting_conn, gather_calls,
                                     name, luts):
    """Q12's join fetches its row and o_orderpriority in one call; Q3's
    lineitem -> orders join its row, o_orderdate, o_shippriority and
    o_custkey; a semi join the row alone.  The rows equal the
    reference's."""
    _assert_rows_match(counting_conn.sql(QUERIES[name]), ref_rows(name))
    assert gather_calls == luts


def test_overflow_retries_on_the_plain_path(ref_rows, counting_conn,
                                            monkeypatch):
    """An overflow reported once still gives Q12's rows: the executor sets
    _no_kernel_probe on the join, which changes its signature (a new
    prepare-cache entry), and runs the query again on the plain lut."""
    conn = counting_conn
    real = probe.monotone_gather_many
    seen = []

    def overflow_once(luts, keys):
        outs, ovf = real(luts, keys)
        seen.append(1)
        return outs, ovf + 1 if len(seen) == 1 else ovf
    monkeypatch.setattr(probe, "monotone_gather_many", overflow_once)
    retries = conn.executor.retry_count
    result = conn.sql(Q12)
    _assert_rows_match(result, ref_rows("q12"))
    assert conn.executor.retry_count == retries + 1
    join = next(op for op in conn.executor.plan.walk()
                if op.name == "hash_join")
    assert join._no_kernel_probe
    assert any(key[0] == conn.executor.plan.signature()
               for key in Executor._prepare_cache)
    flipped = join.signature()
    join._no_kernel_probe = False
    assert join.signature() != flipped


def test_unrecoverable_check_raises(counting_conn, monkeypatch):
    conn = counting_conn
    monkeypatch.setattr(Executor, "_handle_failed_checks",
                        staticmethod(lambda failed, ops: False))
    real = probe.monotone_gather_many
    monkeypatch.setattr(probe, "monotone_gather_many",
                        lambda luts, keys: (real(luts, keys)[0],
                                            real(luts, keys)[1] + 1))
    with pytest.raises(RuntimeError, match="pkprobe"):
        conn.sql(Q12)


@pytest.fixture
def fused_q6(counting_conn, monkeypatch):
    """Q6 on the fused scan-sum path (no row-id decode), with a count of
    pack_columns calls."""
    conn = counting_conn
    monkeypatch.setattr(conn.config, "index_scan_max_count", 0)
    monkeypatch.setattr(conn.config, "index_scan_percentage", 0.0)
    packs = []
    real = fs.pack_columns
    monkeypatch.setattr(fs, "pack_columns",
                        lambda a, b: packs.append(1) or real(a, b))
    return conn, packs


def test_repeated_query_does_not_pack_again(fused_q6):
    conn, packs = fused_q6
    first = conn.sql(Q6).strings()
    assert len(packs) == 1
    assert conn.sql(Q6).strings() == first == [["1193053.2253"]]
    assert len(packs) == 1
    assert len(Executor._prepare_cache) == 1


def test_use_pallas_is_part_of_the_cache_key(fused_q6, monkeypatch):
    conn, packs = fused_q6
    conn.sql(Q6).strings()
    key_on = conn.executor._catalog_version()
    monkeypatch.setattr(conn.config, "use_pallas", False)
    assert conn.executor._catalog_version() != key_on
    assert conn.sql(Q6).strings() == [["1193053.2253"]]
    assert len(Executor._prepare_cache) == 2
    assert len(packs) == 1
