"""ASOF and outer joins: the torch port against the JAX package, on the CPU.

The twin of `tests/test_outer_asof_joins.py`: its ASOF cases (inner, LEFT,
strict, reversed direction, ties and equal times) and its RIGHT / FULL
OUTER SQL cases (`tests/test_torch_hashjoin.py` covers the operator's
outer paths on seeded relations, not these statements).  Added here:
seeded tables with several keys per symbol, two-column and three-column
equi keys (the hash-combined path with its exact re-check), NULL times,
DATE times, and the `orders` ASOF self-join at SF0.01.  Rows must match
the reference as `to_strings` renders them.
"""

import numpy as np
import pytest

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu_torch.api import Connection, connect


def both_conns(tables: dict):
    ref, port = RefConnection(), Connection(device="cpu")
    for c in (ref, port):
        for name, cols in tables.items():
            c.register_numpy(name, cols)
    return ref, port


def same_rows(conns, sql):
    ref, port = conns
    got = port.sql(sql).strings()
    assert got == ref.sql(sql).strings(), sql
    return got


AB = {"a": {"k": np.array([1, 2, 3, 5], np.int64),
            "va": np.array([10, 20, 30, 50], np.int64)},
      "b": {"k": np.array([2, 3, 4], np.int64),
            "vb": np.array([200, 300, 400], np.int64)}}


@pytest.mark.parametrize("sql,want", [
    ("SELECT a.k, vb FROM a LEFT JOIN b ON a.k = b.k ORDER BY a.k",
     [["1", "NULL"], ["2", "200"], ["3", "300"], ["5", "NULL"]]),
    ("SELECT b.k, va FROM a RIGHT JOIN b ON a.k = b.k ORDER BY b.k",
     [["2", "20"], ["3", "30"], ["4", "NULL"]]),
    ("SELECT va, vb FROM a FULL OUTER JOIN b ON a.k = b.k ORDER BY va, vb",
     [["10", "NULL"], ["20", "200"], ["30", "300"], ["50", "NULL"],
      ["NULL", "400"]]),
    ("SELECT va, vb FROM a FULL JOIN b ON a.k = b.k WHERE vb = 400 "
     "ORDER BY va", [["NULL", "400"]]),
])
def test_outer_joins(sql, want):
    assert same_rows(both_conns(AB), sql) == want


def test_full_join_duplicates():
    conns = both_conns({
        "a": {"k": np.array([1, 1, 2], np.int64),
              "va": np.array([10, 11, 20], np.int64)},
        "b": {"k": np.array([1, 3, 3], np.int64),
              "vb": np.array([100, 300, 301], np.int64)}})
    assert same_rows(conns, "SELECT va, vb FROM a FULL JOIN b ON a.k = b.k "
                     "ORDER BY va, vb") == [
        ["10", "100"], ["11", "100"], ["20", "NULL"], ["NULL", "300"],
        ["NULL", "301"]]


TRADES = {
    "trades": {"sym": np.array([1, 1, 2, 2, 3], np.int64),
               "t": np.array([3, 10, 4, 1, 5], np.int64),
               "qty": np.array([100, 200, 300, 400, 500], np.int64)},
    "quotes": {"sym": np.array([1, 1, 1, 2, 2], np.int64),
               "qt": np.array([1, 5, 9, 2, 4], np.int64),
               "px": np.array([11, 15, 19, 22, 24], np.int64)}}


@pytest.mark.parametrize("join,op,want", [
    ("ASOF JOIN", ">=", [["100", "11"], ["200", "19"], ["300", "24"]]),
    ("ASOF LEFT JOIN", ">=", [["100", "11"], ["200", "19"], ["300", "24"],
                              ["400", "NULL"], ["500", "NULL"]]),
    ("ASOF JOIN", ">", [["100", "11"], ["200", "19"], ["300", "22"]]),
    ("ASOF JOIN", "<=", [["100", "15"], ["300", "24"], ["400", "22"]]),
    ("ASOF LEFT JOIN", "<", [["100", "15"], ["200", "NULL"],
                             ["300", "NULL"], ["400", "22"],
                             ["500", "NULL"]]),
], ids=["inner", "left", "strict", "reversed", "left_strict_reversed"])
def test_asof_trades_quotes(join, op, want):
    sql = (f"SELECT qty, px FROM trades {join} quotes ON trades.sym = "
           f"quotes.sym AND trades.t {op} quotes.qt ORDER BY qty")
    assert same_rows(both_conns(TRADES), sql) == want


def test_asof_ties_and_equal_times():
    conns = both_conns({
        "p": {"k": np.array([1, 1], np.int64), "t": np.array([5, 4], np.int64),
              "i": np.array([0, 1], np.int64)},
        "q": {"k": np.array([1, 1], np.int64),
              "t2": np.array([5, 5], np.int64),
              "v": np.array([7, 8], np.int64)}})
    rows = same_rows(conns, "SELECT i, v FROM p ASOF JOIN q ON p.k = q.k "
                     "AND p.t >= q.t2 ORDER BY i")
    assert len(rows) == 1 and rows[0][0] == "0" and rows[0][1] in ("7", "8")


def _seeded(seed, n_p=200, n_b=150):
    rng = np.random.default_rng(seed)
    return {
        "p": {"s": rng.integers(0, 12, n_p), "s2": rng.integers(0, 3, n_p),
              "s3": rng.integers(0, 2, n_p), "t": rng.integers(0, 500, n_p),
              "i": np.arange(n_p, dtype=np.int64)},
        "q": {"s": rng.integers(0, 12, n_b), "s2": rng.integers(0, 3, n_b),
              "s3": rng.integers(0, 2, n_b),
              "tq": rng.permutation(n_b * 3)[:n_b].astype(np.int64),
              "v": np.arange(n_b, dtype=np.int64) * 10}}


@pytest.mark.parametrize("keys", [
    "p.s = q.s", "p.s = q.s AND p.s2 = q.s2",
    "p.s = q.s AND p.s2 = q.s2 AND p.s3 = q.s3"], ids=["1key", "2keys",
                                                     "3keys"])
@pytest.mark.parametrize("op", [">=", ">", "<=", "<"])
@pytest.mark.parametrize("join", ["ASOF JOIN", "ASOF LEFT JOIN"])
def test_asof_seeded_matches_reference(keys, op, join):
    """Distinct build times per table, so every match is unique and the
    rows must agree exactly."""
    conns = both_conns(_seeded(7))
    same_rows(conns, f"SELECT i, v FROM p {join} q ON {keys} AND "
              f"p.t {op} q.tq ORDER BY i")


def test_asof_null_and_date_times():
    for c in (ref := RefConnection(), port := Connection(device="cpu")):
        c.sql("CREATE TABLE ev (k INTEGER, d DATE, i INTEGER)")
        c.sql("INSERT INTO ev VALUES (1, DATE '1995-03-01', 0), "
              "(1, NULL, 1), (2, DATE '1996-01-01', 2), "
              "(1, DATE '1994-12-31', 3)")
        c.sql("CREATE TABLE st (k INTEGER, d DATE, v INTEGER)")
        c.sql("INSERT INTO st VALUES (1, DATE '1995-01-01', 10), "
              "(1, NULL, 11), (1, DATE '1995-02-28', 12), "
              "(2, DATE '1996-01-02', 13)")
    for join in ("ASOF JOIN", "ASOF LEFT JOIN"):
        same_rows((ref, port), f"SELECT i, v FROM ev {join} st ON ev.k = "
                  f"st.k AND ev.d >= st.d ORDER BY i")


def test_orders_previous_order_at_sf001():
    """Each order's previous order by the same customer (the card run's
    A1 at SF0.01), against the reference and a numpy oracle."""
    ref, port = ref_connect(sf=0.01), connect(0.01, device="cpu")
    sql = ("SELECT count(*) AS c, sum(o2.o_totalprice) AS s FROM orders o1 "
           "ASOF JOIN orders o2 ON o1.o_custkey = o2.o_custkey AND "
           "o1.o_orderdate > o2.o_orderdate")
    got = same_rows((ref, port), sql)
    left = same_rows((ref, port), "SELECT count(*) AS c FROM orders o1 "
                     "ASOF LEFT JOIN orders o2 ON o1.o_custkey = "
                     "o2.o_custkey AND o1.o_orderdate > o2.o_orderdate")
    t = port.catalog.table("orders")
    cust = t.columns["o_custkey"].host[:t.num_rows].astype(np.int64)
    date = t.columns["o_orderdate"].host[:t.num_rows].astype(np.int64)
    assert left == [[str(t.num_rows)]]
    # the oracle counts probe rows with an earlier order of the customer
    first = {}
    for c, d in zip(cust, date):
        first[c] = min(first.get(c, d), d)
    want = sum(1 for c, d in zip(cust, date) if first[c] < d)
    assert got[0][0] == str(want)
