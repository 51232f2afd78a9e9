"""Statements: the torch port's CREATE TABLE [AS], CREATE INDEX, INSERT,
DROP, SET and EXPLAIN against the JAX package's, on the CPU.

The twin of the non-DML, non-persistent tests of `tests/test_statements.py`
(DELETE, UPDATE, transactions and checkpoints come later).  Added here: an
INSERT must not let a cached prepared plan or a PK value lut outlive the
table it was built for, new strings remap a dictionary column's codes, and
an append past the capacity grows the table and rebuilds its indexes.
"""

import numpy as np
import pytest

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu_torch.api import Connection
from duckdb_cubit_tpu_torch.ops import probe as PPK
from duckdb_cubit_tpu_torch.sql.statements import StatementError

SETUP = [
    "CREATE TABLE items (id INTEGER, price DECIMAL(12,2), "
    "qty BIGINT, day DATE, name VARCHAR)",
    "INSERT INTO items VALUES "
    "(1, 9.99, 5, DATE '2024-01-02', 'apple'), "
    "(2, 0.50, 100, DATE '2024-02-03', 'banana'), "
    "(3, 12.00, 7, DATE '2024-03-04', 'cherry'), "
    "(4, 3.25, 42, DATE '2024-01-20', 'banana')",
]


@pytest.fixture()
def conns():
    ref, port = RefConnection(), Connection(device="cpu")
    for sql in SETUP:
        ref.sql(sql)
        port.sql(sql)
    return ref, port


def both(conns, sql):
    """Run `sql` on both; -> the port's rows, after checking the
    reference's are the same."""
    ref, port = conns
    got = port.sql(sql).strings()
    assert got == ref.sql(sql).strings(), sql
    return got


def test_create_insert_select(conns):
    rows = both(conns, "SELECT id, price, name FROM items "
                "WHERE qty >= 7 ORDER BY id")
    assert rows == [["2", "0.50", "banana"],
                    ["3", "12.00", "cherry"],
                    ["4", "3.25", "banana"]]
    assert conns[1].sql("SELECT 1 AS a").status is None
    assert conns[1].sql("INSERT INTO items VALUES (5, 1.00, 1, "
                        "DATE '2024-05-05', 'date')").status == \
        "INSERT 1 (first rowid 4)"


@pytest.mark.parametrize("ddl", ["CREATE INDEX ON items(qty)",
                                 "CREATE INDEX ON items(qty) WITH (bins=3)",
                                 "CREATE INDEX ON items(name)"])
def test_create_index_accelerates_and_matches(conns, ddl):
    ref, port = conns
    for c in conns:
        c.sql(ddl)
    col = ddl.split("(")[1].split(")")[0]
    assert col in port.catalog.table("items").indexes
    both(conns, "SELECT id FROM items WHERE qty = 42 ORDER BY id")
    both(conns, "SELECT id FROM items WHERE name = 'banana' ORDER BY id")
    # index maintenance through INSERT: a delta merged into the bitmaps
    for c in conns:
        c.sql("INSERT INTO items VALUES (9, 1.00, 42, DATE '2024-04-04', "
              "'banana')")
    assert both(conns, "SELECT count(*) AS c FROM items WHERE qty = 42") == \
        [["2"]]
    assert both(conns, "SELECT count(*) AS c FROM items "
                "WHERE name = 'banana'") == [["3"]]


def test_create_pk_index_joins(conns):
    for c in conns:
        c.sql("CREATE TABLE o (k INTEGER, v INTEGER)")
        c.sql("INSERT INTO o VALUES (1, 10), (2, 20), (4, 40)")
        c.sql("CREATE UNIQUE INDEX ON o(k)")
    assert "k" in conns[1].catalog.table("o").pk_indexes
    assert both(conns, "SELECT id, v FROM items, o WHERE id = k "
                "ORDER BY id") == [["1", "10"], ["2", "20"], ["4", "40"]]
    with pytest.raises(StatementError, match="unsuitable"):
        conns[1].sql("CREATE INDEX ON items(name) USING pk")


def test_drop_and_set(conns):
    _, conn = conns
    conn.sql("DROP TABLE items")
    assert "items" not in conn.catalog.tables
    assert conn.sql("DROP TABLE IF EXISTS items").status == \
        "DROP TABLE (skipped)"
    conn.sql("SET index_scan_max_count = 4096")
    assert conn.config.index_scan_max_count == 4096
    with pytest.raises(KeyError, match="no_such_setting"):
        conn.sql("SET no_such_setting = 1")


def test_explain(conns):
    ref, port = conns
    sql = "EXPLAIN SELECT count(*) AS c FROM items WHERE qty > 5"
    r = port.sql(sql)
    text = "\n".join(line[0] for line in r.rows())
    assert "table_scan" in text and "group_aggregate" in text
    assert r.rows() == ref.sql(sql).rows() and r.status == "EXPLAIN"


def test_pragma_tpch_and_no_op_pragmas():
    conn = Connection(device="cpu")
    conn.load_tpch(0.01)
    r = conn.sql("PRAGMA tpch(6)")
    assert r.strings() == [["1193053.2253"]] and r.relation is None
    assert conn.sql("PRAGMA verify_parallelism").status == \
        "PRAGMA verify_parallelism"
    conn.sql("PRAGMA disable_verification")
    with pytest.raises(StatementError, match="unknown pragma"):
        conn.sql("PRAGMA frobnicate")


def test_statement_errors(conns):
    _, conn = conns
    with pytest.raises(StatementError, match="already exists"):
        conn.sql("CREATE TABLE items (id INTEGER)")  # duplicate
    with pytest.raises(IndexError):
        conn.sql("INSERT INTO items VALUES (1)")  # arity
    with pytest.raises(StatementError, match="every column"):
        conn.sql("INSERT INTO items (id) VALUES (1)")
    with pytest.raises(Exception):
        conn.sql("FROBNICATE all the things")
    with pytest.raises(StatementError, match="literals"):
        conn.sql("INSERT INTO items VALUES (1 + 1, 1.0, 1, "
                 "DATE '2024-01-01', 'x')")


def test_insert_null_values():
    ref, port = RefConnection(), Connection(device="cpu")
    cs = (ref, port)
    for c in cs:
        c.sql("CREATE TABLE ns (i INTEGER, s VARCHAR, d DOUBLE)")
        c.sql("INSERT INTO ns VALUES (1, 'a', 1.5), (NULL, NULL, NULL), "
              "(3, 'c', NULL)")
    assert both(cs, "SELECT i, s, d FROM ns ORDER BY i") == \
        [["1", "a", "1.5"], ["3", "c", "NULL"], ["NULL", "NULL", "NULL"]]
    # aggregates skip NULLs; count(*) does not
    assert both(cs, "SELECT count(*) AS a, count(i) AS b, sum(i) AS s, "
                "min(s) AS m FROM ns") == [["3", "2", "4", "a"]]
    assert both(cs, "SELECT count(*) AS c FROM ns WHERE i IS NULL") == \
        [["1"]]
    assert both(cs, "SELECT count(*) AS c FROM ns WHERE s IS NOT NULL") == \
        [["2"]]
    assert both(cs, "SELECT count(*) AS c FROM ns WHERE i < 10") == [["2"]]
    # a later append keeps the earlier NULLs and adds its own
    for c in cs:
        c.sql("INSERT INTO ns VALUES (NULL, 'z', 2.0)")
    assert both(cs, "SELECT count(i) AS a, count(s) AS b, count(d) AS c "
                "FROM ns") == [["2", "3", "2"]]


def test_select_without_from():
    conn = Connection(device="cpu")
    assert conn.sql("SELECT 1+2 AS a, 'x' AS s").strings() == [["3", "x"]]
    assert conn.sql("SELECT NULL AS n").strings() == [["NULL"]]
    assert conn.sql("SELECT 1 AS a WHERE 1 > 2").strings() == []


def test_create_table_as(conns):
    for c in conns:
        c.sql("CREATE TABLE t2 AS SELECT name, qty * 2 AS q2, "
              "CASE WHEN qty > 10 THEN price ELSE NULL END AS p "
              "FROM items WHERE id > 1")
    assert conns[1].sql("CREATE TABLE t3 AS SELECT id FROM items").status \
        == "CREATE TABLE t3 AS (4 rows)"
    assert both(conns, "SELECT name, q2, p FROM t2 ORDER BY q2") == \
        [["cherry", "14", "NULL"], ["banana", "84", "3.25"],
         ["banana", "200", "0.50"]]
    assert both(conns, "SELECT count(p) AS n FROM t2") == [["2"]]


def test_insert_invalidates_the_prepare_cache_and_value_luts():
    """A SELECT, an INSERT, the same SELECT: the second run must see the
    new row.  The join runs on the PK path with a value-lut fetch (sorted
    probe keys, >= 32768 of them); the INSERT rebuilds the PK index, so the
    cached value lut of the old index is gone, and bumps the version, so
    the prepared plan is not served again."""
    n = 40000
    ref, port = RefConnection(), Connection(device="cpu")
    fact = {"fk": np.arange(n, dtype=np.int64) % 4000}
    fact["fk"].sort()
    for c in (ref, port):
        c.register_numpy("f", fact)
        c.sql("CREATE TABLE d (k INTEGER, w INTEGER)")
        c.sql("INSERT INTO d VALUES " + ", ".join(
            f"({k}, {k % 7})" for k in range(0, 4000, 2)))
        c.sql("CREATE UNIQUE INDEX ON d(k)")
    sql = "SELECT count(*) AS n, sum(w) AS s FROM f, d WHERE fk = k"
    calls = []
    real = PPK.monotone_gather_many
    PPK.monotone_gather_many = lambda luts, keys: calls.append(
        len(luts)) or real(luts, keys)
    try:
        before = both((ref, port), sql)
        old = port.catalog.table("d").pk_indexes["k"]
        assert calls == [2] and "w" in old._value_luts
        version = port.catalog.table("d").version
        for c in (ref, port):
            c.sql("INSERT INTO d VALUES (1, 5), (3, 6)")
        after = both((ref, port), sql)
    finally:
        PPK.monotone_gather_many = real
    table = port.catalog.table("d")
    assert table.version > version and table.pk_indexes["k"] is not old
    assert int(after[0][0]) == int(before[0][0]) + 20
    assert int(after[0][1]) == int(before[0][1]) + 10 * 5 + 10 * 6
    assert calls == [2, 2]


def test_insert_of_new_strings_remaps_the_dictionary():
    """New strings between old ones re-encode the column: its codes stay
    sorted, so ordered string predicates and the CUBIT index on it still
    answer right."""
    cs = (RefConnection(), Connection(device="cpu"))
    for c in cs:
        c.sql("CREATE TABLE w (s VARCHAR, n INTEGER)")
        c.sql("INSERT INTO w VALUES ('b', 1), ('d', 2), ('f', 3)")
        c.sql("CREATE INDEX ON w(s)")
        c.sql("INSERT INTO w VALUES ('a', 4), ('c', 5), ('d', 6), "
              "('e', 7)")
    t = cs[1].catalog.table("w")
    assert list(t.columns["s"].dictionary) == [b"a", b"b", b"c", b"d", b"e",
                                               b"f"]
    assert both(cs, "SELECT s, n FROM w WHERE s < 'd' ORDER BY s") == \
        [["a", "4"], ["b", "1"], ["c", "5"]]
    assert both(cs, "SELECT n FROM w WHERE s = 'd' ORDER BY n") == \
        [["2"], ["6"]]
    assert both(cs, "SELECT s, count(*) AS c FROM w GROUP BY s "
                "ORDER BY s") == [["a", "1"], ["b", "1"], ["c", "1"],
                                  ["d", "2"], ["e", "1"], ["f", "1"]]


def test_insert_past_the_capacity_grows_the_table():
    """8190 registered rows plus 5 inserted ones cross the 8192-row
    capacity: the columns grow, the CUBIT index is rebuilt at the new
    capacity, and the narrowed int8 column widens for a large value."""
    base = {"k": np.arange(8190, dtype=np.int64) % 100,
            "v": np.arange(8190, dtype=np.int64)}
    cs = (RefConnection(), Connection(device="cpu"))
    for c in cs:
        c.register_numpy("g", base)
        c.sql("CREATE INDEX ON g(k)")
        c.sql("INSERT INTO g VALUES (7, 1), (7, 2), (99, 3), (1000, 4), "
              "(7, 5)")
    t = cs[1].catalog.table("g")
    assert t.capacity == 16384 and t.num_rows == 8195
    assert t.indexes["k"].capacity == 16384
    assert both(cs, "SELECT count(*) AS c, sum(v) AS s FROM g "
                "WHERE k = 7") == [["85", "332682"]]
    assert both(cs, "SELECT max(k) AS m FROM g") == [["1000"]]
