"""DELETE, UPDATE and transactions: the torch port against the JAX package,
on the CPU.

The twin of `tests/test_dml.py` (the storage calls, with the index words,
bin counts, columns and deleted masks bit-equal) and of the DELETE /
UPDATE / transaction tests of `tests/test_statements.py` (through SQL on
both packages; rows as `to_strings` renders them, DOUBLE cells within the
1e-9 relative tolerance of `tpch/answers.cells_equal`).  Added here:

- ROLLBACK after an UPDATE gives back the column tensors, the CUBIT index
  and the PK index with its value luts as they were;
- BEGIN, UPDATE, query, ROLLBACK, BEGIN, another UPDATE that reaches the
  same table version, query: the second query must follow the second
  update (a prepared plan cached for the rolled-back state must not be
  served);
- a Q3-shaped PK join after an UPDATE of a column it fetches through a
  value lut and after a DELETE of build rows, against the reference at
  SF0.01;
- the stale value luts and sortedness after UPDATE (the reference's fault,
  marked): the port drops them;
- Q6's fused scan-sum kernel path declines on a table with deleted rows and
  is taken again after ROLLBACK;
- `from_reference_catalog` of a reference catalog with deleted rows.
"""

import numpy as np
import pytest
import torch

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu.exec.executor import Executor as RefExecutor
from duckdb_cubit_tpu.index.cubit import CubitIndex as RefCubit
from duckdb_cubit_tpu.ops.expressions import Col as RCol
from duckdb_cubit_tpu.plan import physical as RP
from duckdb_cubit_tpu.storage import dml as rdml
from duckdb_cubit_tpu.storage.table import Catalog as RefCatalog
from duckdb_cubit_tpu.storage.table import from_numpy as ref_from_numpy
from duckdb_cubit_tpu.tpch import load as rload
from duckdb_cubit_tpu_torch.api import Connection
from duckdb_cubit_tpu_torch.exec import result as PR
from duckdb_cubit_tpu_torch.exec.executor import Executor
from duckdb_cubit_tpu_torch.index.cubit import CubitIndex
from duckdb_cubit_tpu_torch.ops import fused_scan as fs
from duckdb_cubit_tpu_torch.ops import probe as PPK
from duckdb_cubit_tpu_torch.ops.expressions import Col
from duckdb_cubit_tpu_torch.plan import physical as P
from duckdb_cubit_tpu_torch.storage import dml
from duckdb_cubit_tpu_torch.storage.table import Catalog, from_numpy
from duckdb_cubit_tpu_torch.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.tpch.load import (from_reference_catalog,
                                              load_catalog)
from test_torch_slice2 import Q1, Q3, Q6, Q12

DATA = {
    "k": np.arange(1, 101, dtype=np.int64),
    "v": (np.arange(100) % 10).astype(np.int64),
    "s": np.array([b"aa", b"bb"] * 50, dtype="S2"),
}


def make_tables():
    r = ref_from_numpy("t", DATA)
    r.indexes["v"] = RefCubit.build("v", DATA["v"].astype(np.int32),
                                    r.capacity, r.num_rows, 10)
    p = from_numpy("t", DATA, device="cpu")
    p.indexes["v"] = CubitIndex.build("v", DATA["v"].astype(np.int32),
                                      p.capacity, p.num_rows, 10,
                                      device="cpu")
    return r, p


def count_v(r, p, value) -> int:
    rc, pc = RefCatalog(), Catalog()
    rc.register(r)
    pc.register(p)
    want = RefExecutor(rc).execute(RP.GroupAggregate(
        RP.TableScan("t", filters=[RCol("v") == value]), [],
        [RP.Aggregate("count", None, "n")]), compiled=False)
    got = Executor(pc).execute(P.GroupAggregate(
        P.TableScan("t", filters=[Col("v") == value]), [],
        [P.Aggregate("count", None, "n")]))
    assert PR.to_strings(got) == RR.to_strings(want)
    return int(got.columns["n"].array[0])


def assert_tables_equal(r, p):
    assert (r.num_rows, r.capacity) == (p.num_rows, p.capacity)
    for name, rc in r.columns.items():
        np.testing.assert_array_equal(np.asarray(rc.data),
                                      p.columns[name].data.numpy())
    if getattr(r, "deleted", None) is None:
        assert p.deleted is None
    else:
        np.testing.assert_array_equal(np.asarray(r.deleted),
                                      p.deleted.numpy())
    for name, ri in r.indexes.items():
        pi = p.indexes[name]
        np.testing.assert_array_equal(
            np.asarray(ri.words, dtype=np.uint32).view(np.int32),
            pi.words.numpy())
        np.testing.assert_array_equal(ri.bin_counts, pi.bin_counts)
        assert ri.epoch == pi.epoch


def test_delete_updates_index_and_scan():
    r, p = make_tables()
    assert count_v(r, p, 3) == 10
    rdml.delete_rows(r, [3, 13, 23])
    dml.delete_rows(p, [3, 13, 23])
    assert count_v(r, p, 3) == 7
    assert p.indexes["v"].count(p.indexes["v"].query_eq(3)) == 7
    assert_tables_equal(r, p)


def test_update_moves_bitmap_bits():
    r, p = make_tables()
    before_7 = p.indexes["v"].count(p.indexes["v"].query_eq(7))
    rdml.update_column(r, "v", [5, 15], [7, 7])
    dml.update_column(p, "v", [5, 15], [7, 7])
    assert p.indexes["v"].count(p.indexes["v"].query_eq(7)) == before_7 + 2
    assert count_v(r, p, 7) == before_7 + 2
    assert_tables_equal(r, p)


def test_append_within_capacity_then_delete():
    r, p = make_tables()
    rows = {"k": np.array([101, 102], dtype=np.int64),
            "v": np.array([3, 0], dtype=np.int64),
            "s": np.array([b"cc", b"aa"], dtype="S2")}
    assert rdml.append_rows(r, rows) == dml.append_rows(p, rows) == 100
    assert count_v(r, p, 3) == 11
    rdml.delete_rows(r, [101])
    dml.delete_rows(p, [101])
    assert count_v(r, p, 0) == 10
    assert b"cc" in p.columns["s"].dictionary
    assert_tables_equal(r, p)


def test_append_past_capacity_grows_the_deleted_mask():
    r, p = make_tables()
    rdml.delete_rows(r, [0, 99])
    dml.delete_rows(p, [0, 99])
    n = 8200
    rows = {"k": np.arange(200, 200 + n, dtype=np.int64),
            "v": np.arange(n, dtype=np.int64) % 10,
            "s": np.array([b"aa"] * n, dtype="S2")}
    rdml.append_rows(r, rows)
    dml.append_rows(p, rows)
    assert p.deleted.shape[0] == p.capacity == 16384
    assert count_v(r, p, 0) == 9 + n // 10
    np.testing.assert_array_equal(np.asarray(r.deleted), p.deleted.numpy())


def test_update_refuses_values_outside_the_index_bins():
    """A value past an identity index's bins: the reference fails inside
    the merge, after the column was written; the port refuses before
    anything changes."""
    _, p = make_tables()
    version = p.version
    with pytest.raises(dml.DmlError, match="bins"):
        dml.update_column(p, "v", [1], [10])
    assert p.version == version and int(p.columns["v"].data[1]) == 1
    with pytest.raises(dml.DmlError, match="VARCHAR"):
        dml.update_column(p, "s", [1], [b"zz"])


# --------------------------------------------------------- through SQL
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
    """Run `sql` on both; -> the port's rows (or status), after checking
    the reference's are the same."""
    ref, port = conns
    got, want = port.sql(sql), ref.sql(sql)
    g, w = got.strings(), want.strings()
    assert len(g) == len(w) and all(
        len(a) == len(b) and all(cells_equal(x, y) for x, y in zip(a, b))
        for a, b in zip(g, w)), (sql, g, w)
    assert got.status == want.status, sql
    return got.status or g


def test_delete(conns):
    assert both(conns, "DELETE FROM items WHERE name = 'banana'") == \
        "DELETE 2"
    assert both(conns, "SELECT count(*) AS c FROM items") == [["2"]]
    assert both(conns, "DELETE FROM items WHERE id > 100") == "DELETE 0"
    assert both(conns, "DELETE FROM items") == "DELETE 2"
    assert both(conns, "SELECT count(*) AS c FROM items") == [["0"]]


def test_update_literal_and_expr(conns):
    assert both(conns, "UPDATE items SET qty = 1 WHERE id = 1") == \
        "UPDATE 1"
    assert both(conns, "SELECT qty FROM items WHERE id = 1") == [["1"]]
    both(conns, "UPDATE items SET qty = qty + 10 WHERE id <= 2")
    assert both(conns, "SELECT id, qty FROM items WHERE id <= 2 "
                "ORDER BY id") == [["1", "11"], ["2", "110"]]
    both(conns, "UPDATE items SET price = price + 1.25, id = id * 10 "
         "WHERE qty > 10")
    assert both(conns, "SELECT id, price FROM items ORDER BY id") == [
        ["3", "12.00"], ["10", "11.24"], ["20", "1.75"], ["40", "4.50"]]


def test_update_follows_sql_where_the_reference_does_not():
    """Port-only semantics, each a reference fault: an assignment reads
    the rows as they were before the statement, a DECIMAL expression of
    another scale is brought to the column's, and NULL is stored as
    NULL."""
    conn = Connection(device="cpu")
    for sql in SETUP:
        conn.sql(sql)
    conn.sql("UPDATE items SET id = qty, qty = id WHERE id = 1")
    assert conn.sql("SELECT id, qty FROM items WHERE qty = 1").strings() == \
        [["5", "1"]]
    conn.sql("UPDATE items SET price = price * 1.5 WHERE name = 'cherry'")
    assert conn.sql("SELECT price FROM items WHERE name = 'cherry'"
                    ).strings() == [["18.00"]]
    conn.sql("UPDATE items SET qty = NULL WHERE id = 2")
    assert conn.sql("SELECT count(qty) AS c FROM items").strings() == [["3"]]


def test_update_varchar_is_refused_by_name(conns):
    for c in conns:
        with pytest.raises(Exception, match="VARCHAR update"):
            c.sql("UPDATE items SET name = 'x' WHERE id = 1")


def test_create_index_then_dml(conns):
    both(conns, "CREATE INDEX ON items(qty)")
    assert both(conns, "SELECT id FROM items WHERE qty = 42") == [["4"]]
    both(conns, "DELETE FROM items WHERE qty = 42")
    assert both(conns, "SELECT count(*) AS c FROM items WHERE qty = 42") == \
        [["0"]]
    both(conns, "UPDATE items SET qty = 7 WHERE id = 1")
    assert both(conns, "SELECT id FROM items WHERE qty = 7 ORDER BY id") == \
        [["1"], ["3"]]


def test_transactions_rollback_and_commit(conns):
    before = both(conns, "SELECT count(*) AS c FROM items")
    assert both(conns, "BEGIN") == "BEGIN"
    both(conns, "DELETE FROM items")
    assert both(conns, "SELECT count(*) AS c FROM items") == [["0"]]
    assert both(conns, "ROLLBACK") == "ROLLBACK"
    assert both(conns, "SELECT count(*) AS c FROM items") == before
    both(conns, "BEGIN")
    both(conns, "DELETE FROM items WHERE id = 1")
    assert both(conns, "COMMIT") == "COMMIT"
    assert both(conns, "SELECT count(*) AS c FROM items") == [["3"]]
    for c in conns:
        with pytest.raises(RuntimeError, match="no active transaction"):
            c.sql("COMMIT")
        c.sql("BEGIN")
        with pytest.raises(RuntimeError, match="already active"):
            c.sql("BEGIN")


def test_rollback_restores_updates_and_indexes(conns):
    _, port = conns
    both(conns, "CREATE INDEX ON items(qty)")
    t = port.catalog.table("items")
    data, words = t.columns["qty"].data, t.indexes["qty"].words
    both(conns, "BEGIN")
    both(conns, "UPDATE items SET qty = 999 WHERE id = 2")
    assert both(conns, "SELECT qty FROM items WHERE id = 2") == [["999"]]
    both(conns, "ROLLBACK")
    assert both(conns, "SELECT qty FROM items WHERE id = 2") == [["100"]]
    assert both(conns, "SELECT id FROM items WHERE qty = 100") == [["2"]]
    t = port.catalog.table("items")
    # the update wrote fresh tensors: the snapshot's are untouched
    assert t.columns["qty"].data is data and t.indexes["qty"].words is words
    assert data.tolist()[:4] == [5, 100, 7, 42]


# ----------------------------------------- prepare cache and PK value luts
def fact_dim():
    n = 40000
    fk = np.sort(np.arange(n, dtype=np.int64) % 4000)
    ref, port = RefConnection(), Connection(device="cpu")
    for c in (ref, port):
        c.register_numpy("f", {"fk": fk})
        c.sql("CREATE TABLE d (k INTEGER, w INTEGER)")
        c.sql("INSERT INTO d VALUES " + ", ".join(
            f"({k}, {k % 7})" for k in range(0, 4000, 2)))
        c.sql("CREATE UNIQUE INDEX ON d(k)")
        c.sql("CREATE INDEX ON d(w)")
    return ref, port


JOIN = "SELECT count(*) AS n, sum(w) AS s FROM f, d WHERE fk = k"


def test_rollback_restores_the_pk_index_and_its_value_luts():
    ref, port = conns = fact_dim()
    before = both(conns, JOIN)
    t = port.catalog.table("d")
    pk, lut = t.pk_indexes["k"], t.pk_indexes["k"]._value_luts["w"]
    both(conns, "BEGIN")
    both(conns, "UPDATE d SET w = w + 100 WHERE k < 1000")
    after = both(conns, JOIN)
    assert int(after[0][1]) == int(before[0][1]) + 100 * 10 * 500
    # the updated column's value lut went with a replaced index object
    assert port.catalog.table("d").pk_indexes["k"] is not pk
    assert "w" in pk._value_luts and pk._value_luts["w"] is lut
    both(conns, "ROLLBACK")
    t = port.catalog.table("d")
    assert t.pk_indexes["k"] is pk and pk._value_luts["w"] is lut
    assert both(conns, JOIN) == before


def test_repeated_version_after_rollback_is_not_served_stale():
    """The second transaction's UPDATE reaches the same table version as
    the rolled-back one; its query (answered from the CUBIT index words a
    prepared plan caches) must follow the second update.  The reference's
    fault (marked): its ROLLBACK keeps the table's uid, so the prepare
    cache serves the rolled-back state's plan and the count of the first
    update; the port restores a changed table under a new uid."""
    ref, port = conns = fact_dim()
    q = "SELECT count(*) AS n FROM d WHERE w = 3"
    base = both(conns, q)
    t = port.catalog.table("d")
    version = t.version
    both(conns, "BEGIN")
    both(conns, "UPDATE d SET w = 3 WHERE k < 400")
    first = both(conns, q)
    v1 = port.catalog.table("d").version
    both(conns, "ROLLBACK")
    assert both(conns, q) == base
    for c in conns:
        c.sql("BEGIN")
        c.sql("UPDATE d SET w = 3 WHERE k >= 3000")
    assert port.catalog.table("d").version == v1 == version + 1
    assert ref.catalog.table("d").version == v1
    second = port.sql(q).strings()
    d = port.catalog.table("d")
    w = d.columns["w"].host[:d.num_rows]
    assert second == [[str(int((w == 3).sum()))]] and second != first
    assert ref.sql(q).strings() == first       # the reference's fault
    port.sql("COMMIT")


def test_update_drops_stale_value_luts_and_sortedness():
    """The reference's fault (marked): its UPDATE leaves `is_sorted` and
    the cached PK value luts as they were.  In the port an UPDATE of a
    fetched column makes the join fetch its new values, and an UPDATE of a
    sorted column clears `is_sorted` (the scan's `monotone`, which the
    kernel probe's eligibility trusts)."""
    _, port = fact_dim()
    calls = []
    real = PPK.monotone_gather_many
    PPK.monotone_gather_many = lambda luts, keys: calls.append(
        len(luts)) or real(luts, keys)
    try:
        before = port.sql(JOIN).strings()
        assert calls == [2]
        port.sql("UPDATE d SET w = 50 WHERE k = 10")
        after = port.sql(JOIN).strings()
    finally:
        PPK.monotone_gather_many = real
    assert calls == [2, 2]
    assert int(after[0][1]) == int(before[0][1]) + 10 * (50 - 10 % 7)
    f = port.catalog.table("f")
    assert f.columns["fk"].is_sorted
    port.sql("UPDATE f SET fk = 0 WHERE fk = 3998")
    assert not f.columns["fk"].is_sorted
    got = port.sql(JOIN).strings()
    assert int(got[0][0]) == int(after[0][0]) and \
        int(got[0][1]) == int(after[0][1]) - 10 * (3998 % 7) + 10 * 0


# ------------------------------------------------------ TPC-H at SF0.01
@pytest.fixture()
def tpch_conns():
    """Uncached SF0.01 catalogs (DML must not reach the shared ones)."""
    ref = RefConnection(rload.load_catalog(0.01, cache=False))
    port = Connection(load_catalog(0.01, device="cpu", cache=False),
                      device="cpu")
    return ref, port


def test_pk_join_after_update_and_delete(tpch_conns):
    """Q3 and Q12 after an UPDATE of o_shippriority / o_orderdate (the
    columns Q3's PK join fetches through value luts) and after a DELETE of
    orders (build rows): against the reference."""
    conns = tpch_conns
    assert "o_shippriority" in P.HashJoin(
        None, None, ["l_orderkey"], ["o_orderkey"])._pick_vlut_cols(
            conns[1].catalog.table("orders"))
    base3, base12 = both(conns, Q3), both(conns, Q12)
    both(conns, "UPDATE orders SET o_shippriority = 7, o_orderdate = "
         "o_orderdate + 30 WHERE o_orderkey < 20000")
    upd3 = both(conns, Q3)
    assert upd3 != base3 and any(r[3] == "7" for r in upd3)
    both(conns, "DELETE FROM orders WHERE o_orderdate < DATE '1994-06-01'")
    del3, del12 = both(conns, Q3), both(conns, Q12)
    assert del12 != base12


def test_fused_kernel_path_declines_with_deletions(tpch_conns, monkeypatch):
    ref, port = conns = tpch_conns
    calls = []
    real = fs.fused_scan_sum
    monkeypatch.setattr(fs, "fused_scan_sum",
                        lambda *a: calls.append(a) or real(*a))
    for c in conns:
        for name in ("index_scan_max_count", "index_scan_percentage"):
            monkeypatch.setattr(c.config, name, 0)
    base = both(conns, Q6)
    assert len(calls) == 1
    both(conns, "BEGIN")
    both(conns, "UPDATE lineitem SET l_discount = l_discount + 0.01 "
         "WHERE l_orderkey < 6000 AND l_discount < 0.10")
    upd = both(conns, Q6)
    assert len(calls) == 2 and upd != base
    both(conns, "DELETE FROM lineitem WHERE l_quantity > 45")
    both(conns, Q6)
    both(conns, Q1)
    assert len(calls) == 2
    assert port.catalog.table("lineitem").deleted is not None
    both(conns, "ROLLBACK")
    assert both(conns, Q6) == base and len(calls) == 3
    assert port.catalog.table("lineitem").deleted is None


def test_from_reference_catalog_carries_deletions():
    rcat = rload.load_catalog(0.01, cache=False)
    rdml.delete_rows(rcat.table("orders"), np.arange(0, 15000, 3))
    rdml.delete_rows(rcat.table("lineitem"), np.arange(5, 60000, 7))
    pcat = from_reference_catalog(rcat, device="cpu")
    for name in ("orders", "lineitem"):
        np.testing.assert_array_equal(
            np.asarray(rcat.table(name).deleted),
            pcat.table(name).deleted.numpy())
    assert pcat.table("customer").deleted is None
    ref, port = RefConnection(rcat), Connection(pcat, device="cpu")
    for q in (Q1, Q3, Q12, "SELECT count(*) AS c FROM orders"):
        both((ref, port), q)
