"""Durability: the torch port's checkpoint + write-ahead log against the JAX
package's, on the CPU.

The twin of `tests/test_persistence.py` and of
`tests/test_statements.py::test_null_survives_checkpoint`: each scenario
runs on both packages and the reopened databases must give the same rows
(as `to_strings` renders them) and the stated ones.  Added here: a
directory written by the reference opens in the port and the other way
round (the two share the on-disk format); an SF0.01 catalog with deleted
rows through a checkpoint; and three faults of the reference, marked:
CREATE TABLE AS is not written to its log, so the table is lost on
restart; `attach(":memory:")` creates a directory named `:memory:`; and it
writes the TPC-H catalog's narrowed int8 / int16 columns as they are and
then cannot read them back (the port widens them to int32, on writing and
on reading).
"""

import os

import numpy as np
import pytest

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.storage import persist as rpersist
from duckdb_cubit_tpu.tpch import load as rload
from duckdb_cubit_tpu_torch.api import Connection
from duckdb_cubit_tpu_torch.storage import persist
from duckdb_cubit_tpu_torch.tpch.load import load_catalog

from test_torch_slice2 import Q1, Q3, Q6


def port_open(path):
    return persist.open_database(path, device="cpu")


PACKAGES = {"ref": (RefConnection, rpersist.open_database),
            "port": (lambda: Connection(device="cpu"), port_open)}


def populate(conn):
    conn.sql("CREATE TABLE t (k INTEGER, v INTEGER, s VARCHAR)")
    conn.sql("INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b'), "
             "(3, 30, 'a')")


def on_both(tmp_path, script, query):
    """Run `script(conn, path)` on a fresh attached connection of each
    package, reopen each directory with its own package, run `query`; the
    rows must agree.  -> the port's rows."""
    out = {}
    for name, (make, reopen) in PACKAGES.items():
        db = str(tmp_path / name)
        script(make().attach(db), db)
        out[name] = reopen(db).sql(query).strings()
    assert out["port"] == out["ref"]
    return out["port"]


def test_checkpoint_roundtrip(tmp_path):
    def script(c, db):
        populate(c)
        c.checkpoint()
    assert on_both(tmp_path, script, "SELECT k, v, s FROM t ORDER BY k") == \
        [["1", "10", "a"], ["2", "20", "b"], ["3", "30", "a"]]


def test_wal_replay_without_checkpoint(tmp_path):
    assert on_both(tmp_path, lambda c, db: populate(c),
                   "SELECT count(*) AS c, sum(v) AS s FROM t") == \
        [["3", "60"]]


def test_checkpoint_plus_wal_tail(tmp_path):
    def script(c, db):
        populate(c)
        c.checkpoint()
        c.sql("INSERT INTO t VALUES (4, 40, 'c')")
        c.sql("UPDATE t SET v = 99 WHERE k = 1")
    assert on_both(tmp_path, script, "SELECT k, v FROM t ORDER BY k") == \
        [["1", "99"], ["2", "20"], ["3", "30"], ["4", "40"]]


def test_checkpoint_compacts_deletes(tmp_path):
    def script(c, db):
        populate(c)
        c.sql("DELETE FROM t WHERE k = 2")
        c.checkpoint()
    assert on_both(tmp_path, script, "SELECT count(*) AS c FROM t") == \
        [["2"]]
    t = port_open(str(tmp_path / "port")).catalog.table("t")
    assert t.num_rows == 2 and t.deleted is None


def test_index_survives_checkpoint(tmp_path):
    def script(c, db):
        populate(c)
        c.sql("CREATE INDEX it ON t (v)")
        c.checkpoint()
    assert on_both(tmp_path, script,
                   "SELECT count(*) AS c FROM t WHERE v = 20") == [["1"]]
    assert "v" in port_open(str(tmp_path / "port")).catalog.table(
        "t").indexes


def test_wal_truncated_by_checkpoint(tmp_path):
    db = str(tmp_path / "db")
    conn = Connection(device="cpu").attach(db)
    populate(conn)
    assert os.path.exists(os.path.join(db, "wal.sql"))
    conn.checkpoint()
    assert not os.path.exists(os.path.join(db, "wal.sql"))


def test_rollback_not_resurrected_by_wal_replay(tmp_path):
    def script(c, db):
        populate(c)
        c.sql("BEGIN")
        c.sql("INSERT INTO t VALUES (9, 90, 'z')")
        c.sql("UPDATE t SET v = 1 WHERE k = 1")
        c.sql("ROLLBACK")
    assert on_both(tmp_path, script, "SELECT k, v FROM t ORDER BY k") == \
        [["1", "10"], ["2", "20"], ["3", "30"]]


def test_commit_flushes_buffered_wal(tmp_path):
    def script(c, db):
        populate(c)
        c.sql("BEGIN")
        c.sql("INSERT INTO t VALUES (4, 40, 'c')")
        assert len(open(os.path.join(db, "wal.sql")).readlines()) == 2
        c.sql("COMMIT")
    assert on_both(tmp_path, script, "SELECT count(*) AS c FROM t") == \
        [["4"]]


def test_null_survives_checkpoint(tmp_path):
    def script(c, db):
        c.sql("CREATE TABLE t (k INTEGER, v INTEGER)")
        c.sql("INSERT INTO t VALUES (1, NULL), (2, 20)")
        c.checkpoint()
    assert on_both(tmp_path, script,
                   "SELECT count(v) AS c, sum(v) AS s FROM t") == \
        [["1", "20"]]


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_each_package_opens_the_others_directory(tmp_path, writer, reader):
    def script(c):
        populate(c)
        c.sql("CREATE TABLE d (x DECIMAL(12,2), dt DATE, f DOUBLE)")
        c.sql("INSERT INTO d VALUES (1.25, DATE '1995-03-15', 0.5), "
              "(NULL, DATE '2001-01-01', NULL), (-2.50, NULL, 10000000000.0)")
        c.sql("CREATE INDEX ON t (v)")
        c.sql("DELETE FROM t WHERE k = 3")
        c.checkpoint()
        c.sql("INSERT INTO t VALUES (5, 50, 'e')")     # the log's tail
    db = str(tmp_path / "db")
    script(PACKAGES[writer][0]().attach(db))
    ref, port = (rpersist.open_database(db), port_open(db))
    assert os.path.exists(os.path.join(db, "wal.sql"))
    for q in ("SELECT k, v, s FROM t ORDER BY k",
              "SELECT x, dt, f FROM d ORDER BY x",
              "SELECT count(*) AS c FROM t WHERE v = 50"):
        assert port.sql(q).strings() == ref.sql(q).strings()
    assert port.sql("SELECT k FROM t ORDER BY k").strings() == \
        [["1"], ["2"], ["5"]]


def test_tpch_with_deletions_through_a_checkpoint(tmp_path):
    """An SF0.01 catalog with deleted rows, checkpointed by each package
    and reopened by the other: Q1, Q3 and Q6 agree."""
    rconn = RefConnection(rload.load_catalog(0.01, cache=False))
    pconn = Connection(load_catalog(0.01, device="cpu", cache=False),
                       device="cpu")
    for c, name in ((rconn, "ref"), (pconn, "port")):
        c.attach(str(tmp_path / name))
        c.sql("DELETE FROM orders WHERE o_orderdate < DATE '1993-01-01'")
        c.sql("DELETE FROM lineitem WHERE l_quantity > 45")
        c.checkpoint()
    from_ref = port_open(str(tmp_path / "ref"))
    from_port = rpersist.open_database(str(tmp_path / "port"))
    with pytest.raises(TypeError, match="int8"):    # the reference's fault
        rpersist.open_database(str(tmp_path / "ref"))
    for q in (Q1, Q3, Q6):
        want = pconn.sql(q).strings()
        assert from_ref.sql(q).strings() == want
        assert from_port.sql(q).strings() == rconn.sql(q).strings()


def test_create_table_as_survives_a_restart(tmp_path):
    """The reference's fault (marked): its log leaves out CREATE TABLE AS,
    so the table is gone after a restart; the port logs it."""
    tables = {}
    for name, (make, reopen) in PACKAGES.items():
        db = str(tmp_path / name)
        c = make().attach(db)
        populate(c)
        c.sql("CREATE TABLE big AS SELECT k, v * 2 AS w FROM t WHERE k > 1")
        tables[name] = reopen(db).catalog.tables
    assert "big" not in tables["ref"]           # the reference's fault
    port = port_open(str(tmp_path / "port"))
    assert port.sql("SELECT k, w FROM big ORDER BY k").strings() == \
        [["2", "40"], ["3", "60"]]


def test_attach_memory_makes_no_directory(tmp_path, monkeypatch):
    """The reference's fault (marked): `attach(":memory:")` creates a
    directory of that name; in the port it keeps the connection in
    memory and logs nothing."""
    monkeypatch.chdir(tmp_path)
    RefConnection().attach(":memory:")
    assert os.path.isdir(":memory:")            # the reference's fault
    os.rmdir(":memory:")
    conn = Connection(device="cpu").attach(":memory:")
    populate(conn)
    assert conn.db_path is None and os.listdir(tmp_path) == []
    with pytest.raises(ValueError, match="attach"):
        conn.checkpoint()


def test_open_database_defaults_to_the_card():
    import inspect

    assert inspect.signature(persist.open_database).parameters[
        "device"].default == "cuda"
