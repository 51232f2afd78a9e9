"""Rank-side cases of `tests/test_torch_mesh_dml.py`: DML, transactions,
checkpoints and the query deadline on an 8-rank gloo mesh, run on every
rank of one world through `duckdb_cubit_tpu_torch.parallel.spawn.run`.

Imports no jax: each rank is a fresh interpreter.  `run_steps` is also what
the test process runs on the reference's mesh connection and on the port's
single-device connection (it takes the package's `dml` module), so all
three run the same statements in the same order.  A query's result is its
rows as `strings()` renders them.
"""

import hashlib
import os

import numpy as np
import torch

from duckdb_cubit_tpu_torch.api import Connection, QueryTimeoutError, connect
from duckdb_cubit_tpu_torch.exec import result as R
from duckdb_cubit_tpu_torch.index.cubit import CubitIndex
from duckdb_cubit_tpu_torch.ops import fused_scan, probe
from duckdb_cubit_tpu_torch.parallel.shard import all_gather_rows
from duckdb_cubit_tpu_torch.plan.physical import TableScan
from duckdb_cubit_tpu_torch.sql.parser import parse_statement
from duckdb_cubit_tpu_torch.storage import dml, persist
from duckdb_cubit_tpu_torch.testing.sqllogic import run_file
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL
from duckdb_cubit_tpu_torch.types import TypeId

SF = 0.01
HERE = os.path.dirname(os.path.abspath(__file__))
SQLLOGIC_FILES = ("ddl_dml.test", "dml_index_cycle.test", "limit_dml.test",
                  "transactions.test")
TPCH_AFTER = (1, 3, 6, 12)

LI_TOTALS = ("SELECT count(*) AS c, sum(l_quantity) AS q, "
             "sum(l_extendedprice) AS p, sum(l_discount) AS d, "
             "sum(l_tax) AS t FROM lineitem")
NATION = ("SELECT count(*) AS c, sum(n_nationkey) AS k, "
          "sum(n_regionkey) AS r FROM nation")
G_PROBES = ("SELECT count(*) AS c, sum(k) AS s FROM g WHERE v = 3",
            "SELECT s, count(*) AS c, sum(v) AS v FROM g GROUP BY s "
            "ORDER BY s")
# 8,000 rows appended directly (capacity 8,192 on one device: blocks of
# 1,024 on 8 ranks, every one of them written), then 300 through SQL, which
# grow the capacity to 16,384 (blocks of 2,048: rows change ranks)
G_DIRECT_ROWS = 8_000
G_GROWTH_ROWS = 300
GROWTH_INSERT = "INSERT INTO g VALUES " + ", ".join(
    f"({G_DIRECT_ROWS + i}, {i % 7}, 'n{i % 10}')"
    for i in range(G_GROWTH_ROWS))


def g_rows() -> dict:
    k = np.arange(G_DIRECT_ROWS, dtype=np.int32)
    return {"k": k, "v": (k % 7).astype(np.int32),
            "s": np.array([b"s%d" % (i % 13) for i in range(G_DIRECT_ROWS)],
                          dtype="S")}


# (name, actions, probes): an action is a statement (its status is kept),
# ("query", sql) (its rows are kept) or ("append", table, rows) (a direct
# `dml.append_rows`, its first row id kept); the probes run after the
# actions
STEPS = (
    ("delete_where", ["DELETE FROM lineitem WHERE l_quantity < 5"],
     [LI_TOTALS]),
    ("update_literal",
     ["UPDATE lineitem SET l_discount = 0.01 WHERE l_quantity = 10"],
     [LI_TOTALS, "SELECT count(*) AS c FROM lineitem "
                 "WHERE l_discount = 0.01"]),
    ("update_expression",
     ["UPDATE lineitem SET l_tax = l_tax + 0.01 WHERE l_quantity = 11"],
     [LI_TOTALS]),
    ("update_indexed",
     ["UPDATE lineitem SET l_shipdate = DATE '1995-06-17' "
      "WHERE l_quantity = 12"],
     ["SELECT count(*) AS c, sum(l_quantity) AS q FROM lineitem WHERE "
      "l_shipdate >= DATE '1995-06-01' AND l_shipdate < DATE '1995-07-01'"]),
    ("delete_all",
     ["CREATE TABLE oc AS SELECT o_orderkey, o_totalprice FROM orders",
      "DELETE FROM oc WHERE o_orderkey < 20000", "DELETE FROM oc"],
     ["SELECT count(*) AS c FROM oc"]),
    ("insert_after_delete_all",
     ["INSERT INTO oc VALUES (1, 3.50), (4, 6.25)"],
     ["SELECT count(*) AS c, sum(o_totalprice) AS p FROM oc"]),
    ("insert_new_string",
     ["INSERT INTO nation VALUES (25, 'ATLANTIS', 1, 'x')"],
     [NATION, "SELECT n_nationkey, n_name FROM nation ORDER BY n_name",
      "SELECT count(*) AS c FROM nation WHERE n_name < 'C'",
      "SELECT n_name, r_name FROM nation, region WHERE n_regionkey = "
      "r_regionkey AND n_nationkey >= 20 ORDER BY n_name"]),
    ("insert_direct",
     ["CREATE TABLE g (k INTEGER, v INTEGER, s VARCHAR)",
      ("append", "g", g_rows), "CREATE INDEX g_v ON g (v)"],
     list(G_PROBES)),
    ("insert_growth", [GROWTH_INSERT], list(G_PROBES)),
    ("delete_after_growth", ["DELETE FROM g WHERE v = 5"], list(G_PROBES)),
    ("rollback",
     ["BEGIN", "DELETE FROM nation WHERE n_nationkey = 1",
      "UPDATE nation SET n_regionkey = 4 WHERE n_nationkey = 2",
      "INSERT INTO g VALUES (9000, 3, 'txn')", ("query", NATION),
      ("query", G_PROBES[0]), "ROLLBACK"],
     [NATION, G_PROBES[0]]),
    ("commit",
     ["BEGIN", "DELETE FROM nation WHERE n_nationkey = 3", "COMMIT"],
     [NATION]),
)
STEP_NAMES = [s[0] for s in STEPS]
# after the checkpoint: a committed statement and a committed transaction,
# both in the write-ahead log
WAL_STATEMENTS = ("DELETE FROM g WHERE k < 100", "BEGIN",
                  "INSERT INTO nation VALUES (26, 'LEMURIA', 2, 'y')",
                  "COMMIT")
PERSIST_PROBES = (NATION,) + G_PROBES + (LI_TOTALS,)


def run_action(conn, dml_module, action):
    if isinstance(action, str):
        return conn.sql(action).status
    if action[0] == "query":
        return conn.sql(action[1]).strings()
    _, table, rows = action
    return dml_module.append_rows(conn.catalog.table(table), rows())


def run_steps(conn, dml_module, after_step=None) -> dict:
    """Every step of STEPS on `conn`: {name: (action results, probe
    rows)}; `after_step(name)` runs after each step's probes."""
    out = {}
    for name, actions, probes in STEPS:
        results = [run_action(conn, dml_module, a) for a in actions]
        out[name] = (results, [conn.sql(q).strings() for q in probes])
        if after_step is not None:
            after_step(name)
    return out


def digest(words_u32: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(words_u32).tobytes()) \
        .hexdigest()


def host_words(ix) -> np.ndarray:
    return ix.words.cpu().numpy().view(np.uint32)


def gathered_words(t, name) -> tuple:
    """A block table's index words and cumulative words whole (its word
    columns gathered in rank order), as uint32."""
    ix = t.indexes[name]
    if not t.sharded:
        return host_words(ix), ix.cum_words.cpu().numpy().view(np.uint32)
    words = all_gather_rows(ix.words.t().contiguous(), t.mesh).t()
    cum = all_gather_rows(ix.cum_words.t().contiguous(), t.mesh).t()
    return (words.contiguous().numpy().view(np.uint32),
            cum.contiguous().numpy().view(np.uint32))


def index_check(t, name) -> dict:
    """The index of `name` against one built afresh over the gathered
    column, with the deleted rows' bits cleared and their counts taken
    out: words, cumulative words and bin counts must be bit-equal."""
    ix = t.indexes[name]
    col = t.columns[name]
    data = col.data if not t.sharded else all_gather_rows(col.data, t.mesh)
    values = data.numpy()[:t.num_rows].astype(np.int64)
    cap = t.global_capacity
    fresh = CubitIndex.build(name, values, cap, t.num_rows, ix.n_bins,
                             bin_edges=ix.bin_edges, device="cpu")
    want = host_words(fresh).copy()
    deleted = dml.global_deleted(t)
    live = np.ones(t.num_rows, bool)
    if deleted is not None:
        live &= ~deleted[:t.num_rows]
        dead = np.packbits(deleted[:cap], bitorder="little").view("<u4")
        want &= ~dead
    bins = fresh.bins_of(values[live])
    want_counts = np.bincount(np.clip(bins, 0, ix.n_bins - 1),
                              minlength=ix.n_bins)
    want_cum = np.cumsum(want.astype(np.uint64), axis=0).astype(np.uint32)
    words, cum = gathered_words(t, name)
    return {"words": bool(np.array_equal(words, want)),
            "cum": bool(np.array_equal(cum, want_cum)),
            "counts": bool(np.array_equal(ix.bin_counts, want_counts)),
            "bin_counts": ix.bin_counts.tolist(), "digest": digest(words),
            "live_bits": int(want_counts.sum())}


def catalog_ids(conn) -> list:
    return sorted((n, t.uid, t.version, t.num_rows)
                  for n, t in conn.catalog.tables.items())


def placement(t) -> dict:
    return {"sharded": t.sharded, "capacity": t.capacity,
            "row_offset": t.row_offset, "global": t.global_capacity,
            "words": tuple(t.indexes["v"].words.shape),
            "index_offset": t.indexes["v"].row_offset,
            "live": int(t.row_mask().sum())}


class Calls:
    """Counts the calls of module functions while it is active."""

    def __init__(self, *targets):
        self.targets = targets
        self.count = {name: 0 for _, name in targets}

    def __enter__(self):
        self.saved = []
        for module, name in self.targets:
            real = getattr(module, name)
            self.saved.append((module, name, real))

            def counting(*a, _real=real, _name=name, **k):
                self.count[_name] += 1
                return _real(*a, **k)

            setattr(module, name, counting)
        return self

    def __exit__(self, *exc):
        for module, name, real in self.saved:
            setattr(module, name, real)
        return False


def case_steps(conn, mesh) -> dict:
    checks = {}

    def after(name):
        if name == "update_indexed":
            li = conn.catalog.table("lineitem")
            for col in ("l_discount", "l_shipdate", "l_quantity"):
                checks[col] = index_check(li, col)
        elif name in ("insert_direct", "insert_growth",
                      "delete_after_growth"):
            g = conn.catalog.table("g")
            checks[f"g_{name}"] = index_check(g, "v")
            checks[f"placement_{name}"] = placement(g)
        elif name == "rollback":
            checks["ids_after_rollback"] = catalog_ids(conn)

    steps = run_steps(conn, dml, after)
    return {"steps": steps, "checks": checks}


def case_match_rows(conn, mesh) -> dict:
    """DML's row matching reads a replicated relation: its mask is the
    whole table's, in global row order."""
    li = conn.catalog.table("lineitem")
    where = parse_statement("DELETE FROM lineitem WHERE l_quantity = 20").where
    expr = conn.binder.bind_table_expr("lineitem", where)
    rel = conn.executor.execute(TableScan("lineitem", filters=[expr]),
                                optimize=False, verify=False)
    ids = np.nonzero(rel.mask.numpy())[0]
    return {"sharded": rel.sharded, "capacity": rel.capacity,
            "global": li.global_capacity, "block": li.capacity,
            "ids": digest(ids.astype(np.int64)), "n": len(ids)}


def case_refusals(conn, mesh) -> dict:
    out = {}
    try:
        conn.sql("INSERT INTO nation SELECT * FROM nation")
        out["insert_select"] = None
    except Exception as e:  # noqa: BLE001 - the message is the result
        out["insert_select"] = str(e)
    try:
        conn.sql("COMMIT")
        out["commit_outside"] = None
    except RuntimeError as e:
        out["commit_outside"] = str(e)
    return out


def case_persistence(conn, mesh, path) -> dict:
    """attach + checkpoint on the mesh (rank 0 alone writes), two committed
    statements in the write-ahead log, then a reopen on one device and onto
    the mesh."""
    writes = Calls((persist, "_write_checkpoint"), (persist, "wal_append"))
    with writes:
        conn.attach(path)
        conn.checkpoint()
        files_after_checkpoint = sorted(os.listdir(path))
        for q in WAL_STATEMENTS:
            conn.sql(q)
    torch.distributed.barrier(group=mesh.group)
    with open(os.path.join(path, "wal.sql")) as f:
        wal = f.read()
    before = [conn.sql(q).strings() for q in PERSIST_PROBES]
    single = persist.open_database(path, device="cpu")
    on_single = [single.sql(q).strings() for q in PERSIST_PROBES]
    reopened = Connection(persist.open_database(path, device="cpu").catalog,
                          device="cpu", mesh=mesh)
    on_mesh = [reopened.sql(q).strings() for q in PERSIST_PROBES]
    conn.db_path = None
    return {"writes": writes.count, "files": files_after_checkpoint,
            "wal": wal, "before": before, "single": on_single,
            "mesh": on_mesh,
            "mesh_sharded": all(t.sharded for t in
                                reopened.catalog.tables.values()),
            "single_db_path": single.db_path}


def collectives_of(conn, sql) -> tuple:
    with Calls((torch.distributed, "all_reduce"),
               (torch.distributed, "all_gather")) as calls:
        rows = conn.sql(sql).strings()
    return rows, sum(calls.count.values())


def case_deadline(conn, mesh) -> dict:
    """A query cut by a 1 ms deadline raises on every rank, and the next
    query answers; with the deadline off, no collective is added."""
    _, base = collectives_of(conn, SQL[6])
    conn.sql("SET query_timeout_s = 100")
    _, with_deadline = collectives_of(conn, SQL[6])
    conn.sql("SET query_timeout_s = 0.001")
    try:
        conn.sql(SQL[13]).strings()
        raised = None
    except QueryTimeoutError as e:
        raised = str(e)
    finally:
        conn.sql("SET query_timeout_s = 0")
    after, off = collectives_of(conn, SQL[6])
    return {"raised": raised, "next": after, "collectives": base,
            "collectives_deadline": with_deadline, "collectives_off": off}


def case_tpch(conn, mesh) -> dict:
    """Q1, Q3, Q6 and Q12 after the DML, counting the calls of K1's and
    K2's wrappers.  K2's size gate is lowered to the 8,192-row blocks of
    lineitem at SF0.01 (it takes 32,768 keys), so its path runs per block."""
    out = {}
    gate = probe.MIN_KEYS
    probe.MIN_KEYS = 4096
    try:
        for n in TPCH_AFTER:
            with Calls((fused_scan, "fused_scan_sum"),
                       (probe, "monotone_gather_many")) as calls:
                rel = conn.sql(SQL[n]).relation
                rows = R.to_strings(rel)
            doubles = [c.dtype.id == TypeId.DOUBLE
                       for c in rel.columns.values()]
            out[n] = (rows, doubles, dict(calls.count))
    finally:
        probe.MIN_KEYS = gate
    return out


def case_sqllogic(mesh) -> dict:
    out = {}
    for name in SQLLOGIC_FILES:
        c = Connection(device="cpu", mesh=mesh)
        report = run_file(os.path.join(HERE, "sqllogic", name), conn=c)
        out[name] = {"executed": report.executed, "skipped": report.skipped,
                     "sharded": {n: t.sharded
                                 for n, t in c.catalog.tables.items()}}
    return out


def run_all(mesh, path):
    conn = connect(SF, device="cpu", mesh=mesh)
    out = {"match_rows": case_match_rows(conn, mesh)}
    out.update(case_steps(conn, mesh))
    out["refusals"] = case_refusals(conn, mesh)
    out["tpch"] = case_tpch(conn, mesh)
    out["persistence"] = case_persistence(conn, mesh, path)
    out["deadline"] = case_deadline(conn, mesh)
    out["sqllogic"] = case_sqllogic(mesh)
    torch.distributed.barrier(group=mesh.group)
    return out
