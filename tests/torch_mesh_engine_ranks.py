"""Rank-side cases of `tests/test_torch_mesh_engine.py`: the engine on an
8-rank gloo mesh, run on every rank of one world through
`duckdb_cubit_tpu_torch.parallel.spawn.run`.

Imports no jax: each rank is a fresh interpreter.  Every rank connects to
SF0.01 sharded over the mesh and runs each case; the test process compares
the ranks' results with each other and with the reference's rows.  A query's
result is (rows as `to_strings` renders them, which columns are DOUBLE).
"""

import numpy as np
import torch

from duckdb_cubit_tpu_torch.api import connect
from duckdb_cubit_tpu_torch.exec import result as R
from duckdb_cubit_tpu_torch.exec.executor import Executor
from duckdb_cubit_tpu_torch.parallel import mesh as M
from duckdb_cubit_tpu_torch.plan import physical as P
from duckdb_cubit_tpu_torch.tpch import queries
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL
from duckdb_cubit_tpu_torch.types import TypeId

SF = 0.01
PLANS = (1, 3, 6, 13, 17, 21)
RETURNFLAGS = ("SELECT l_returnflag, count(*) AS c FROM lineitem "
               "GROUP BY l_returnflag ORDER BY l_returnflag")
# a selective lineitem scan: its live rows differ between the blocks
SELECTIVE = ("SELECT l_orderkey, l_linenumber, l_quantity FROM lineitem "
             "WHERE l_quantity < 3 AND l_discount > 0.08")
BIG_SELECTIVE = "SELECT k, v FROM big WHERE v < 3"


def rendered(rel):
    return (R.to_strings(rel),
            [c.dtype.id == TypeId.DOUBLE for c in rel.columns.values()])


def sql(conn, text):
    return rendered(conn.sql(text).relation)


def case_sharding(conn, mesh):
    li = conn.catalog.table("lineitem")
    idx = li.indexes["l_shipdate"]
    return {"placement": conn.catalog.placement,
            "sharded": {n: t.sharded for n, t in conn.catalog.tables.items()},
            "capacity": li.capacity, "global": li.global_capacity,
            "row_offset": li.row_offset,
            "price_rows": li.columns["l_extendedprice"].data.shape[0],
            "word_shape": tuple(idx.words.shape),
            "cum_shape": tuple(idx.cum_words.shape),
            "pk_slots": conn.catalog.table("orders")
            .pk_indexes["o_orderkey"].lut.shape[0],
            "live": int(li.row_mask().sum()),
            "nation_live": int(conn.catalog.table("nation").row_mask().sum())}


def big_table():
    """200,000 rows (blocks of 25,600 on 8 ranks): `v < 3` keeps about 0.3%
    of most blocks, and every row of 10,000 in rank 7's."""
    k = np.arange(200_000, dtype=np.int64)
    v = (k * 7919) % 1000
    v[180_000:190_000] = 0
    return {"k": k, "v": v}


def case_compaction(conn, mesh):
    """The stage-boundary compaction of a block: every rank picks the bucket
    of the largest block's count, whatever its own."""
    conn.register_numpy("big", big_table())
    plan = conn.binder.bind_sql(BIG_SELECTIVE)
    rel = conn.executor.execute(plan)      # a gathered root
    scan = next(op for op in conn.executor.plan.walk()
                if isinstance(op, P.TableScan))
    block = scan.execute(P.ExecContext(conn.catalog, conn.config))
    out = conn.executor._compact_relation(block)
    seen = []
    orig = Executor._compact_relation

    def recording(self, r):
        c = orig(self, r)
        seen.append((r.sharded, int(r.mask.sum()), r.capacity, c.capacity))
        return c

    Executor._compact_relation = recording
    try:
        q9 = sql(conn, SQL[9])
    finally:
        Executor._compact_relation = orig
    return {"local": int(block.mask.sum()), "block_cap": block.capacity,
            "compacted_cap": out.capacity, "sharded": out.sharded,
            "kept": int(out.mask.sum()),
            "q9": q9, "q9_boundaries": seen, "rows": rendered(rel)}


def case_sharded_root(conn, mesh):
    """A plan whose root is a row block: `execute` gathers it, and a block
    handed to `to_strings` is refused."""
    plan = conn.binder.bind_sql(SELECTIVE)
    rel = conn.executor.execute(plan)
    block = conn.executor.plan.execute(
        P.ExecContext(conn.catalog, conn.config))
    try:
        R.to_strings(block)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"root_sharded": rel.sharded, "block_sharded": block.sharded,
            "rows": rendered(rel), "refused": refused}


def case_verification(conn, mesh):
    out = {}
    conn.sql("PRAGMA enable_verification")
    try:
        for name, text in (("nation", "SELECT n_regionkey, count(*) AS c "
                            "FROM nation GROUP BY n_regionkey "
                            "ORDER BY n_regionkey"),
                           ("returnflags", RETURNFLAGS),
                           ("q3", SQL[3])):
            rows = sql(conn, text)
            out[name] = (rows, [leg for leg, _ in conn.executor.last_legs])
    finally:
        conn.sql("PRAGMA disable_verification")
    return out


def case_refusals(conn, mesh):
    """A concat past its dictionary budget raises on a mesh."""
    out = {}
    try:
        # 1,500 x 1,500 distinct strings: past concat's dictionary budget,
        # where it would build its dictionary from the rows a block holds
        conn.sql("SELECT c_name || c_address AS s FROM customer")
        out["concat_past_budget"] = None
    except NotImplementedError as e:
        out["concat_past_budget"] = str(e)
    return out


def case_subgroup(mesh):
    """A 3-rank mesh: no TPC-H capacity divides into 3 * 32 rows, so every
    table is replicated whole."""
    conn = connect(SF, device="cpu", mesh=mesh)
    return {"sharded": [t.sharded for t in conn.catalog.tables.values()],
            "capacity": conn.catalog.table("lineitem").capacity,
            "q1": rendered(queries.run(conn.executor, 1)),
            "q6": sql(conn, SQL[6]), "q3": sql(conn, SQL[3])}


def run_all(mesh):
    conn = connect(SF, device="cpu", mesh=mesh)
    out = {"sharding": case_sharding(conn, mesh)}
    for n in PLANS:
        out[("plan", n)] = rendered(queries.run(conn.executor, n))
    out["returnflags"] = sql(conn, RETURNFLAGS)
    out["q21_sql"] = sql(conn, SQL[21])
    out["retries"] = conn.executor.retry_count
    out["compaction"] = case_compaction(conn, mesh)
    out["sharded_root"] = case_sharded_root(conn, mesh)
    out["verification"] = case_verification(conn, mesh)
    out["refusals"] = case_refusals(conn, mesh)
    sub = M.make_mesh(3, backend="gloo", device="cpu")
    out["subgroup"] = None if sub is None else case_subgroup(sub)
    torch.distributed.barrier(group=mesh.group)
    return out
