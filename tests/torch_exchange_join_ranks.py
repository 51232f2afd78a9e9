"""Rank-side cases of `tests/test_torch_exchange_join.py`: the radix-exchange
join inside engine plans on an 8-rank gloo mesh, run on every rank of one
world through `duckdb_cubit_tpu_torch.parallel.spawn.run`.

Imports no jax: each rank is a fresh interpreter.  The tables are built
with numpy from the reference test's seeds (`tests/test_exchange_join.py`);
the test process builds the same tables and runs the reference on them.
"""

import numpy as np

from duckdb_cubit_tpu_torch.api import Connection, connect
from duckdb_cubit_tpu_torch.config import EngineConfig
from duckdb_cubit_tpu_torch.exec.result import to_strings
from duckdb_cubit_tpu_torch.plan import optimizer as opt
from duckdb_cubit_tpu_torch.plan import physical as P
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL as TPCH_SQL

SQL = ("SELECT sum(pv * bv) AS s, count(*) AS c FROM probe, build "
       "WHERE probe.k = build.k")
LEFT = ("SELECT count(*) AS c, sum(bv) AS s FROM probe "
        "LEFT JOIN build ON probe.k = build.k")
FOUND = ("SELECT count(*) AS c FROM probe WHERE "
         "(SELECT count(*) FROM build WHERE build.k = probe.k) > 3")


def tables(n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "probe": {"k": rng.integers(0, 2000, n),
                  "pv": rng.integers(0, 100, n)},
        "build": {"k": rng.integers(0, 2000, n // 2),
                  "bv": rng.integers(0, 100, n // 2)},
    }


def skewed():
    rng = np.random.default_rng(1)
    n = 20_000
    keys = rng.integers(0, 2000, n)
    keys[: n // 2] = 7            # heavy skew: half the rows on one key
    return {
        "probe": {"k": keys, "pv": rng.integers(0, 100, n)},
        "build": {"k": np.arange(2000, dtype=np.int64),
                  "bv": rng.integers(0, 100, 2000)},
    }


def mesh_conn(mesh, tabs, exchange=True):
    cfg = EngineConfig()
    cfg.explicit_exchange = exchange
    cfg.exchange_min_build_rows = 1
    conn = Connection(config=cfg, device="cpu", mesh=mesh)
    for name, cols in tabs.items():
        conn.register_numpy(name, cols)
    return conn


def join_ops(conn, sql):
    """Rows, and each HashJoin's exchange facts, of the optimized plan."""
    plan = opt.optimize(conn.binder.bind_sql(sql), conn.catalog)
    rows = to_strings(conn.executor.execute(plan, optimize=False))
    joins = [{"used": getattr(j, "_exchange_used", False),
              "exq_build": getattr(j, "_exq_build", None),
              "exq_probe": getattr(j, "_exq_probe", None),
              "signature": j._self_signature(),
              "bytes": getattr(j, "_exchange_bytes", None)}
             for j in plan.walk() if isinstance(j, P.HashJoin)]
    return rows, joins


def run_all(mesh):
    out = {}
    conn = mesh_conn(mesh, tables())
    out["matches"] = join_ops(conn, SQL) + (
        conn.catalog.table("build").global_capacity,)
    out["left"] = join_ops(mesh_conn(mesh, tables()), LEFT)
    conn = mesh_conn(mesh, skewed())
    before = conn.executor.retry_count
    out["skew"] = join_ops(conn, SQL) + (conn.executor.retry_count - before,)
    out["off"] = join_ops(mesh_conn(mesh, tables(n=4000), exchange=False),
                          SQL)
    out["found"] = join_ops(mesh_conn(mesh, tables()), FOUND)
    tpch = connect(0.01, device="cpu", mesh=mesh)
    tpch.config.explicit_exchange = True
    tpch.config.exchange_min_build_rows = 1
    for q in (3, 7, 20):
        out[("tpch", q)] = join_ops(tpch, TPCH_SQL[q])
    return out
