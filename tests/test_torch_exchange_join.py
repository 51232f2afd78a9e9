"""The radix-exchange join inside engine plans over `torch.distributed`,
against the JAX package: the twin of `tests/test_exchange_join.py`, under
its case names.

One gloo world of 8 CPU ranks is spawned once for the file
(`parallel/spawn.run`) and runs `torch_exchange_join_ranks.run_all`.  This
process runs the reference on the same numpy tables: single device for the
rows, and on its `make_mesh(8)` for the quotas.  Asserted, as in the
reference: rows equal the single device's, the join took the exchange
(`_exchange_used`, `exu=True` in its signature), the build side is not
replicated (8 * the build quota < the build capacity), skewed keys recover
through the quota-doubling retry, and with the exchange off the join falls
back.  Beyond the reference's cases: the quotas equal the reference's on
its 8-device mesh (the same row blocks, the same starting rule).
"""

import pytest

import torch_exchange_join_ranks as R
from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.config import EngineConfig as RefConfig
from duckdb_cubit_tpu.exec.result import to_strings as ref_strings
from duckdb_cubit_tpu.parallel import mesh as RM
from duckdb_cubit_tpu.plan import optimizer as ref_opt
from duckdb_cubit_tpu.plan import physical as RP
from duckdb_cubit_tpu_torch.parallel import spawn
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL as TPCH_SQL

N_RANKS = 8


@pytest.fixture(scope="module")
def ranks():
    return spawn.run(R.run_all, N_RANKS, backend="gloo", device="cpu",
                     deadline_s=300)


def replicated(ranks, key):
    vals = [ranks[r][key] for r in range(N_RANKS)]
    for v in vals[1:]:
        assert v == vals[0]
    return vals[0]


def single_device(tabs, sql):
    conn = RefConnection()
    for name, cols in tabs.items():
        conn.register_numpy(name, cols)
    return conn.sql(sql).strings()


def exchanged(joins):
    return [j for j in joins if j["used"]]


def test_exchange_join_matches_single_device(ranks):
    rows, joins, build_cap = replicated(ranks, "matches")
    assert rows == single_device(R.tables(), R.SQL)
    assert exchanged(joins), "join did not take the explicit exchange"
    j = exchanged(joins)[0]
    # build side NOT replicated: each rank receives n * quota build rows,
    # a fraction of the build capacity (a broadcast join needs all)
    assert N_RANKS * j["exq_build"] < build_cap, (j["exq_build"], build_cap)
    assert "exu=True" in j["signature"]


def test_exchange_left_join(ranks):
    rows, joins = replicated(ranks, "left")
    assert rows == single_device(R.tables(), R.LEFT)
    assert exchanged(joins)


def test_exchange_skew_requota_recovers(ranks):
    rows, joins, retries = replicated(ranks, "skew")
    assert rows == single_device(R.skewed(), R.SQL)
    assert retries > 0, \
        "skewed probe side should overflow the initial quota and requota"


def test_exchange_off_falls_back(ranks):
    rows, joins = replicated(ranks, "off")
    assert not exchanged(joins)
    assert rows == single_device(R.tables(n=4000), R.SQL)


@pytest.mark.parametrize("q", [3, 7])
def test_tpch_on_mesh_with_exchange(ranks, q):
    rows, joins = replicated(ranks, ("tpch", q))
    assert exchanged(joins)
    assert rows == ref_connect(sf=0.01).sql(TPCH_SQL[q]).strings()


def test_exchange_left_join_with_found_column(ranks):
    rows, joins = replicated(ranks, "found")
    assert rows == single_device(R.tables(), R.FOUND)
    assert exchanged(joins), "EXISTS join did not take the exchange"


def _ref_quotas(tabs, sql):
    cfg = RefConfig()
    cfg.explicit_exchange = True
    cfg.exchange_min_build_rows = 1
    conn = RefConnection(config=cfg, mesh=RM.make_mesh(N_RANKS))
    for name, cols in tabs.items():
        conn.register_numpy(name, cols)
    plan = ref_opt.optimize(conn.binder.bind_sql(sql), conn.catalog)
    ref_strings(conn.executor.execute(plan, optimize=False))
    return [(j._exq_build, j._exq_probe) for j in plan.walk()
            if isinstance(j, RP.HashJoin)
            and getattr(j, "_exchange_used", False)]


@pytest.mark.parametrize("case,tabs,sql", [
    ("matches", R.tables, R.SQL), ("skew", R.skewed, R.SQL)])
def test_quotas_equal_the_reference_mesh(ranks, case, tabs, sql):
    joins = replicated(ranks, case)[1]
    got = [(j["exq_build"], j["exq_probe"]) for j in exchanged(joins)]
    assert got == _ref_quotas(tabs(), sql)


def test_single_match_exchange_keeps_the_probe_rows(ranks):
    """A single-match join through the exchange keeps its probe side's row
    positions, so the reverse-PK semi join above it in SQL q20 (supplier x
    nation, then `s_suppkey IN (...)`) scatters into the right rows.  The
    reference's exchange expands instead, while its planner still treats
    the join as aligned to supplier: on its 8-device mesh it returns no
    row (ROADMAP queue 3)."""
    rows, joins = replicated(ranks, ("tpch", 20))
    assert exchanged(joins)
    want = ref_connect(sf=0.01).sql(TPCH_SQL[20]).strings()
    assert rows == want and len(want) == 1
    ref_mesh = ref_connect(sf=0.01, mesh=RM.make_mesh(N_RANKS))
    ref_mesh.config.exchange_min_build_rows = 1
    assert ref_mesh.sql(TPCH_SQL[20]).strings() == []
