"""The Star Schema Benchmark's 13 queries through the torch port, on the
CPU at SF 0.01 (`lineorder` about 60,000 rows): the benchmark's own suite
(`tpchbench/suites/ssb.py`) generates the tables, the port opens them with
`connect(None)`, `register_numpy` and the suite's CREATE UNIQUE / CUBIT
INDEX statements, and each query's rows (`Result.strings()`, as
`exec/result.to_strings` renders them) must equal the suite's NumPy
reference and the JAX package's.  The JAX package has no table from the
smallest key: it refuses the date table's key-to-row table, so its date
joins sort, and the rows still agree."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu_torch.api import connect
from duckdb_cubit_tpu_torch.exec import profiler as PROF
from tpchbench import check
from tpchbench.suites import ssb

SF = 0.01
SEED = 2**31 + 1919


@pytest.fixture(scope="module")
def tables():
    t = ssb.Tables(SF)
    t.fill(SEED)
    return t


@pytest.fixture(scope="module")
def port(tables):
    return ssb.connect({}, tables, SF, "cpu")


@pytest.fixture(scope="module")
def jax_conn(tables):
    conn = RefConnection()
    for name in ("ddate", "customer", "supplier", "part", "lineorder"):
        conn.register_numpy(name, {c: np.array(a)
                                   for c, a in tables[name].items()})
    for stmt in ssb.INDEXES:
        if "ddate(d_datekey)" in stmt:
            with pytest.raises(Exception, match="unsuitable"):
                conn.sql(stmt)
        else:
            conn.sql(stmt)
    return conn


@pytest.fixture(scope="module")
def db(tables):
    return ssb.reference({}, tables, SF)


def test_the_tables_have_the_specs_shapes(tables):
    n = {name: len(next(iter(cols.values()))) for name, cols in
         tables.items()}
    assert n["customer"] == 300 and n["supplier"] == 20
    assert n["part"] == 2000 and n["ddate"] == 2556
    assert 55_000 < n["lineorder"] < 65_000
    assert [len(tables[t]) for t in ("lineorder", "part", "supplier",
                                     "customer", "ddate")] == [17, 9, 7, 8,
                                                               17]
    lo = tables["lineorder"]
    assert lo["lo_quantity"].min() == 1 and lo["lo_quantity"].max() == 50
    assert lo["lo_discount"].min() == 0 and lo["lo_discount"].max() == 10
    assert lo["lo_tax"].min() == 0 and lo["lo_tax"].max() == 8
    np.testing.assert_array_equal(
        lo["lo_revenue"], lo["lo_extendedprice"].astype(np.int64)
        * (100 - lo["lo_discount"]) // 100)
    assert lo["lo_orderdate"].min() >= 19920101
    assert lo["lo_orderdate"].max() <= 19980802
    assert all(a.dtype == np.int32 for a in lo.values()
               if a.dtype.kind != "S")


@pytest.mark.parametrize("n", sorted(ssb.TEXTS))
def test_a_query_matches_the_reference_and_the_jax_package(port, jax_conn,
                                                           db, n):
    got = port.sql(ssb.TEXTS[n]).strings()
    assert check.compare(got, ssb.answer(n, db)) == (0, 0.0)
    assert got == jax_conn.sql(ssb.TEXTS[n]).strings()


def test_most_answers_hold_rows(port):
    held = [n for n in ssb.TEXTS if port.sql(ssb.TEXTS[n]).strings()]
    assert len(held) >= 9, held


@pytest.mark.parametrize("n", sorted(ssb.TEXTS))
def test_every_date_join_takes_the_key_to_row_table(port, n):
    joins = [ln.strip() for ln in port.explain(ssb.TEXTS[n]).splitlines()
             if ln.strip().startswith("hash_join")]
    assert any("['lo_orderdate']=['d_datekey']" in j for j in joins)
    assert joins and all(j.endswith("single=True)") for j in joins), joins
    pk = port.catalog.table("ddate").pk_indexes["d_datekey"]
    assert (pk.base, pk.max_key) == (19920101, 19981230)


def test_a_traced_query_probes_tables_and_sorts_nothing(port):
    PROF.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for n in (11, 21, 41):
                port.sql(ssb.TEXTS[n]).strings()
        roots = [s[5] for s in PROF.spans() if s[0] == "db.sql"]
        probes = [s for s in PROF.spans() if s[0] == "db.join.pk_probe"]
        sorts = [s for s in PROF.spans() if s[0] == "db.join.sort_probe"]
    finally:
        PROF.reset()
    assert len(roots) == 3 and not sorts
    assert all(r["pk_probe_rows"] > 0 and r["sort_probe_rows"] == 0
               for r in roots)
    # Q1.1 one probe, Q2.1 three, Q4.1 four
    assert len(probes) == 8
    assert {p[5]["route"] for p in probes} == {"gather"}
    assert {p[5]["slots"] for p in probes} >= {61_130, 300}


def test_a_sort_merge_join_is_counted(port):
    PROF.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            port.sql("SELECT count(*) FROM lineorder, part "
                     "WHERE lo_partkey = p_size").strings()
        root = [s[5] for s in PROF.spans() if s[0] == "db.sql"][0]
        sorts = [s for s in PROF.spans() if s[0] == "db.join.sort_probe"]
    finally:
        PROF.reset()
    assert sorts and root["sort_probe_rows"] == sum(s[5]["rows"]
                                                    for s in sorts) > 0
