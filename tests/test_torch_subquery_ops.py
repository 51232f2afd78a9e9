"""The binder's subquery operators and sources: the torch port's MarkJoin,
BroadcastScalar, SingleRow, RangeSource and Materialized against the JAX
package's, on the CPU; and the statements and settings the port does not
run yet, which must raise by name.

MarkJoin reads the same numpy-seeded relations in both packages through the
source operators of `tests/test_torch_hashjoin.py`; the rows must match as
`to_strings` renders them, in order.  The port runs through its executor
(which reads the deferred checks and retries), the reference runs the
operator once with a capacity that needs no retry.
"""

import numpy as np
import pytest

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu.ops import expressions as RE
from duckdb_cubit_tpu.plan import physical as RP
from duckdb_cubit_tpu_torch.api import Connection
from duckdb_cubit_tpu_torch.exec import result as PR
from duckdb_cubit_tpu_torch.exec.executor import Executor
from duckdb_cubit_tpu_torch.ops import expressions as PE
from duckdb_cubit_tpu_torch.plan import physical as P
from duckdb_cubit_tpu_torch.storage.table import Catalog
from test_torch_hashjoin import (BUILD_DUP, KEYS, PROBE, PortGiven, RefGiven,
                                 port_rel, ref_rel)


def run_pair(make, probe=PROBE, build=BUILD_DUP):
    """`make(mod, E, probe_op, build_op)` builds one plan per package over
    the same relations -> (port rows, reference rows, executor, port plan).
    """
    ref_plan = make(RP, RE, RefGiven(ref_rel(probe)), RefGiven(ref_rel(build)))
    want = RR.to_strings(ref_plan.execute(RP.ExecContext(None)))
    plan = make(P, PE, PortGiven(port_rel(probe)), PortGiven(port_rel(build)))
    ex = Executor(Catalog())
    got = PR.to_strings(ex.execute(plan, optimize=False))
    return got, want, ex, plan


@pytest.mark.parametrize("negated", [False, True])
@pytest.mark.parametrize("nkeys", [1, 2, 3])
def test_mark_join_exists_and_not_exists(nkeys, negated):
    pkeys, bkeys = KEYS[nkeys]
    got, want, ex, _ = run_pair(lambda mod, E, p, b: mod.MarkJoin(
        p, b, pkeys, bkeys, negated=negated, out_capacity=8192))
    assert got == want
    assert 0 < len(got) < PROBE[1].sum() and ex.retry_count == 0


@pytest.mark.parametrize("negated", [False, True])
@pytest.mark.parametrize("nkeys", [1, 3])
def test_mark_join_residual_on_probe_and_build_columns(nkeys, negated):
    """EXISTS (... AND p_v < b_v AND b_k2 <> p_k3): a residual over a probe
    column and build columns under the prefix, NULLs on both sides."""
    pkeys, bkeys = KEYS[nkeys]

    def make(mod, E, p, b):
        res = (E.Col("p_v") < E.Col("__mark_b_v")) & \
            (E.Col("__mark_b_k2") != E.Col("p_k3"))
        return mod.MarkJoin(p, b, pkeys, bkeys, residual=res,
                            negated=negated)

    got, want, _, _ = run_pair(make)
    assert got == want and len(got) > 0


def test_in_subquery_is_a_mark_join_without_residual():
    """IN (SELECT b_k ...): the mark of the one-key join, which equals the
    semi join's rows."""
    got, want, _, _ = run_pair(lambda mod, E, p, b: mod.MarkJoin(
        p, b, ["p_k"], ["b_k"]))
    semi, _, _, _ = run_pair(lambda mod, E, p, b: mod.HashJoin(
        p, b, ["p_k"], ["b_k"], "semi"))
    assert got == want == semi


def test_mark_column_under_or():
    """The mark as a BOOL column, consumed by an OR filter."""
    def make(mod, E, p, b):
        mj = mod.MarkJoin(p, b, ["p_k"], ["b_k"],
                          residual=E.Col("__mark_b_v") > E.Col("p_v"),
                          mark_column="m")
        return mod.Filter(mj, E.Col("m") | (E.Col("p_k2") == 0))

    got, want, _, _ = run_pair(make)
    assert got == want
    assert {row[-1] for row in got} == {"true", "false"}


def test_mark_join_expansion_regrows():
    """A too small `out_capacity` fails the `expansion` check; the retry
    doubles the capacity (at least 2**13), keys a fresh prepared plan and
    gives the reference's rows."""
    def make(mod, E, p, b):
        return mod.MarkJoin(p, b, ["p_k"], ["b_k"],
                            residual=E.Col("__mark_b_v") > E.Col("p_v"),
                            out_capacity=8 if mod is P else 8192)

    got, want, ex, plan = run_pair(make)
    assert got == want
    assert ex.retry_count == 1 and plan._cap_override == Executor.MIN_CAP
    assert "ov=8192" in plan.signature()


def _empty_or_max(mod, E, b, lo):
    """max(b_v) over the build rows with b_k >= lo: one row, absent when no
    row qualifies."""
    return mod.GroupAggregate(mod.Filter(b, E.Col("b_k") >= lo), [],
                              [mod.Aggregate("max", E.Col("b_v"), "mx")])


@pytest.mark.parametrize("lo", [0, 45, 1000])
def test_broadcast_scalar(lo):
    """The subplan's one row broadcast to every probe row, NULL when the
    subquery is empty (lo = 1000)."""
    def make(mod, E, p, b):
        return mod.BroadcastScalar(p, _empty_or_max(mod, E, b, lo),
                                   {"sq": "mx"})

    got, want, _, plan = run_pair(make)
    assert got == want
    assert {row[-1] for row in got} != {"NULL"} or lo == 1000
    assert plan.signature().startswith("broadcast_scalar[[('sq', 'mx')]]")


def test_broadcast_scalar_filter_over_empty_subquery():
    """x > (SELECT max(...) WHERE false) is NULL for every row: no row."""
    def make(mod, E, p, b):
        bs = mod.BroadcastScalar(p, _empty_or_max(mod, E, b, 1000),
                                 {"sq": "mx"})
        return mod.Filter(bs, E.Col("p_v") > E.Col("sq"))

    got, want, _, _ = run_pair(make)
    assert got == want == []


@pytest.fixture(scope="module")
def conns():
    cols = {"x": np.array([5, -3, 8, 0, 12], np.int64),
            "s": np.array(["b", "a", "c", "a", "d"])}
    ref, port = RefConnection(), Connection(device="cpu")
    for c in (ref, port):
        c.register_numpy("t", cols)
    return ref, port


@pytest.mark.parametrize("sql,rows", [
    ("SELECT 1+2 AS a, 'x' AS s", [["3", "x"]]),
    ("SELECT NULL AS n", [["NULL"]]),
    ("SELECT 1 AS a WHERE 1 > 2", []),
    ("SELECT * FROM range(5)", [["0"], ["1"], ["2"], ["3"], ["4"]]),
    ("SELECT * FROM range(2, 10, 3)", [["2"], ["5"], ["8"]]),
    ("SELECT * FROM range(10, 0, -4)", [["10"], ["6"], ["2"]]),
    ("SELECT * FROM range(0)", []),
    # generate_series(n) yields 0..n-1 in the reference, where DuckDB
    # yields 1..n (ROADMAP queue 3): the port's binder is the reference's
    # copy, so the rows are pinned as the reference gives them
    ("SELECT * FROM generate_series(3)", [["0"], ["1"], ["2"]]),
    ("SELECT * FROM generate_series(1, 3)", [["1"], ["2"], ["3"]]),
    ("SELECT sum(range) AS s FROM range(1, 101)", [["5050"]]),
    ("SELECT count(*) AS n FROM t WHERE x > (SELECT avg(x) FROM t)",
     [["3"]]),
    ("SELECT count(*) AS n FROM t WHERE x > "
     "(SELECT max(x) FROM t WHERE x > 100)", [["0"]]),
    ("SELECT s, x FROM t WHERE x < (SELECT max(x) FROM t WHERE s = 'a') "
     "ORDER BY s", [["a", "-3"]]),
])
def test_sources_and_scalar_subqueries(conns, sql, rows):
    ref, port = conns
    assert port.sql(sql).strings() == ref.sql(sql).strings() == rows


def test_materialized_raises_unless_injected():
    with pytest.raises(RuntimeError, match="not injected"):
        Executor(Catalog()).execute(P.Materialized(), optimize=False)


def test_sources_need_the_catalog_s_device():
    """SingleRow and RangeSource read no table: their device is the
    catalog's, which a Connection sets; a bare catalog names none."""
    with pytest.raises(ValueError, match="device"):
        Executor(Catalog()).execute(P.SingleRow(), optimize=False)
    assert Connection(device="cpu").catalog.device.type == "cpu"


@pytest.mark.parametrize("sql,name", [
    ("EXPLAIN ANALYZE SELECT x FROM t", "EXPLAIN ANALYZE"),
    ("PRAGMA enable_verification", "enable_verification"),
])
def test_unported_statements_raise_by_name(conns, sql, name):
    """Both statements raised by name until the port had the profiler and
    verification; now EXPLAIN ANALYZE appends each operator's ms and rows,
    and the PRAGMA turns verification on; the session answers as before."""
    _, port = conns
    try:
        out = port.sql(sql).strings()
        if name == "EXPLAIN ANALYZE":
            tree = out[-1][0].split("\n")
            assert tree[0].startswith("project  [")
            assert tree[1].startswith("  table_scan(t, filters=0)  [")
            assert all(line.endswith(" ms, 5 rows]") for line in tree[:2])
        else:
            assert port.config.enable_verification
        assert port.sql("SELECT count(*) AS n FROM t").strings() == [["5"]]
    finally:
        port.config.enable_verification = False


@pytest.mark.parametrize("setting,value", [
    ("enable_verification", "true"), ("force_external", "true"),
    ("query_timeout_s", "5")])
def test_unported_settings_refuse_queries_by_name(setting, value):
    """The three settings refused every query by name until the port ran
    what each asks; now SET takes the value and queries (a CREATE TABLE AS
    too) run under it: verified through their legs, out of core where a
    stage is large enough to split, under the deadline.  SET back, queries
    run as before."""
    conn = Connection(device="cpu")
    conn.register_numpy("t", {"x": np.arange(4, dtype=np.int64)})
    conn.sql(f"SET {setting} = {value}")
    assert conn.sql("SELECT count(*) AS n FROM t").strings() == [["4"]]
    if setting == "enable_verification":
        assert [leg for leg, _ in conn.executor.last_legs] == [
            "production", "eager", "unoptimized", "row-by-row"]
    conn.sql("CREATE TABLE u AS SELECT x FROM t")
    assert conn.sql("SELECT sum(x) AS s FROM u").strings() == [["6"]]
    setattr(conn.config, setting, type(getattr(conn.config, setting))())
    assert conn.sql("SELECT count(*) AS n FROM t").strings() == [["4"]]
