"""Session settings and runtime checks on the torch port, against the JAX
package: the twin of `tests/test_config_and_checks.py`.

A SET changes the prepared plan (the decode decision) and takes effect
through the cached executor; `enable_verification` runs the query through
its legs; three-key joins are exact on every join type; a single-match
join over duplicate build keys recovers; statistics prune filters; the
two-key pack-range check fires; the query deadline abandons a query and
the session stays usable.  Inputs are made with numpy from a seed; rows
must match the reference's as `to_strings` renders them.  The reference
runs its eager path (`compiled=False`) where its rows are the oracle.
"""

import time
from collections import OrderedDict

import numpy as np
import pytest

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu.exec.executor import Executor as RefExecutor
from duckdb_cubit_tpu.plan import optimizer as ref_opt
from duckdb_cubit_tpu.plan import physical as RP
from duckdb_cubit_tpu.storage.table import Catalog as RefCatalog
from duckdb_cubit_tpu.storage.table import from_numpy as ref_from_numpy
from duckdb_cubit_tpu_torch.api import Connection, QueryTimeoutError
from duckdb_cubit_tpu_torch.config import EngineConfig
from duckdb_cubit_tpu_torch.exec import result as PR
from duckdb_cubit_tpu_torch.exec.executor import Executor
from duckdb_cubit_tpu_torch.plan import optimizer as opt
from duckdb_cubit_tpu_torch.plan import physical as P
from duckdb_cubit_tpu_torch.storage.table import Catalog, from_numpy
from test_torch_staged import one_intra_op_thread  # noqa: F401


def _big_columns():
    rng = np.random.default_rng(7)
    n = 20000
    return {"k": np.arange(n, dtype=np.int64),
            "v": rng.integers(0, 1000, size=n).astype(np.int64)}


@pytest.fixture()
def conns():
    ref, port = RefConnection(), Connection(device="cpu")
    for c in (ref, port):
        c.register_numpy("big", _big_columns())
        c.sql("CREATE INDEX ON big(v)")
    return ref, port


def ref_rows(ref, sql):
    return RR.to_strings(ref.executor.execute(ref.binder.bind_sql(sql),
                                              compiled=False))


def _decode_cap(conn, mod, optimizer):
    plan = optimizer.optimize(
        conn.binder.bind_sql("SELECT k FROM big WHERE v = 42"), conn.catalog)
    plan.prepare(mod.ExecContext(conn.catalog, conn.executor.config))
    return [op for op in plan.walk()
            if isinstance(op, mod.TableScan)][0]._decode_cap


def test_set_index_scan_max_count_changes_plan(conns):
    """v = 42 matches about 20 of 20,000 rows: the decode path; with the
    thresholds set to ~0 the mask-based scan; set back, decode again."""
    ref, port = conns

    def caps():
        return (_decode_cap(port, P, opt), _decode_cap(ref, RP, ref_opt))

    got, want = caps()
    assert got is not None and got == want
    for c in (ref, port):
        c.sql("SET index_scan_max_count = 1")
        c.sql("SET index_scan_percentage = 0.0000001")
    assert caps() == (None, None)
    for c in (ref, port):
        c.sql("SET index_scan_max_count = 16384")
        c.sql("SET index_scan_percentage = 0.001")
    got, want = caps()
    assert got is not None and got == want


def test_set_takes_effect_through_cached_executor(conns):
    ref, port = conns
    q = "SELECT count(*) AS c FROM big WHERE v = 42"
    r1 = port.sql(q).strings()
    key1 = port.executor._catalog_version()
    port.sql("SET index_scan_max_count = 1")
    port.sql("SET index_scan_percentage = 0.0000001")
    assert port.executor._catalog_version() != key1
    assert port.sql(q).strings() == r1 == ref_rows(ref, q)


def test_enable_verification_runs_its_legs(conns):
    ref, port = conns
    q = ("SELECT v, count(*) AS c FROM big WHERE v < 5 GROUP BY v "
         "ORDER BY v")
    port.sql("SET enable_verification = true")
    rows = port.sql(q).strings()
    assert [r[0] for r in rows] == ["0", "1", "2", "3", "4"]
    assert rows == ref_rows(ref, q)
    assert [leg for leg, _ in port.executor.last_legs] == [
        "production", "eager", "unoptimized", "row-by-row"]
    assert port.executor.legs_exact


def _three_key(mod, from_np, cat):
    cat.register(from_np("probe", {
        "a": np.array([1, 1, 2, 2, 3], np.int64),
        "b": np.array([10, 10, 20, 20, 30], np.int64),
        "c": np.array([5, 6, 7, 7, 9], np.int64),
        "pv": np.array([100, 200, 300, 400, 500], np.int64),
    }))
    cat.register(from_np("build", {
        "a": np.array([1, 2, 3], np.int64),
        "b": np.array([10, 20, 31], np.int64),
        "c": np.array([5, 7, 9], np.int64),
        "bv": np.array([7, 8, 9], np.int64),
    }))
    return cat


JOINS = {
    # (join type, single match, expected: (pv, bv) pairs or pv values)
    "inner expansion": ("inner", False, [(100, 7), (300, 8), (400, 8)]),
    "semi": ("semi", False, [100, 300, 400]),
    "anti": ("anti", False, [200, 500]),
    "single match": ("inner", True, [(100, 7), (300, 8), (400, 8)]),
}


def _rows(rel_rows, jt):
    if jt in ("semi", "anti"):
        return sorted(int(r[3]) for r in rel_rows)
    return sorted((int(r[3]), int(r[7])) for r in rel_rows)


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("name", list(JOINS))
def test_three_key_joins_exact(name, staged):
    """Hash-combined three-column keys with the exact re-check, on both
    executor paths, against the reference's staged path."""
    jt, single, want = JOINS[name]
    keys = ["a", "b", "c"]
    port_cat = _three_key(P, lambda n, d: from_numpy(n, d, device="cpu"),
                          Catalog())
    plan = P.HashJoin(P.TableScan("probe"), P.TableScan("build"), keys, keys,
                      jt, single_match=single, build_prefix="b_")
    _, rows, _ = PR.materialize(Executor(port_cat, EngineConfig(
        staged_execution=staged)).execute(plan))
    ref_cat = _three_key(RP, ref_from_numpy, RefCatalog())
    ref_plan = RP.HashJoin(RP.TableScan("probe"), RP.TableScan("build"),
                           keys, keys, jt, single_match=single,
                           build_prefix="b_")
    _, ref_rows_, _ = RR.materialize(RefExecutor(ref_cat).execute(ref_plan))
    assert _rows(rows, jt) == _rows(ref_rows_, jt) == want


def _dup_catalog(mod, from_np, cat):
    cat.register(from_np("p", {"k": np.array([1, 2], np.int64)}))
    cat.register(from_np("b", {"k": np.array([1, 1, 2], np.int64),
                               "v": np.array([5, 6, 7], np.int64)}))
    return cat


def _dup_plan(mod):
    return mod.HashJoin(mod.TableScan("p"), mod.TableScan("b"), ["k"], ["k"],
                        "left", single_match=True, build_prefix="b_")


@pytest.mark.parametrize("staged", [True, False])
def test_single_match_uniqueness_check_recovers_or_fires(staged):
    """A single-match join over a non-unique build side never returns
    wrong rows: the failed `unique` check flips it to the expansion join and
    the stage (staged) or the whole plan (not staged) runs again, giving
    the reference's staged rows.  A marked difference: the reference's
    whole-plan compiled path fail-stops here (it has no retry), the port's
    whole-plan path recovers too."""
    want = [(1, 5), (1, 6), (2, 7)]
    ex = Executor(_dup_catalog(P, lambda n, d: from_numpy(n, d, device="cpu"),
                               Catalog()),
                  EngineConfig(staged_execution=staged))
    _, rows, _ = PR.materialize(ex.execute(_dup_plan(P)))
    assert sorted((int(r[0]), int(r[2])) for r in rows) == want
    assert ex.retry_count == 1
    from duckdb_cubit_tpu.config import EngineConfig as RefConfig
    ref_cat = _dup_catalog(RP, ref_from_numpy, RefCatalog())
    if staged:
        _, ref_got, _ = RR.materialize(
            RefExecutor(ref_cat).execute(_dup_plan(RP)))
        assert sorted((int(r[0]), int(r[2])) for r in ref_got) == want
    else:
        with pytest.raises(RuntimeError, match="unique"):
            RR.materialize(RefExecutor(ref_cat, RefConfig(
                staged_execution=False)).execute(_dup_plan(RP)))


def test_statistics_propagation_prunes_filters(conns):
    ref, port = conns
    for c, optimizer, mod in ((port, opt, P), (ref, ref_opt, RP)):
        plan = optimizer.optimize(
            c.binder.bind_sql("SELECT k FROM big WHERE v >= 0"), c.catalog)
        scan = [op for op in plan.walk() if isinstance(op, mod.TableScan)][0]
        assert scan.filters == [] and scan.index_filters == []
        plan = optimizer.optimize(
            c.binder.bind_sql("SELECT k FROM big WHERE v > 1000"), c.catalog)
        scan = [op for op in plan.walk() if isinstance(op, mod.TableScan)][0]
        assert getattr(scan, "always_false", False)
    q = "SELECT count(*) AS c FROM big WHERE v > 1000"
    assert port.sql(q).strings() == ref_rows(ref, q) == [["0"]]


@pytest.mark.parametrize("staged", [True, False])
def test_pack_range_check_fires_on_out_of_range_second_key(staged):
    """The two-column key's pack-range check is not recoverable: both paths
    raise, naming it."""
    cat = Catalog()
    cat.register(from_numpy("p", {
        "a": np.array([1, 2], np.int64),
        "b": np.array([1, -3], np.int64),   # negative second key
        "v": np.array([10, 20], np.int64)}, device="cpu"))
    cat.register(from_numpy("b2", {"a": np.array([1], np.int64),
                                   "b": np.array([1], np.int64)},
                            device="cpu"))
    plan = P.HashJoin(P.TableScan("p"), P.TableScan("b2"), ["a", "b"],
                      ["a", "b"], "semi", single_match=False)
    ex = Executor(cat, EngineConfig(staged_execution=staged))
    with pytest.raises(RuntimeError, match="join_key_pack_range"):
        PR.materialize(ex.execute(plan))


@pytest.fixture
def own_cache(monkeypatch):
    """An empty prepare cache of the test's own."""
    cache = OrderedDict()
    monkeypatch.setattr(Executor, "_prepare_cache", cache)
    return cache


def _slow(real, seconds):
    """`real` after `seconds` of bounded Python steps (the SIGALRM handler
    runs between them)."""
    def run(*args, **kwargs):
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            time.sleep(0.01)
        return real(*args, **kwargs)
    return run


@pytest.mark.parametrize("where", ["cross product", "prepare", "execute"])
def test_query_timeout_guard(where, own_cache, monkeypatch):
    """A query past `query_timeout_s` raises QueryTimeoutError and the
    session stays usable.  The reference's twin runs a 40K x 40K cross
    product, whose regrows reach gigabytes if the signal lands late; here
    every full run is bounded: a 2,000 x 2,000 cross product (4M pairs,
    under 0.5 GB, about 1 s on the CPU, 4x the deadline), or an operator
    that takes 2 s (8x) in its host decisions or in its run.  Those bounds
    are the test's own time limit: it ends within seconds whether or not
    the signal fires, and fails when it fires late (1.5 s).  Cut short
    during `prepare`, the query leaves no prepare-cache entry."""
    cfg = EngineConfig()
    cfg.query_timeout_s = 0.25
    conn = Connection(config=cfg, device="cpu")
    n = 2000
    conn.register_numpy("big", {"k": np.arange(n, dtype=np.int64)})
    q = "SELECT count(*) AS c FROM big WHERE k >= 0"
    if where == "cross product":
        q = "SELECT count(*) AS c FROM big a, big b WHERE a.k + b.k >= 0"
    elif where == "prepare":
        monkeypatch.setattr(P.TableScan, "prepare",
                            _slow(P.TableScan.prepare, 2.0))
    else:
        monkeypatch.setattr(P.GroupAggregate, "_execute",
                            _slow(P.GroupAggregate._execute, 2.0))
    t0 = time.perf_counter()
    with pytest.raises(QueryTimeoutError):
        conn.sql(q)
    assert time.perf_counter() - t0 < 1.5
    if where == "prepare":
        assert len(own_cache) == 0
    monkeypatch.undo()
    cfg.query_timeout_s = 0.0
    assert conn.sql("SELECT count(*) AS c FROM big").strings() == [[str(n)]]
    if where == "cross product":
        assert conn.sql(q).strings() == [[str(n * n)]]
