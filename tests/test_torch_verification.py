"""Capacity retries, verification legs and pinned prepared queries on the
torch port, against the JAX package: the twin of
`tests/test_verification_and_retry.py`.

The skewed many-to-many join regrows its expansion capacity under staging;
a check with no recovery fail-stops; a seeded CUBIT corruption is caught by
verification's unoptimized leg 3 alone, a corrupted `Arith.eval` (shared by
legs 1-3) by the row-by-row leg 4 alone; TPC-H q3, q6, q12 and q16 pass
verification at SF0.01 with the reference's rows, and each leg's K1 / K2
wrapper calls are counted (leg 3 makes none); a prepared query pinned
before an UPDATE keeps answering from its snapshot while a fresh execute
sees the update; `exec/pyverify.py` gives the reference's rows.  Inputs
are made with numpy from a seed; rows match as `to_strings` renders them,
DOUBLE cells within the 1e-9 relative tolerance of `cells_equal`.
"""

import numpy as np
import pytest

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.exec import pyverify as RPV
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu.exec.executor import Executor as RefExecutor
from duckdb_cubit_tpu.index.cubit import CubitIndex as RefCubitIndex
from duckdb_cubit_tpu.storage.table import Catalog as RefCatalog
from duckdb_cubit_tpu.storage.table import from_numpy as ref_from_numpy
from duckdb_cubit_tpu_torch.api import Connection, connect
from duckdb_cubit_tpu_torch.config import EngineConfig
from duckdb_cubit_tpu_torch.exec import pyverify as PV
from duckdb_cubit_tpu_torch.exec import result as PR
from duckdb_cubit_tpu_torch.exec.executor import Executor
from duckdb_cubit_tpu_torch.index.cubit import CubitIndex
from duckdb_cubit_tpu_torch.ops import expressions as E
from duckdb_cubit_tpu_torch.ops import fused_scan as fs
from duckdb_cubit_tpu_torch.ops import probe
from duckdb_cubit_tpu_torch.storage import dml
from duckdb_cubit_tpu_torch.storage.table import Catalog, from_numpy
from duckdb_cubit_tpu_torch.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL
from test_torch_staged import one_intra_op_thread  # noqa: F401


def ref_rows(ref, sql):
    return RR.to_strings(ref.executor.execute(ref.binder.bind_sql(sql),
                                              compiled=False))


def rows_match(got, want) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(w) and all(cells_equal(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


def _indexed(port: bool):
    """t(k 1..200, v = row % 10) with a 10-bin CUBIT index on v."""
    data = {"k": np.arange(1, 201, dtype=np.int64),
            "v": (np.arange(200) % 10).astype(np.int64)}
    if port:
        t = from_numpy("t", data, device="cpu")
        t.indexes["v"] = CubitIndex.build("v", data["v"].astype(np.int32),
                                          t.capacity, t.num_rows, 10,
                                          device="cpu")
        cat = Catalog()
        cat.register(t)
        return Connection(cat, device="cpu"), t
    t = ref_from_numpy("t", data)
    t.indexes["v"] = RefCubitIndex.build("v", data["v"].astype(np.int32),
                                         t.capacity, t.num_rows, 10)
    cat = RefCatalog()
    cat.register(t)
    return RefConnection(cat), t


# ------------------------------------------------------- capacity retry e2e
@pytest.mark.parametrize("staged", [True, False])
def test_expansion_retry_skewed_synthetic_join(staged):
    """A skewed many-to-many join whose output is 16x the probe capacity:
    under staging the join's stage regrows and runs again (the whole plan
    without staging), and the count is the reference test's."""
    conn = Connection(device="cpu")
    conn.config.staged_execution = staged
    n = 1 << 10
    conn.register_numpy("build", {
        "k": np.ones(n, np.int64), "bv": np.arange(n, dtype=np.int64)})
    conn.register_numpy("probe", {
        "k": np.ones(16, np.int64), "pv": np.arange(16, dtype=np.int64)})
    conn.sql("SET join_expansion_factor = 0.01")
    before = conn.executor.retry_count
    rows = conn.sql("SELECT count(*) AS c FROM probe, build "
                    "WHERE probe.k = build.k").strings()
    assert rows == [[str(16 * n)]]
    assert conn.executor.retry_count > before


@pytest.mark.parametrize("name", ["join_key_pack_range[x]", "exq#0#8",
                                  "expansion#0#268435456"])
def test_nonrecoverable_check_still_failstops(name):
    """A failed check with no registered recovery (the pack range, the
    exchange quota of a mesh, a regrow past 2**28) is refused, as by the
    reference: the caller raises instead of looping."""
    ops = [object()]
    assert Executor._handle_failed_checks([name], ops) is False
    ref = RefExecutor.__new__(RefExecutor)
    ref.retry_count = 0
    assert ref._handle_failed_checks(["join_key_pack_range[x]"], []) is False


# ------------------------------------------------- the legs and seeded faults
@pytest.mark.parametrize("port", [True, False])
def test_verification_catches_corrupted_index(port):
    """Seeded mutation: clear bin 3 of the CUBIT index.  The optimized plan
    (index-matched) silently counts 0 rows for v = 3 in both packages; with
    verification on, the unoptimized leg 3 catches it."""
    conn, t = _indexed(port)
    assert conn.sql("SELECT count(*) AS c FROM t WHERE v = 2").strings() \
        == [["20"]]
    idx = t.indexes["v"]
    if port:
        words = idx.words.clone()
        words[3] = 0
        idx.words = words
    else:
        idx.words = idx.words.at[3].set(0)
    idx._rebuild_cum()
    idx._query_cache.clear()
    assert conn.sql("SELECT count(*) AS c FROM t WHERE v = 3").strings() \
        == [["0"]]
    conn.sql("SET enable_verification = true")
    with pytest.raises(RuntimeError, match="verification failed: optimized "
                                           "and unoptimized"):
        conn.sql("SELECT count(*) AS c2 FROM t WHERE v = 3").strings()


def test_verification_passes_clean_queries():
    conn, _ = _indexed(True)
    ref, _ = _indexed(False)
    q = ("SELECT v, count(*) AS c, min(k) AS mk FROM t WHERE v >= 5 "
         "GROUP BY v ORDER BY v")
    conn.sql("SET enable_verification = true")
    rows = conn.sql(q).strings()
    assert len(rows) == 5 and rows[0][0] == "5"
    assert rows == ref_rows(ref, q)
    assert [leg for leg, _ in conn.executor.last_legs] == [
        "production", "eager", "unoptimized", "row-by-row"]


@pytest.fixture(scope="module")
def ref_sf001():
    return ref_connect(sf=0.01)


@pytest.fixture
def legs_counted(monkeypatch):
    """Each verification leg's K1 / K2 wrapper calls: {leg: [K1, K2]}."""
    calls = {"k1": 0, "k2": 0}
    per_leg = {}
    real_k1, real_k2 = fs.fused_scan_sum, probe.monotone_gather_many
    real_leg = Executor._leg

    def k1(*args):
        calls["k1"] += 1
        return real_k1(*args)

    def k2(luts, keys):
        calls["k2"] += 1
        return real_k2(luts, keys)

    def leg(self, name, run):
        calls["k1"] = calls["k2"] = 0
        out = real_leg(self, name, run)
        per_leg[name] = [calls["k1"], calls["k2"]]
        return out
    monkeypatch.setattr(fs, "fused_scan_sum", k1)
    monkeypatch.setattr(probe, "monotone_gather_many", k2)
    monkeypatch.setattr(Executor, "_leg", leg)
    return per_leg


@pytest.mark.parametrize("n", [3, 6, 12, 16])
def test_verification_tpch(ref_sf001, legs_counted, n):
    """The SQL texts under verification at SF0.01 (decode off, so q6 takes
    the fused scan-sum), against the reference's rows.  Legs 1 and 2 call
    K1 / K2 alike (q6 K1, q3 and q12 K2), leg 3 calls neither; leg 4 runs
    (lineitem's 60,175 rows are under pyverify_max_rows)."""
    conn = connect(0.01, device="cpu")
    conn.sql("SET index_scan_max_count = 0")
    conn.sql("SET index_scan_percentage = 0.0")
    conn.sql("SET enable_verification = true")
    rows = conn.sql(SQL[n]).strings()
    ref_sf001.config.index_scan_max_count = 0
    ref_sf001.config.index_scan_percentage = 0.0
    assert rows_match(rows, ref_rows(ref_sf001, SQL[n]))
    legs = legs_counted
    assert list(legs) == ["production", "eager", "unoptimized"]
    assert [leg for leg, _ in conn.executor.last_legs][-1] == "row-by-row"
    assert legs["production"] == legs["eager"]
    assert legs["unoptimized"] == [0, 0]
    k1, k2 = legs["production"]
    assert k1 == (1 if n == 6 else 0)
    assert (k2 >= 1) == (n in (3, 12))


# --------------------------------------------------- pinned prepared query
def test_reader_pinned_epoch_survives_merge():
    """A prepared query resolved at epoch N keeps answering from its
    pinned snapshot after an UPDATE publishes N+1; a fresh execute()
    re-resolves and sees N+1 (the reference test's counts)."""
    conn, t = _indexed(True)
    prepared = conn.prepare("SELECT count(*) AS c FROM t WHERE v = 3")
    assert PR.to_strings(prepared.execute()) == [["20"]]
    epoch_before = t.indexes["v"].epoch
    rows = np.nonzero(t.columns["v"].host == 3)[0][:2]
    dml.update_column(t, "v", rows, np.array([7, 7]))
    assert t.indexes["v"].epoch == epoch_before + 1
    assert PR.to_strings(prepared.run_pinned()) == [["20"]]
    assert PR.to_strings(prepared.execute()) == [["18"]]
    assert PR.to_strings(prepared.run_pinned()) == [["18"]]
    assert PR.to_strings(conn.prepare_plan(conn.binder.bind_sql(
        "SELECT count(*) AS c FROM t WHERE v = 7")).execute()) == [["22"]]


# -------- leg 4: the independent row-by-row executor
def _fd(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    return ({"k": rng.integers(0, 50, n), "v": rng.integers(-100, 100, n)},
            {"k": np.arange(50, dtype=np.int64),
             "w": rng.integers(0, 10, 50)})


def test_pyverify_agrees_on_joins_and_aggregates():
    f, d = _fd()
    cfg = EngineConfig()
    cfg.enable_verification = True
    conn, ref = Connection(config=cfg, device="cpu"), RefConnection()
    for c in (conn, ref):
        c.register_numpy("f", f)
        c.register_numpy("d", d)
    q = ("SELECT d.w AS w, count(*) AS c, sum(f.v) AS s FROM f, d "
         "WHERE f.k = d.k GROUP BY d.w ORDER BY w")
    rows = conn.sql(q).strings()
    assert len(rows) > 0 and rows == ref_rows(ref, q)
    assert conn.executor.last_legs[-1][0] == "row-by-row"


PYVERIFY_QUERIES = [
    "SELECT d.w AS w, count(*) AS c, sum(f.v) AS s, min(f.v) AS lo, "
    "max(f.v) AS hi, avg(f.v) AS a FROM f, d WHERE f.k = d.k GROUP BY d.w",
    "SELECT f.k, f.v FROM f WHERE f.v > 90 ORDER BY f.v DESC, f.k LIMIT 7",
    "SELECT count(*) AS c FROM f WHERE f.k IN (SELECT k FROM d WHERE w > 5)",
    "SELECT f.k, d.w FROM f LEFT JOIN d ON f.k = d.k AND d.w > 4 "
    "WHERE f.v < -95",
    "SELECT CASE WHEN v > 0 THEN v * 2 ELSE 0 END AS x, k % 7 AS m "
    "FROM f WHERE k < 3",
]


@pytest.mark.parametrize("q", PYVERIFY_QUERIES)
def test_pyverify_matches_the_reference(q):
    """`exec/pyverify.run` on the unoptimized plan of each package: the
    same rows, rendered and in any order."""
    f, d = _fd(1, 400)
    conn, ref = Connection(device="cpu"), RefConnection()
    for c in (conn, ref):
        c.register_numpy("f", f)
        c.register_numpy("d", d)
    port_plan, ref_plan = conn.binder.bind_sql(q), ref.binder.bind_sql(q)
    assert PV.supports(port_plan) == RPV.supports(ref_plan)
    got = PV.run(port_plan, conn.catalog)
    want = RPV.run(ref_plan, ref.catalog)
    names = list(conn.sql(q).relation.columns)
    assert sorted([PV.render(r[n]) for n in names] for r in got) == \
        sorted([RPV.render(r[n]) for n in names] for r in want)
    assert PV.compare_to_strings(got, names, conn.sql(q).strings()) is None


def test_pyverify_catches_shared_kernel_bug(monkeypatch):
    """An off-by-one in every addition (`Arith.eval`, run by legs 1-3)
    confirms itself there; only the row-by-row leg 4 catches it."""
    cfg = EngineConfig()
    cfg.enable_verification = True
    conn = Connection(config=cfg, device="cpu")
    conn.register_numpy("m", {"a": np.arange(100, dtype=np.int64),
                              "b": np.arange(100, dtype=np.int64)})
    orig = E.Arith.eval

    def corrupted(self, ctx):
        out = orig(self, ctx)
        if self.op == "+":
            return E.Typed(out.array + 1, out.dtype, out.dictionary,
                           out.valid)
        return out
    monkeypatch.setattr(E.Arith, "eval", corrupted)
    with pytest.raises(RuntimeError, match="row-by-row"):
        conn.sql("SELECT sum(a + b) AS s FROM m")
    # legs 1-3 alone (leg 4 off) confirm the fault
    cfg.pyverify_max_rows = 0
    rows = conn.sql("SELECT sum(a + b) AS s FROM m").strings()
    assert rows == [[str(2 * sum(range(100)) + 100)]]
