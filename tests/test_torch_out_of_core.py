"""Out-of-core (multi-pass) execution on the torch port, against the JAX
package: the twin of `tests/test_out_of_core.py`.

A stage whose working set exceeds `memory_limit` (or any aggregate stage
under `force_external`) splits its driving scan into row-range chunks,
runs the stage once per chunk for partial aggregates, and a merge pass
re-aggregates them; zone maps skip chunks no row of which can pass.  The
rows must equal the single-pass rows and the reference's (integer and
decimal cells exactly; DOUBLE sums within 1e-9 relative, since chunking
re-associates the additions), and the pass counts must be what
`_chunk_plan`'s estimate gives.
"""

import numpy as np
import pytest

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu_torch.api import Connection, connect
from duckdb_cubit_tpu_torch.config import EngineConfig
from duckdb_cubit_tpu_torch.ops import fused_scan as fs
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL
from test_torch_staged import one_intra_op_thread  # noqa: F401


def _columns(n=50_000, seed=0):
    rng = np.random.default_rng(seed)
    return {"g": rng.integers(0, 7, n), "v": rng.integers(-100, 1000, n),
            "d": rng.random(n)}


@pytest.fixture(scope="module")
def conns():
    ref, port = RefConnection(), Connection(device="cpu")
    for c in (ref, port):
        c.register_numpy("t", _columns())
    return ref, port


@pytest.fixture
def port(conns):
    """The module's port connection, its settings restored after the
    test."""
    conn = conns[1]
    saved = dict(vars(conn.config))
    yield conn
    vars(conn.config).update(saved)


def ref_rows(ref, sql):
    return RR.to_strings(ref.executor.execute(ref.binder.bind_sql(sql),
                                              compiled=False))


SQL_G = ("SELECT g, count(*) AS c, sum(v) AS s, min(v) AS lo, max(v) AS hi, "
         "avg(v) AS av, sum(d) AS sd, avg(d) AS ad FROM t GROUP BY g "
         "ORDER BY g")


def _rows_equal(got, want):
    """Exact for ints / decimals; float sums may differ in the last ulps
    because chunked execution re-associates the additions."""
    assert len(got) == len(want)
    for gr, wr in zip(got, want):
        assert len(gr) == len(wr)
        for g, w in zip(gr, wr):
            if g == w:
                continue
            assert abs(float(g) - float(w)) <= 1e-9 * max(
                1.0, abs(float(w))), (g, w)
    return True


def _passes(conn, sql):
    ex = conn.executor
    p0, s0 = ex.external_passes, ex.external_chunks_skipped
    rows = conn.sql(sql).strings()
    return rows, ex.external_passes - p0, ex.external_chunks_skipped - s0


def test_force_external_matches_single_pass(conns, port):
    want = port.sql(SQL_G).strings()
    port.sql("SET force_external = true")
    got, passes, _ = _passes(port, SQL_G)
    assert passes == 4
    assert _rows_equal(got, want) and _rows_equal(got, ref_rows(conns[0],
                                                                SQL_G))


def test_memory_limit_triggers_chunking(port):
    """g (int8 storage), v (int16) and d (float64) over 57,344 slots: 11 B
    a slot x 4 = 2,523,136 B against a 1,000,000 B budget: 4 passes of
    16,384 slots (the last 8,192)."""
    want = port.sql(SQL_G).strings()
    port.sql("SET memory_limit = 1000000")
    scan = [op for op in port.binder.bind_sql(SQL_G).walk()
            if op.name == "table_scan"][0]
    assert port.executor.working_set(scan, 0) == 57_344 * 11 * 4
    assert port.executor.chunk_count(scan, 0) == 4
    got, passes, skipped = _passes(port, SQL_G)
    assert (passes, skipped) == (4, 0)
    assert _rows_equal(got, want)


def test_ungrouped_external(conns, port):
    q = "SELECT count(*) AS c, sum(v) AS s, avg(d) AS a FROM t WHERE v > 50"
    want = port.sql(q).strings()
    port.sql("SET force_external = true")
    got, passes, _ = _passes(port, q)
    assert _rows_equal(got, want) and passes == 4
    assert _rows_equal(got, ref_rows(conns[0], q))


def test_external_empty_result(conns, port):
    """An ungrouped SUM over no rows: zero result rows, as the reference
    gives (ROADMAP queue 3), single pass and out of core alike."""
    q = "SELECT sum(v) AS s FROM t WHERE v > 100000"
    assert port.sql(q).strings() == [] == ref_rows(conns[0], q)
    port.sql("SET force_external = true")
    assert port.sql(q).strings() == []


@pytest.fixture(scope="module")
def clustered():
    """v = 0..4 * 65536 - 1: four zone-map blocks of clustered values."""
    conn = Connection(device="cpu")
    conn.register_numpy("t", {"v": np.arange(4 * 65536, dtype=np.int64)})
    return conn


@pytest.mark.parametrize("q,want,passes,skipped", [
    # the first chunk holds v < 1000, the other three are skipped
    ("SELECT count(*) AS c, sum(v) AS s FROM t WHERE v < 1000",
     [["1000", "499500"]], 1, 3),
    # every chunk skipped (each conjunct alone passes the global bounds):
    # one pass over the first chunk shapes the result
    ("SELECT count(*) AS c FROM t WHERE v < 1000 AND v > 200000", [["0"]],
     1, 4),
    # the global bounds prove the filter empty (the scan is always-false
    # and keeps no filter): four empty passes, none skipped
    ("SELECT count(*) AS c FROM t WHERE v < 0", [["0"]], 4, 0),
])
def test_zone_map_chunk_skip(clustered, q, want, passes, skipped):
    conn = clustered
    conn.config.force_external = False
    assert conn.sql(q).strings() == want
    conn.config.force_external = True
    assert _passes(conn, q) == (want, passes, skipped)


@pytest.fixture(scope="module")
def sf001():
    return ref_connect(sf=0.01), connect(0.01, device="cpu")


@pytest.mark.parametrize("n", [1, 6])
def test_tpch_forced_external(sf001, n, monkeypatch):
    """q1 and q6 forced out of core at SF0.01 with the decode path off (q6's
    index-answered predicate would decode otherwise), against the
    reference's rows; 4 passes each, and no fused scan-sum (K1) call in a
    pass."""
    ref, conn = sf001
    calls = []
    real = fs.fused_scan_sum
    monkeypatch.setattr(fs, "fused_scan_sum",
                        lambda *a: calls.append(1) or real(*a))
    for c in (conn.config, ref.config):
        monkeypatch.setattr(c, "index_scan_max_count", 0)
        monkeypatch.setattr(c, "index_scan_percentage", 0.0)
    want = ref_rows(ref, SQL[n])
    monkeypatch.setattr(conn.config, "force_external", True)
    got, passes, _ = _passes(conn, SQL[n])
    assert passes == 4 and calls == []
    assert _rows_equal(got, want)


def test_out_of_core_join_rooted_stage():
    """Chunking extends to an aggregate over a join: the probe scan is
    chunked, the build side stays resident."""
    rng = np.random.default_rng(0)
    n = 200_000
    fk = rng.integers(0, 100, n)
    fv = rng.integers(0, 50, n)
    dw = rng.integers(1, 5, 100)
    cfg = EngineConfig()
    cfg.force_external = True
    conn = Connection(config=cfg, device="cpu")
    conn.register_numpy("f", {"k": fk, "v": fv})
    conn.register_numpy("d", {"k": np.arange(100, dtype=np.int64), "w": dw})
    rows, passes, _ = _passes(conn, "SELECT sum(f.v * d.w) AS s, "
                                    "count(*) AS c FROM f, d "
                                    "WHERE f.k = d.k")
    assert passes == 4, "the join stage did not chunk"
    assert rows == [[str(int((fv * dw[fk]).sum())), str(n)]]


def test_carried_mesh_catalog_runs_out_of_core(sf001):
    """A catalog carried from the reference's 8-device mesh catalog is
    placed "default" (its tensors sit on one device), so forced out-of-core
    execution still chunks it, with the reference's single-device rows."""
    from duckdb_cubit_tpu.parallel.mesh import make_mesh
    from duckdb_cubit_tpu_torch.tpch.load import from_reference_catalog

    ref_mesh = ref_connect(0.01, mesh=make_mesh(8))
    assert ref_mesh.catalog.placement.startswith("mesh8:")
    cat = from_reference_catalog(ref_mesh.catalog, device="cpu")
    assert cat.placement == "default"
    conn = Connection(cat, device="cpu")
    conn.config.force_external = True
    got, passes, _ = _passes(conn, SQL[1])
    assert passes > 0
    assert _rows_equal(got, ref_rows(sf001[0], SQL[1]))
