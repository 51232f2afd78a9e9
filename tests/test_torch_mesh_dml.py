"""DML, transactions, checkpoints and the query deadline on a mesh over
`torch.distributed`, against the JAX package's mesh.

One gloo world of 8 CPU ranks is spawned once for the file
(`parallel/spawn.run`); every rank connects to SF0.01 sharded over the mesh
(`connect(0.01, device="cpu", mesh=...)`) and runs the cases of
`torch_mesh_dml_ranks`.  This process runs the same statements on the
reference's `Connection(catalog, mesh=make_mesh(8))` (8 virtual devices,
`conftest.py`) and on the port's single-device CPU connection, each over an
uncached catalog of its own.  Every rank's answer after each statement must
equal both.  Rows compare as `strings()` renders them: the probes after the
statements read no DOUBLE column and compare exactly; the TPC-H texts
compare DOUBLE cells within `answers.cells_equal`'s 1e-9 relative
tolerance.
"""

import pytest

import torch_mesh_dml_ranks as R
from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.parallel import mesh as RM
from duckdb_cubit_tpu.storage import dml as ref_dml
from duckdb_cubit_tpu.tpch import load as ref_load
from duckdb_cubit_tpu_torch.api import Connection, QueryTimeoutError
from duckdb_cubit_tpu_torch.parallel import spawn
from duckdb_cubit_tpu_torch.storage import dml
from duckdb_cubit_tpu_torch.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.tpch.load import load_catalog
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL

N_RANKS = 8
INDEX_CHECKS = ("l_discount", "l_shipdate", "l_quantity", "g_insert_direct",
                "g_insert_growth", "g_delete_after_growth")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of every case, from one 8-rank world."""
    path = str(tmp_path_factory.mktemp("mesh-db"))
    return spawn.run(R.run_all, N_RANKS, path, backend="gloo",
                     device="cpu", deadline_s=400)


def sequence(conn, dml_module, after_step=None) -> dict:
    """What the ranks run, on one connection: the steps, the TPC-H texts,
    the write-ahead log's statements with the probes after them, and a
    query under a 1 ms deadline followed by Q6."""
    out = {"steps": R.run_steps(conn, dml_module, after_step)}
    out["tpch"] = {n: conn.sql(SQL[n]).strings() for n in R.TPCH_AFTER}
    for q in R.WAL_STATEMENTS:
        conn.sql(q)
    out["after_wal"] = [conn.sql(q).strings() for q in R.PERSIST_PROBES]
    conn.sql("SET query_timeout_s = 0.001")
    try:
        conn.sql(SQL[13]).strings()
        out["deadline"] = None
    except Exception as e:  # noqa: BLE001 - each package has its own class
        out["deadline"] = type(e).__name__
    finally:
        conn.sql("SET query_timeout_s = 0")
    out["next"] = conn.sql(SQL[6]).strings()
    return out


@pytest.fixture(scope="module")
def ref():
    """The reference on its own 8-device mesh, over a catalog of its own
    (never the process's cached one: DML would reach later tests)."""
    conn = RefConnection(ref_load.load_catalog(R.SF, cache=False),
                         mesh=RM.make_mesh(N_RANKS))
    return sequence(conn, ref_dml)


@pytest.fixture(scope="module")
def single():
    """The port on one CPU device, with the index state after the steps
    that the ranks check."""
    conn = Connection(load_catalog(R.SF, device="cpu", cache=False),
                      device="cpu")
    index = {}

    def after(name):
        if name == "update_indexed":
            li = conn.catalog.table("lineitem")
            for col in ("l_discount", "l_shipdate", "l_quantity"):
                ix = li.indexes[col]
                index[col] = (R.digest(R.host_words(ix)),
                              ix.bin_counts.tolist())
        elif f"g_{name}" in INDEX_CHECKS:
            ix = conn.catalog.table("g").indexes["v"]
            index[f"g_{name}"] = (R.digest(R.host_words(ix)),
                                  ix.bin_counts.tolist())
        elif name == "rollback":
            index["ids"] = [(n, v, rows) for n, _, v, rows
                            in R.catalog_ids(conn)]

    out = sequence(conn, dml, after)
    out["index"] = index
    return out


def replicated(ranks, *keys):
    """A result that must be the same on every rank."""
    vals = []
    for r in range(N_RANKS):
        v = ranks[r]
        for k in keys:
            v = v[k]
        vals.append(v)
    for v in vals[1:]:
        assert v == vals[0]
    return vals[0]


@pytest.mark.parametrize("name", R.STEP_NAMES)
def test_step_matches_reference_and_single_device(ranks, ref, single, name):
    results, probes = replicated(ranks, "steps", name)
    assert (results, probes) == tuple(single["steps"][name])
    ref_results, ref_probes = ref["steps"][name]
    assert probes == ref_probes
    # statement statuses: the same counts as the reference's
    for got, want in zip(results, ref_results):
        if isinstance(got, str) and got.split()[0] in ("DELETE", "UPDATE",
                                                       "INSERT"):
            assert got.split()[:2] == want.split()[:2]
        elif not isinstance(got, str):
            assert got == want


def test_step_answers_are_not_trivial(ranks):
    steps = replicated(ranks, "steps")
    assert steps["delete_where"][0] == ["DELETE 4798"]
    assert steps["delete_where"][1][0][0][0] == "55377"
    assert steps["delete_all"][0][1:] == ["DELETE 4999", "DELETE 10001"]
    assert steps["delete_all"][1] == [[["0"]]]
    assert steps["insert_new_string"][1][0] == [["26", "325", "51"]]
    assert ["25", "ATLANTIS"] in steps["insert_new_string"][1][1]
    # inside the transaction, then after the ROLLBACK
    results, probes = steps["rollback"]
    assert results[4] == [["25", "324", "53"]]
    assert probes[0] == [["26", "325", "51"]]


@pytest.mark.parametrize("which", INDEX_CHECKS)
def test_cubit_index_bit_equal_to_a_rebuild(ranks, single, which):
    """Words, cumulative words and bin counts after the mesh's DML equal an
    index built afresh over the gathered column (deleted rows' bits
    cleared), and the single-device port's index, bit for bit."""
    checks = [ranks[r]["checks"][which] for r in range(N_RANKS)]
    for c in checks:
        assert c["words"] and c["cum"] and c["counts"], c
        assert c["digest"] == checks[0]["digest"]
        assert c["bin_counts"] == checks[0]["bin_counts"]
    assert (checks[0]["digest"], checks[0]["bin_counts"]) == \
        single["index"][which]
    assert checks[0]["live_bits"] > 0


def test_growth_moves_the_blocks(ranks):
    """8,000 rows in blocks of 1,024, then 8,300 in blocks of 2,048: the
    bounds of every block moved and each rank cut its new block."""
    for r in range(N_RANKS):
        before = ranks[r]["checks"]["placement_insert_direct"]
        after = ranks[r]["checks"]["placement_insert_growth"]
        assert before["sharded"] and after["sharded"]
        assert (before["capacity"], before["row_offset"]) == (1024, r * 1024)
        assert (after["capacity"], after["row_offset"]) == (2048, r * 2048)
        assert after["global"] == 16384 and after["words"] == (7, 64)
        assert after["index_offset"] == after["row_offset"]
    live = [ranks[r]["checks"]["placement_insert_growth"]["live"]
            for r in range(N_RANKS)]
    assert sum(live) == R.G_DIRECT_ROWS + R.G_GROWTH_ROWS
    assert live[4] == 8300 - 4 * 2048 and live[5:] == [0, 0, 0]


def test_uids_and_versions_equal_after_rollback(ranks, single):
    ids = replicated(ranks, "checks", "ids_after_rollback")
    assert [(n, v, rows) for n, _, v, rows in ids] == single["index"]["ids"]


def test_match_rows_reads_a_replicated_relation(ranks):
    m = replicated(ranks, "match_rows")
    assert not m["sharded"]
    assert m["capacity"] == m["global"] == N_RANKS * m["block"]
    assert m["n"] > 0


@pytest.mark.parametrize("what,message", [
    ("insert_select", "INSERT ... SELECT not supported yet"),
    ("commit_outside", "no active transaction")])
def test_refusals_kept_on_mesh(ranks, what, message):
    assert replicated(ranks, "refusals", what) == message


def assert_rows(rows, want, doubles):
    """In order; DOUBLE cells within `answers.cells_equal`'s 1e-9 relative
    tolerance (sums and averages add floats in another order on a mesh),
    every other cell exactly."""
    assert len(rows) == len(want)
    for g, w in zip(rows, want):
        assert len(g) == len(w) == len(doubles)
        for a, b, d in zip(g, w, doubles):
            assert a == b or (d and cells_equal(a, b)), (g, w)


@pytest.mark.parametrize("n", R.TPCH_AFTER)
def test_tpch_after_dml_matches(ranks, ref, single, n):
    rows, doubles, _ = replicated(ranks, "tpch", n)
    assert rows
    assert_rows(rows, single["tpch"][n], doubles)
    assert_rows(rows, ref["tpch"][n], doubles)


def test_k1_declines_and_k2_runs_per_block(ranks):
    for r in range(N_RANKS):
        calls = {n: ranks[r]["tpch"][n][2] for n in R.TPCH_AFTER}
        assert all(c["fused_scan_sum"] == 0 for c in calls.values())
        assert calls[3]["monotone_gather_many"] >= 1
        assert calls[12]["monotone_gather_many"] >= 1


def persisted(ranks, key):
    return replicated(ranks, "persistence", key)


def test_only_rank0_writes(ranks):
    writes = [ranks[r]["persistence"]["writes"] for r in range(N_RANKS)]
    assert writes[0] == {"_write_checkpoint": 1, "wal_append": 2}
    assert all(w == {"_write_checkpoint": 0, "wal_append": 0}
               for w in writes[1:])
    assert persisted(ranks, "files") == ["checkpoint.npz", "manifest.json"]


def test_wal_holds_the_committed_statements(ranks, ref, single):
    assert persisted(ranks, "wal") == (
        "DELETE FROM g WHERE k < 100;\n"
        "INSERT INTO nation VALUES (26, 'LEMURIA', 2, 'y');\n")
    assert persisted(ranks, "before") == single["after_wal"] == \
        ref["after_wal"]


@pytest.mark.parametrize("where", ["single", "mesh"])
def test_reopen_equals_the_rows_before(ranks, where):
    assert persisted(ranks, where) == persisted(ranks, "before")
    assert persisted(ranks, "mesh_sharded")


def test_deadline_raises_on_every_rank(ranks, single):
    """The reference's own raise is not held here: its alarm can land in
    JAX's compilation-cache write, which swallows the error (ROADMAP queue
    3), so on its mesh the query sometimes runs to its end."""
    d = replicated(ranks, "deadline")
    assert d["raised"] is not None and "deadline" in d["raised"]
    assert single["deadline"] == QueryTimeoutError.__name__


def test_session_answers_after_deadline(ranks, ref, single):
    d = replicated(ranks, "deadline")
    assert d["next"] == single["next"] == ref["next"]


def test_no_extra_collective_without_deadline(ranks):
    d = replicated(ranks, "deadline")
    assert d["collectives_off"] == d["collectives"]
    assert d["collectives_deadline"] > d["collectives"]


@pytest.mark.parametrize("name", R.SQLLOGIC_FILES)
def test_sqllogic_dml_file_on_mesh(ranks, name):
    rep = replicated(ranks, "sqllogic", name)
    assert not rep["skipped"] and rep["executed"] > 0
    # every table the file leaves is a row block of 8,192 / 8 rows
    assert all(rep["sharded"].values())
