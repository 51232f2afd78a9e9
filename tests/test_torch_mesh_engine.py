"""The engine on a mesh over `torch.distributed`, against the JAX package:
the twin of `tests/test_distributed.py`, under its case names.

One gloo world of 8 CPU ranks is spawned once for the file
(`parallel/spawn.run`); every rank connects to SF0.01 sharded over the mesh
(`connect(0.01, device="cpu", mesh=...)`) and runs the cases of
`torch_mesh_engine_ranks`.  This process computes the reference's rows:
single device for the TPC-H plans and SQL texts (the reference's own twin
reads golden CSVs that are not mounted here, and skips), and on the
reference's `make_mesh(8)` (8 virtual devices, `conftest.py`) for Q1 and
Q6.  Every rank must return the same rows.  Rows compare as `to_strings`
renders them: DOUBLE cells within `answers.cells_equal`'s 1e-9 relative
tolerance, every other cell exactly; in order where the query has an ORDER
BY, as multisets otherwise.
"""

import pytest

import torch_mesh_engine_ranks as R
from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu.parallel import mesh as RM
from duckdb_cubit_tpu.tpch import queries as ref_queries
from duckdb_cubit_tpu_torch.exec.executor import bucket_count
from duckdb_cubit_tpu_torch.parallel import spawn
from duckdb_cubit_tpu_torch.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL

N_RANKS = 8
# the TPC-H queries without an ORDER BY (one row each)
UNORDERED = {6, 14, 17, 19}


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results of every case, from one 8-rank world."""
    return spawn.run(R.run_all, N_RANKS, backend="gloo", device="cpu",
                     deadline_s=400)


@pytest.fixture(scope="module")
def ref():
    return ref_connect(sf=R.SF)


def replicated(ranks, key, members=N_RANKS):
    """A replicated result: the same on every rank."""
    vals = [ranks[r][key] for r in range(members)]
    for v in vals[1:]:
        assert v == vals[0]
    return vals[0]


def assert_rows(got, want, ordered=True):
    """`got` = (rows, DOUBLE flags) against the reference's rows."""
    rows, doubles = got
    if not ordered:
        rows, want = sorted(rows), sorted(want)
    assert len(rows) == len(want), (len(rows), len(want))
    for g, w in zip(rows, want):
        assert len(g) == len(w) == len(doubles)
        for a, b, d in zip(g, w, doubles):
            assert a == b or (d and cells_equal(a, b)), (g, w)


def test_tables_are_sharded(ranks):
    for r in range(N_RANKS):
        s = ranks[r]["sharding"]
        assert all(s["sharded"].values())
        assert s["capacity"] * N_RANKS == s["global"]
        assert s["row_offset"] == r * s["capacity"]
        assert s["price_rows"] == s["global"] // N_RANKS
        n_bins, words = s["word_shape"]
        assert words == s["global"] // 32 // N_RANKS
        assert s["cum_shape"] == s["word_shape"]
        # the PK lut is whole on every rank: one slot a key from the
        # smallest o_orderkey (1) to the largest
        assert s["pk_slots"] == 60_000
    live = [ranks[r]["sharding"]["live"] for r in range(N_RANKS)]
    assert sum(live) == 60_175
    # full, partly live and empty blocks: rank 7 holds 2,831 live rows of
    # lineitem, and nation's 25 rows all lie in rank 0's block
    assert live[0] == ranks[0]["sharding"]["capacity"] and live[7] == 2_831
    assert [ranks[r]["sharding"]["nation_live"]
            for r in range(N_RANKS)] == [25] + [0] * 7


# mix of shapes: bitmap scan + ungrouped agg (6), dense group (1), join +
# sort-group (3), left-join derived (13), mark-join EXISTS (21),
# correlated scalar (17)
@pytest.mark.parametrize("n", R.PLANS)
def test_query_on_mesh_matches_golden(ranks, ref, n):
    got = replicated(ranks, ("plan", n))
    want = RR.to_strings(ref_queries.run(ref.executor, n))
    assert_rows(got, want, ordered=n not in UNORDERED)


def test_sql_path_on_mesh(ranks, ref):
    rows = replicated(ranks, "returnflags")
    assert len(rows[0]) == 3 and rows[0][0][0] == "A"
    assert_rows(rows, ref.sql(R.RETURNFLAGS).strings())


def test_sql_q21_on_mesh_matches_golden(ranks, ref):
    assert_rows(replicated(ranks, "q21_sql"), ref.sql(SQL[21]).strings())


@pytest.mark.parametrize("n", [1, 6])
def test_matches_reference_on_its_mesh(ranks, n):
    """Q1 and Q6 against the reference run on its own 8-device mesh."""
    ref_mesh = ref_connect(sf=R.SF, mesh=RM.make_mesh(N_RANKS))
    want = RR.to_strings(ref_queries.run(ref_mesh.executor, n))
    assert_rows(replicated(ranks, ("plan", n)), want)


def test_no_retry_on_the_mesh(ranks):
    assert replicated(ranks, "retries") == 0


def test_subgroup_replicates_tables(ranks, ref):
    subs = [ranks[r]["subgroup"] for r in range(N_RANKS)]
    assert subs[3:] == [None] * 5
    for s in subs[:3]:
        assert not any(s["sharded"]) and s["capacity"] == 65536
        assert s == subs[0]
    assert_rows(subs[0]["q1"],
                RR.to_strings(ref_queries.run(ref.executor, 1)))
    assert_rows(subs[0]["q6"], ref.sql(SQL[6]).strings(), ordered=False)
    assert_rows(subs[0]["q3"], ref.sql(SQL[3]).strings())


def test_compaction_bucket_equal_on_every_rank(ranks, ref):
    comp = [ranks[r]["compaction"] for r in range(N_RANKS)]
    local = [c["local"] for c in comp]
    assert len(set(local)) > 1, local          # the blocks differ
    want_cap = bucket_count(max(local))
    assert want_cap < comp[0]["block_cap"]
    for c in comp:
        assert c["sharded"] and c["compacted_cap"] == want_cap
        assert c["kept"] == c["local"]          # no live row is lost
    # inside a query: every boundary has one bucket on every rank
    seen = [c["q9_boundaries"] for c in comp]
    assert seen[0] and all(len(s) == len(seen[0]) for s in seen)
    for i in range(len(seen[0])):
        assert len({s[i][3] for s in seen}) == 1
    for c in comp:
        assert c["q9"] == comp[0]["q9"]
    assert_rows(comp[0]["q9"], ref.sql(SQL[9]).strings())
    big = RefConnection()          # not the shared cached catalog
    big.register_numpy("big", R.big_table())
    assert_rows(comp[0]["rows"], big.sql(R.BIG_SELECTIVE).strings(),
                ordered=False)


def test_sharded_root_is_gathered(ranks, ref):
    roots = [ranks[r]["sharded_root"] for r in range(N_RANKS)]
    for s in roots:
        assert s["block_sharded"] and not s["root_sharded"]
        assert s["rows"] == roots[0]["rows"]
        assert "sharded" in s["refused"]
    assert_rows(roots[0]["rows"], ref.sql(R.SELECTIVE).strings(),
                ordered=False)


def test_verification_legs_on_mesh(ranks, ref):
    ver = replicated(ranks, "verification")
    for name, text in (("nation", None), ("returnflags", R.RETURNFLAGS),
                       ("q3", SQL[3])):
        rows, legs = ver[name]
        assert legs[:3] == ["production", "eager", "unoptimized"]
        if text is not None:
            assert_rows(rows, ref.sql(text).strings())
    # leg 4 reads the tables gathered whole (every table <= 100,000 rows)
    assert ver["nation"][1][3:] == ["row-by-row"]
    assert ver["returnflags"][1][3:] == ["row-by-row"]
    assert ver["nation"][0][0][0] == ["0", "5"]


def test_block_dependent_dictionary_refused(ranks):
    """A concat past its dictionary budget builds the dictionary of the
    strings it sees: a block's would differ from rank to rank, so it
    raises on a mesh instead of answering from mismatched codes."""
    msgs = [ranks[r]["refusals"]["concat_past_budget"]
            for r in range(N_RANKS)]
    assert all(m is not None and "mesh" in m for m in msgs), msgs
