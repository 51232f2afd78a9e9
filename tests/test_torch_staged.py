"""Staged execution on the torch port: the default path, held against the
whole-plan eager path and the JAX package, at SF0.01 on the CPU.

Each of the 22 TPC-H SQL texts gives the same rows staged and whole plan,
with no retry (`tests/test_torch_sql_tpch.py` holds the default, staged
path against the reference's rows for all 22; here q6 and q12 are also
held against the reference directly).  The K1 / K2 wrapper calls of Q6,
Q12 and Q3 are the same in both modes.  Compaction gathers live rows in
row order into a power-of-two bucket and keeps `monotone`; the inputs a
direct-address path needs aligned (a PK join's build side, a reverse-PK
join's probe side, a K2 probe over a sorted storage column, the spine
below them) are never compacted, nor is the probe side of a join that
guesses its expansion capacity from it, so q21 (whose EXISTS mark joins
expand several pairs a row) regrows no more on the staged path than on the
whole plan.
"""

import numpy as np
import pytest
import torch

from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu_torch.api import Connection, connect
from duckdb_cubit_tpu_torch.exec.executor import Executor, bucket_count
from duckdb_cubit_tpu_torch.ops import fused_scan as fs
from duckdb_cubit_tpu_torch.ops import probe
from duckdb_cubit_tpu_torch.plan import optimizer as opt
from duckdb_cubit_tpu_torch.plan.physical import (HashJoin, RelColumn,
                                                  Relation)
from duckdb_cubit_tpu_torch.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL
from duckdb_cubit_tpu_torch.types import INT64


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small torch ops on one thread for the module: with several test
    workers on the machine, torch's default pool (one thread per core in
    every worker) oversubscribes the cores and slows each op many times
    over.  The slice's other test files import this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def conn():
    return connect(0.01, device="cpu")


def rows_match(got, want) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(w) and all(cells_equal(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


def _run(conn, sql, staged):
    conn.config.staged_execution = staged
    try:
        before = conn.executor.retry_count
        rows = conn.sql(sql).strings()
        return rows, conn.executor.retry_count - before
    finally:
        conn.config.staged_execution = True


@pytest.mark.parametrize("n", sorted(SQL))
def test_staged_equals_whole_plan(conn, n):
    staged, retries = _run(conn, SQL[n], True)
    whole, whole_retries = _run(conn, SQL[n], False)
    assert rows_match(staged, whole), (staged[:3], whole[:3])
    assert retries == whole_retries == 0


@pytest.fixture(scope="module")
def ref():
    return ref_connect(sf=0.01)


@pytest.mark.parametrize("n", [6, 12])
def test_staged_matches_reference(conn, ref, n):
    want = RR.to_strings(ref.executor.execute(ref.binder.bind_sql(SQL[n]),
                                              compiled=False))
    assert rows_match(_run(conn, SQL[n], True)[0], want)


@pytest.fixture
def kernel_calls(monkeypatch):
    calls = {"k1": 0, "k2": []}
    real_k1, real_k2 = fs.fused_scan_sum, probe.monotone_gather_many

    def k1(*args):
        calls["k1"] += 1
        return real_k1(*args)

    def k2(luts, keys):
        calls["k2"].append(len(luts))
        return real_k2(luts, keys)
    monkeypatch.setattr(fs, "fused_scan_sum", k1)
    monkeypatch.setattr(probe, "monotone_gather_many", k2)
    return calls


@pytest.mark.parametrize("n,k1,k2", [(6, 1, []), (12, 0, [2]), (3, 0, [4])])
def test_kernel_calls_same_in_both_modes(conn, kernel_calls, monkeypatch, n,
                                         k1, k2):
    """Q6 (decode off: the fused scan-sum) calls K1 once, Q12 and Q3 call K2
    once with 2 and 4 luts, staged and whole plan alike."""
    monkeypatch.setattr(conn.config, "index_scan_max_count", 0)
    monkeypatch.setattr(conn.config, "index_scan_percentage", 0.0)
    seen = {}
    for staged in (True, False):
        kernel_calls["k1"], kernel_calls["k2"] = 0, []
        _run(conn, SQL[n], staged)
        seen[staged] = (kernel_calls["k1"], kernel_calls["k2"])
    assert seen[True] == seen[False] == (k1, k2)


def test_compaction_keeps_monotone_and_row_order(conn):
    """Live rows gathered in row order into a power-of-two bucket (at least
    8,192): a sorted column stays sorted through the padding, which repeats
    the last row; NULL masks travel along; the count is exact."""
    rng = np.random.default_rng(3)
    cap = 1 << 16
    keys = torch.as_tensor(np.sort(rng.integers(0, 10**6, cap)))
    mask = torch.as_tensor(rng.random(cap) < 0.2)
    valid = torch.as_tensor(rng.random(cap) < 0.9)
    rel = Relation({"k": RelColumn(keys, INT64, monotone=True),
                    "v": RelColumn(keys * 3, INT64, valid=valid)}, mask, cap)
    ex = Executor(conn.catalog, conn.config)
    out = ex._compact_relation(rel)
    live = int(mask.sum())
    assert out.capacity == bucket_count(live) == 16384
    assert out.columns["k"].monotone and not out.columns["v"].monotone
    assert int(out.mask.sum()) == live and bool(out.mask[:live].all())
    k = out.columns["k"].array
    assert torch.equal(k[:live], keys[mask])
    assert bool((k[1:] >= k[:-1]).all())
    assert torch.equal(out.columns["v"].valid[:live], valid[mask])
    assert torch.equal(out.columns["v"].array[:live], keys[mask] * 3)
    # a relation that fills its bucket stays as it is
    full = Relation(rel.columns, torch.ones(cap, dtype=torch.bool), cap)
    assert ex._compact_relation(full) is full


def _stages(ex, root, keep_aligned=False, out=None):
    """Every stage input of the plan, as the staged executor finds them:
    [(parent stage root, child op, compactable)]."""
    out = [] if out is None else out
    bounds, _ = ex._find_boundaries(root, keep_aligned)
    for child, compactable in bounds:
        out.append((root, child, compactable))
        _stages(ex, child, not compactable, out)
    return out


@pytest.mark.parametrize("n", sorted(SQL))
def test_aligned_boundaries_left_uncompacted(conn, n):
    """No stage input that a direct-address path reads by base row is
    compacted: a PK join's build side, a reverse-PK join's probe side and a
    K2 probe side over a sorted storage column never appear as compactable
    inputs (they stay in their join's stage or are run uncompacted); nor
    does the probe side of a join that sizes its expansion from it."""
    ex = conn.executor
    plan = opt.optimize(conn.binder.bind_sql(SQL[n]), conn.catalog)
    ex._prepare(plan)
    compactable = {id(c) for _, c, ok in _stages(ex, plan) if ok}
    for op in plan.walk():
        if ex._expands(op):
            assert id(op.children[0]) not in compactable
        if not isinstance(op, HashJoin):
            continue
        if op._pk is not None:
            assert id(op.children[1]) not in compactable
        if op._reverse_pk is not None or ex._kernel_probe_side(op):
            assert id(op.children[0]) not in compactable


def test_expanding_probe_side_regrows_as_the_whole_plan():
    """A correlated EXISTS with a residual (a mark join) over a filtered
    probe side whose rows match three build rows each: 8,192 live probe
    rows would compact into an 8,192-slot bucket, whose expansion guess
    (16,384 pairs) undershoots the 24,576 pairs and regrows once.  Left
    uncompacted, the staged path sizes it as the whole plan does: no
    retry in either mode, the same count."""
    n = 1 << 14
    q = ("SELECT count(*) AS c FROM p WHERE p.v = 0 AND EXISTS "
         "(SELECT * FROM b WHERE b.k = p.k AND b.w <> p.v)")
    for staged in (True, False):
        c = Connection(device="cpu")
        c.register_numpy("p", {"k": np.arange(n, dtype=np.int64),
                               "v": np.arange(n, dtype=np.int64) % 2})
        c.register_numpy("b", {
            "k": np.repeat(np.arange(n, dtype=np.int64), 3),
            "w": np.tile(np.arange(3, dtype=np.int64), n)})
        c.config.staged_execution = staged
        assert c.sql(q).strings() == [[str(n // 2)]]
        assert c.executor.retry_count == 0


def test_selective_inputs_are_compacted(conn):
    """Q3's stages compact their selective inputs (one count read each) and
    give the whole plan's rows."""
    before = conn.executor.compacted_boundaries
    rows, _ = _run(conn, SQL[3], True)
    assert conn.executor.compacted_boundaries - before >= 1
    assert rows_match(rows, _run(conn, SQL[3], False)[0])
