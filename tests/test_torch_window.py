"""Window functions: the torch port's `ops/window.py` and Window operator
against the JAX package's, on the CPU.

The twin of `tests/test_window.py` and of the window tests of
`tests/test_functions.py`.  Every primitive of `ops/window` runs in both
packages on the same numpy-seeded arrays (ties, all rows masked, n = 1, one
partition, NULL values) for every frame form: the legacy `rows_upto`,
`range_upto` and `partition`, and `("rows" | "range", lo, hi)` with None
bounds; sliding MIN / MAX over frames 2**k - 1, 2**k and 2**k + 1 rows
long.  Arrays are bit-equal (both sorts are stable, so ties resolve alike),
DOUBLE sums within a 1e-9 relative tolerance.
Then the Window operator through SQL: rows must match as `to_strings`
renders them, DOUBLE cells within the 1e-9 relative tolerance of
`tpch/answers.cells_equal`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.ops import window as RW
from duckdb_cubit_tpu_torch.api import Connection
from duckdb_cubit_tpu_torch.ops import window as PW
from duckdb_cubit_tpu_torch.tpch.answers import cells_equal


def make_case(seed: int, n: int, n_parts: int, key_range: int,
              masked: float = 0.1, nulls: float = 0.2):
    rng = np.random.default_rng(seed)
    part = rng.integers(0, max(n_parts, 1), n).astype(np.int64)
    order = rng.integers(0, key_range, n).astype(np.int64)
    vals = rng.integers(-100, 100, n).astype(np.int64)
    fvals = rng.normal(size=n)
    valid = rng.random(n) >= masked
    vvalid = rng.random(n) >= nulls
    return part, order, vals, fvals, valid, vvalid


CASES = {
    "many_parts_ties": (0, 300, 7, 20),
    "one_partition": (1, 300, 1, 1000),
    "no_partition_key": (2, 200, 0, 15),
    "n1": (3, 1, 1, 5),
    "all_masked": (4, 50, 3, 10),
}


def contexts(name):
    seed, n, n_parts, key_range = CASES[name]
    part, order, vals, fvals, valid, vvalid = make_case(
        seed, n, n_parts, key_range)
    if name == "all_masked":
        valid[:] = False
    parts = (part,) if n_parts else ()
    ref = RW.analyze(tuple(jnp.asarray(p) for p in parts),
                     (jnp.asarray(order),), jnp.asarray(valid))
    port = PW.analyze(tuple(torch.as_tensor(p) for p in parts),
                      (torch.as_tensor(order),), torch.as_tensor(valid))
    data = {"vals": vals, "fvals": fvals, "vvalid": vvalid,
            "order_sorted": order[np.asarray(ref.perm)]}
    return ref, port, data


def same(a, b):
    """Bit-equal; DOUBLE sums (whose cumsums associate differently in XLA
    and torch) within the 1e-9 relative tolerance."""
    a, b = np.asarray(a), b.numpy()
    if a.dtype.kind == "f" and b.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=0)
    else:
        np.testing.assert_array_equal(a, b)


def pair(x):
    return jnp.asarray(x), torch.as_tensor(x)


FRAMES = ["rows_upto", "range_upto", "partition",
          ("rows", -2, 3), ("rows", None, 1), ("rows", -1, None),
          ("rows", 1, 3), ("rows", -4, -1), ("range", -5, 5),
          ("range", None, 2), ("range", 0, None), ("range", -3, 0)]


@pytest.mark.parametrize("case", list(CASES))
def test_analyze_and_rankings_match(case):
    ref, port, _ = contexts(case)
    for f in ("perm", "starts", "change", "seg_start", "seg_end",
              "last_peer", "seg_id", "valid_sorted"):
        same(getattr(ref, f), getattr(port, f))
    for fn in ("row_number", "rank", "dense_rank"):
        same(getattr(RW, fn)(ref), getattr(PW, fn)(port))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("frame", FRAMES, ids=str)
def test_aggregates_match_for_every_frame(case, frame):
    ref, port, data = contexts(case)
    enc_r, enc_p = pair(data["order_sorted"])
    v_r, v_p = pair(data["vals"])
    f_r, f_p = pair(data["fvals"])
    nv_r, nv_p = pair(data["vvalid"])
    for kind, (vr, vp), (vvr, vvp) in [
            ("sum", (v_r, v_p), (nv_r, nv_p)),
            ("avg", (v_r, v_p), (nv_r, nv_p)),
            ("count", (v_r, v_p), (nv_r, nv_p)),
            ("min", (v_r, v_p), (nv_r, nv_p)),
            ("max", (v_r, v_p), (None, None)),
            ("sum_double", (f_r, f_p), (None, None)),
            ("min", (f_r, f_p), (nv_r, nv_p)),
            ("max", (f_r, f_p), (nv_r, nv_p)),
            ("count", (None, None), (None, None))]:
        ro, rok = RW.agg(ref, kind, vr, vvr, frame, order_enc=enc_r)
        po, pok = PW.agg(port, kind, vp, vvp, frame, order_enc=enc_p)
        same(ro, po)
        assert (rok is None) == (pok is None)
        if rok is not None:
            same(rok, pok)
    ab_r = RW.frame_bounds(ref, frame, enc_r)
    ab_p = PW.frame_bounds(port, frame, enc_p)
    if ab_r is not None:
        same(ab_r[0], ab_p[0])
        same(ab_r[1], ab_p[1])
        for last in (False, True):
            ro, rok = RW.first_last_sliding(ref, v_r, nv_r, ab_r, last)
            po, pok = PW.first_last_sliding(port, v_p, nv_p, ab_p, last)
            same(ro, po)
            same(rok, pok)


@pytest.mark.parametrize("case", list(CASES))
def test_value_movers_match(case):
    ref, port, data = contexts(case)
    v_r, v_p = pair(data["vals"])
    nv_r, nv_p = pair(data["vvalid"])
    for off in (-3, -1, 1, 2, 500):
        for default in (None, -7):
            for vr, vp in ((None, None), (nv_r, nv_p)):
                ro, rok = RW.shift(ref, v_r, vr, off, default)
                po, pok = PW.shift(port, v_p, vp, off, default)
                same(ro, po)
                same(rok, pok)
    same(RW.first_value(ref, v_r), PW.first_value(port, v_p))
    for frame in ("rows_upto", "partition", "range_upto"):
        same(RW.last_value(ref, v_r, frame=frame),
             PW.last_value(port, v_p, frame=frame))


@pytest.mark.parametrize("k", [2, 3, 5, 6])
def test_sliding_min_max_at_powers_of_two(k):
    """Frames 2**k - 1, 2**k and 2**k + 1 rows long: the sparse table's
    level choice (the reference's 63 - clz)."""
    ref, port, data = contexts("one_partition")
    v_r, v_p = pair(data["vals"])
    for length in (2**k - 1, 2**k, 2**k + 1):
        for frame in (("rows", -(length - 1), 0), ("rows", 0, length - 1)):
            for kind in ("min", "max"):
                ro, _ = RW.agg(ref, kind, v_r, None, frame)
                po, _ = PW.agg(port, kind, v_p, None, frame)
                same(ro, po)


def test_legacy_entry_points_match():
    part, order, vals, _, valid, _ = make_case(5, 120, 4, 9)
    same(RW.running_sum((jnp.asarray(part),), (jnp.asarray(order),),
                        jnp.asarray(vals), jnp.asarray(valid)),
         PW.running_sum((torch.as_tensor(part),), (torch.as_tensor(order),),
                        torch.as_tensor(vals), torch.as_tensor(valid)))
    same(RW.partition_total((jnp.asarray(part),), jnp.asarray(vals),
                            jnp.asarray(valid)),
         PW.partition_total((torch.as_tensor(part),), torch.as_tensor(vals),
                            torch.as_tensor(valid)))
    # the reference test's literal cases
    out = PW.running_sum((torch.tensor([0, 0, 0, 1, 1]),),
                         (torch.tensor([1, 2, 3, 1, 2]),),
                         torch.tensor([5, 7, 1, 10, 20]),
                         torch.ones(5, dtype=torch.bool))
    assert out.tolist() == [5, 12, 13, 10, 30]
    out = PW.rank((torch.zeros(6, dtype=torch.int64),),
                  (torch.tensor([10, 10, 20, 20, 20, 30]),),
                  torch.ones(6, dtype=torch.bool))
    assert sorted(out.tolist()) == [1, 1, 3, 3, 3, 6]


# ------------------------------------------------------ through SQL
COLUMNS = {
    "g": np.array([1, 1, 2, 2], np.int64),
    "o": np.array([10, 20, 1, 5], np.int64),
    "x": np.array([5, 7, 20, 10], np.int64),
}


def _rng_table(seed=11, n=400):
    rng = np.random.default_rng(seed)
    return {"g": rng.integers(0, 9, n), "k": rng.integers(0, 60, n),
            "v": rng.integers(-100, 100, n),
            "f": np.round(rng.normal(size=n), 3),
            "d": rng.integers(0, 100000, n) / 100.0,
            "rid": np.arange(n, dtype=np.int64)}


@pytest.fixture(scope="module")
def conns():
    ref, port = RefConnection(), Connection(device="cpu")
    for c in (ref, port):
        c.register_numpy("t", COLUMNS)
        c.register_numpy("r", _rng_table())
        c.register_numpy("u", {"o": np.array([1, 2, 2, 3], np.int64),
                               "x": np.array([1, 10, 100, 1000], np.int64)})
        c.sql("CREATE TABLE nk (p INTEGER, q DOUBLE, v INTEGER, "
              "m DECIMAL(10,2))")
        c.sql("INSERT INTO nk VALUES (1, 2.5, 10, 1.50), (NULL, 1.5, 20, "
              "2.25), (1, NULL, 30, 0.75), (NULL, -0.5, 40, 3.00), "
              "(2, 2.5, 50, NULL), (2, -3.25, 60, 1.25)")
    return ref, port


def assert_same(conns, sql):
    ref, port = conns
    got, want = port.sql(sql).strings(), ref.sql(sql).strings()
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(cells_equal(a, b)
                                        for a, b in zip(g, w)), (g, w)
    return got


def test_window_sql_full(conns):
    rows = assert_same(conns, (
        "SELECT g, o, x, "
        "row_number() OVER (PARTITION BY g ORDER BY o) AS rn, "
        "rank() OVER (PARTITION BY g ORDER BY o) AS rk, "
        "dense_rank() OVER (PARTITION BY g ORDER BY o) AS dr, "
        "sum(x) OVER (PARTITION BY g ORDER BY o) AS rs, "
        "sum(x) OVER (PARTITION BY g) AS tot, "
        "lag(x) OVER (PARTITION BY g ORDER BY o) AS lg, "
        "lead(x, 1, -1) OVER (PARTITION BY g ORDER BY o) AS ld, "
        "min(x) OVER (PARTITION BY g ORDER BY o) AS mn, "
        "avg(x) OVER (PARTITION BY g) AS av, "
        "count(*) OVER (PARTITION BY g) AS cn, "
        "first_value(x) OVER (PARTITION BY g ORDER BY o) AS fv "
        "FROM t ORDER BY g, o"))
    assert rows[1] == ["1", "20", "7", "2", "2", "2", "12", "12", "5",
                       "-1", "5", "6.0", "2", "5"]


@pytest.mark.parametrize("sql", [
    # ties on the order key: RANGE (the default) takes peers, ROWS does not
    "SELECT o, x, sum(x) OVER (ORDER BY o) AS rng, sum(x) OVER (ORDER BY o "
    "ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS rws FROM u "
    "ORDER BY o, x",
    "SELECT x, row_number() OVER (PARTITION BY g + 0 ORDER BY x DESC) AS rn "
    "FROM t ORDER BY x",
    "SELECT g, s, rank() OVER (ORDER BY s DESC) AS rk FROM (SELECT g, "
    "sum(x) AS s FROM t GROUP BY g) AS agg ORDER BY g",
    # DESC float keys, NULL partition and order keys
    "SELECT v, rank() OVER (ORDER BY q DESC) AS rk, row_number() OVER "
    "(PARTITION BY p ORDER BY q) AS rn, sum(v) OVER (PARTITION BY p) AS s, "
    "count(q) OVER (PARTITION BY p) AS cq FROM nk ORDER BY v",
    "SELECT v, avg(m) OVER (PARTITION BY p) AS am, max(m) OVER (ORDER BY "
    "v) AS mm, sum(m) OVER (ORDER BY v ROWS BETWEEN 1 PRECEDING AND 1 "
    "FOLLOWING) AS sm, last_value(v) OVER (ORDER BY v) AS lv FROM nk "
    "ORDER BY v",
    "SELECT rid, sum(f) OVER (PARTITION BY g ORDER BY k) AS sf, min(d) "
    "OVER (PARTITION BY g ORDER BY k DESC ROWS BETWEEN 3 PRECEDING AND 2 "
    "FOLLOWING) AS md, first_value(v) OVER (PARTITION BY g ORDER BY k "
    "ROWS BETWEEN 2 PRECEDING AND 1 PRECEDING) AS fp, last_value(v) OVER "
    "(PARTITION BY g ORDER BY k RANGE BETWEEN CURRENT ROW AND 4 FOLLOWING) "
    "AS lr FROM r ORDER BY rid",
    "SELECT rid, sum(v) OVER (PARTITION BY g ORDER BY k DESC RANGE BETWEEN "
    "3 PRECEDING AND 2 FOLLOWING) AS s, dense_rank() OVER (PARTITION BY g "
    "ORDER BY k DESC) AS dr, lag(v, 2) OVER (PARTITION BY g ORDER BY k, rid) "
    "AS l2 FROM r ORDER BY rid",
])
def test_window_sql_matches_reference(conns, sql):
    assert_same(conns, sql)


@pytest.mark.parametrize("sql,text", [
    ("SELECT sum(v) OVER (ORDER BY k, rid RANGE BETWEEN 2 PRECEDING AND "
     "CURRENT ROW) AS s FROM r", "exactly one ORDER BY key"),
    ("SELECT sum(v) OVER (ORDER BY f RANGE BETWEEN 2 PRECEDING AND CURRENT "
     "ROW) AS s FROM r", "integer-ordered key"),
])
def test_range_offset_frames_are_checked(conns, sql, text):
    ref, port = conns
    for c in (ref, port):
        with pytest.raises(ValueError, match=text):
            c.sql(sql).strings()


def test_window_with_aggregate_rejected(conns):
    with pytest.raises(Exception, match="window"):
        conns[1].sql("SELECT g, sum(x) AS s, row_number() OVER (ORDER BY g) "
                     "AS rn FROM t GROUP BY g")


def _brute_frame(g, k, v, lo, hi, mode, agg):
    """The reference test's numpy oracle: each row's frame within its
    partition (rows ordered by k)."""
    n = len(v)
    out = [None] * n
    order = np.lexsort((k, g))
    for gi in set(g.tolist()):
        idx = [i for i in order if g[i] == gi]
        for p, i in enumerate(idx):
            if mode == "rows":
                a = 0 if lo is None else max(0, p + lo)
                b = len(idx) - 1 if hi is None else min(len(idx) - 1, p + hi)
                sel = idx[a:b + 1] if b >= a else []
            else:
                klo = -10**18 if lo is None else k[i] + lo
                khi = 10**18 if hi is None else k[i] + hi
                sel = [j for j in idx if klo <= k[j] <= khi]
            vals = [v[j] for j in sel]
            if agg == "count":
                out[i] = len(vals)
            elif vals:
                out[i] = {"sum": sum, "min": min, "max": max}[agg](vals)
    return out


@pytest.mark.parametrize("mode,lo,hi,agg,seed", [
    ("rows", -2, 3, "sum", 0), ("rows", -4, 1, "min", 1),
    ("rows", -1, 4, "max", 2), ("rows", 1, 3, "sum", 3),
    ("rows", 1, 2, "min", 4), ("rows", -1, None, "sum", 5),
    ("range", -5, 5, "sum", 6), ("range", -10, 0, "min", 7),
    ("range", 0, 8, "count", 8), ("rows", -3, 0, "count", 9)])
def test_frames_match_oracle_and_reference(mode, lo, hi, agg, seed):
    rng = np.random.default_rng(seed)
    n = 500
    g, k, v = (rng.integers(0, 7, n), rng.integers(0, 50, n),
               rng.integers(-100, 100, n))
    cols = {"g": g, "k": k, "v": v, "rid": np.arange(n, dtype=np.int64)}
    ref, port = RefConnection(), Connection(device="cpu")
    ref.register_numpy("t", cols)
    port.register_numpy("t", cols)

    def bound(x, word):
        if x is None:
            return f"UNBOUNDED {word}"
        if x == 0:
            return "CURRENT ROW"
        return f"{-x} PRECEDING" if x < 0 else f"{x} FOLLOWING"

    sql = (f"SELECT rid, {agg}(v) OVER (PARTITION BY g ORDER BY k "
           f"{mode.upper()} BETWEEN {bound(lo, 'PRECEDING')} AND "
           f"{bound(hi, 'FOLLOWING')}) AS w FROM t ORDER BY rid")
    rows = assert_same((ref, port), sql)
    got = [None if r[1] == "NULL" else int(r[1]) for r in rows]
    assert got == _brute_frame(g, k, v, lo, hi, mode, agg)
