"""db-benchmark's group-by questions on the port, held row for row against
the plain reference (`tpchbench/h2o_reference.py`) at N = 1e5, K = 100;
the aggregates they brought (median / quantile_cont on every grouping
route and ungrouped, corr), out-of-core passes against the in-core answer,
the counters and the span; and the byte-ranking path of `encode_strings`
against `np.unique`."""

import math

import numpy as np
import pytest
import torch

from duckdb_cubit_tpu_torch.api import connect
from duckdb_cubit_tpu_torch.exec import profiler as PROF
from duckdb_cubit_tpu_torch.storage import table as T
from test_torch_staged import one_intra_op_thread  # noqa: F401
from tpchbench import h2o_reference as ref
from tpchbench.suites import h2o

N, K = 100_000, 100
# the engine's DOUBLEs against the reference's (both float64, summed in
# other orders): the benchmark's own limit
GAP = 1e-10


@pytest.fixture(scope="module")
def x():
    return h2o.generate(N, K, 2**31 + 23)["x"]


def _connect(x, **settings):
    conn = connect(None, device="cpu")
    conn.register_numpy("x", {c: np.array(a) for c, a in x.items()})
    for k, v in settings.items():
        conn.sql(f"SET {k} = {v}")
    return conn


@pytest.fixture(scope="module")
def conn(x):
    return _connect(x)


@pytest.fixture(scope="module")
def answers(x):
    data = ref.load(x, "cpu")
    return {n: ref.answer(n, data) for n in h2o.QUESTIONS}


def _text(name, v) -> str:
    if name in ("id1", "id2"):
        return "id%03d" % v
    if name == "id3":
        return "id%010d" % v
    return str(int(v))


def _cells_equal(got: str, want, kind: str) -> bool:
    if kind == "x":
        return got == want
    if want is None:
        return got == "NULL"
    g = float(got)
    return abs(g - want) <= GAP * abs(want) if want else g == 0.0


def _reference_rows(n, ans):
    """The reference's answer as {key cells: value cells}, with each value
    column's kind."""
    keys, chk = ref.QUESTIONS[n]
    # the value columns are the checksum's, in the select list's order
    values = [c for c, _ in chk]
    kinds = [k for _, k in chk]
    if n == 8:
        # an id6 partition's two values, in either order
        rows = {}
        for k, v in zip(ans["id6"].tolist(), ans["largest2_v3"].tolist()):
            rows.setdefault((str(k),), []).append(v)
        return {k: sorted(v) for k, v in rows.items()}, ["f"]
    rows = {}
    for i in range(len(ans[keys[0]])):
        key = tuple(_text(k, int(ans[k][i])) for k in keys)
        vals = []
        for c, kind in zip(values, kinds):
            v = float(ans[c][i])
            vals.append(None if math.isnan(v) else (
                str(int(v)) if kind == "x" else v))
        rows[key] = vals
    return rows, kinds


@pytest.mark.parametrize("n", sorted(h2o.QUESTIONS))
def test_each_question_matches_the_reference_row_for_row(conn, answers, n):
    keys, _ = ref.QUESTIONS[n]
    want, kinds = _reference_rows(n, answers[n])
    got_rows = conn.sql(h2o.QUESTIONS[n]).strings()
    assert len(got_rows) == sum(len(v) for v in want.values()) \
        if n == 8 else len(want)
    if n == 8:
        got = {}
        for k, v in got_rows:
            got.setdefault((k,), []).append(float(v))
        assert got.keys() == want.keys()
        for k, vs in want.items():
            assert sorted(got[k]) == vs, k
        return
    for row in got_rows:
        key, vals = tuple(row[:len(keys)]), row[len(keys):]
        assert key in want, key
        for g, w, kind in zip(vals, want[key], kinds):
            assert _cells_equal(g, w, kind), (key, g, w)


@pytest.mark.parametrize("n", sorted(h2o.QUESTIONS))
def test_each_checksum_statement_matches_the_reference(conn, answers, n):
    row, = conn.sql(h2o.statement(n)).strings()
    want = ref.checksum(n, answers[n])
    kinds = "x" + "".join(t[3] for t in ref.terms(n))
    assert len(row) == len(want) == len(kinds)
    for g, w, kind in zip(row, want, kinds):
        assert _cells_equal(g, str(w) if kind == "x" else w, kind), (g, w)


@pytest.mark.parametrize("n", [6, 8, 10])
def test_out_of_core_passes_give_the_in_core_answer(x, conn, n):
    ext = _connect(x, force_external="true")
    want = sorted(conn.sql(h2o.QUESTIONS[n]).strings())
    got = sorted(ext.sql(h2o.QUESTIONS[n]).strings())
    assert len(got) == len(want)
    doubles = {6: (2, 3), 8: (1,), 10: (6,)}[n]
    for g, w in zip(got, want):
        for i, (a, b) in enumerate(zip(g, w)):
            if i in doubles and "NULL" not in (a, b):
                assert abs(float(a) - float(b)) <= GAP * abs(float(b))
            else:
                assert a == b
    # question 10's sum and count split into passes; a median declines
    passes = ext.executor.external_passes
    ext.sql(h2o.QUESTIONS[n]).strings()
    ran = ext.executor.external_passes - passes
    assert (ran > 0) == (n == 10), ran


# ------------------------------------------------- median, quantile_cont

def _quantile(values, p):
    """DuckDB's quantile_cont: position (n - 1) p, interpolated."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if len(v) == 0:
        return None
    pos = (len(v) - 1) * p
    lo, hi = math.floor(pos), math.ceil(pos)
    return v[lo] + (pos - lo) * (v[hi] - v[lo])


@pytest.fixture(scope="module")
def small():
    """t: a dense key `g` (7 values), a wide key `s` (sort route), a
    foreign key `f` into `dim`, an integer `v` (0 read as NULL) and a
    DOUBLE `d`; groups of even and odd sizes, and g = 6 all NULL."""
    rng = np.random.default_rng(5)
    n = 3_001
    g = rng.integers(0, 7, n).astype(np.int32)
    v = rng.integers(1, 50, n).astype(np.int32)
    v[g == 6] = 0
    v[rng.random(n) < 0.1] = 0
    t = {"g": g, "s": (rng.integers(0, 40, n) * 1_000_003).astype(np.int64),
         "f": rng.integers(1, 30, n).astype(np.int32), "v": v,
         "d": rng.normal(size=n)}
    c = connect(None, device="cpu")
    c.register_numpy("t", t)
    c.register_numpy("dim", {"k": np.arange(1, 31, dtype=np.int32)})
    c.sql("CREATE UNIQUE INDEX ON dim(k)")
    c.catalog.register_foreign_key("f", "dim", "k")
    return c, t


@pytest.mark.parametrize("key,route", [("g", "group_rows_dense"),
                                       ("f", "group_rows_fk"),
                                       ("s", "group_rows_sort")])
@pytest.mark.parametrize("p", [0.5, 0.0, 0.3, 1.0])
def test_quantiles_on_every_grouping_route(small, key, route, p):
    c, t = small
    fn = "median(nullif(v, 0))" if p == 0.5 else \
        f"quantile_cont(nullif(v, 0), {p})"
    before = PROF.snapshot()
    rows = c.sql(f"SELECT {key}, {fn} AS q, median(d) AS m FROM t "
                 f"GROUP BY {key}").strings()
    after = PROF.snapshot()
    assert after[route] - before[route] > 0
    assert after["median_rows"] - before["median_rows"] >= 2 * len(t["v"])
    others = {"group_rows_dense", "group_rows_fk", "group_rows_sort"} - {
        route}
    assert all(after[r] == before[r] for r in others)
    keys = np.unique(t[key])
    assert len(rows) == len(keys)
    sizes = set()
    for k, q, m in rows:
        at = t[key] == int(k)
        vals = t["v"][at]
        want = _quantile(vals[vals != 0], p)
        sizes.add(int((vals != 0).sum()) % 2)
        if want is None:
            assert q == "NULL"
        else:
            assert abs(float(q) - want) <= 1e-12 * abs(want), (k, q, want)
        assert abs(float(m) - _quantile(t["d"][at], 0.5)) <= 1e-12
    # groups of odd and of even counts were both met
    assert sizes == {0, 1} or key == "g"


def test_the_dense_route_meets_an_all_null_group(small):
    c, t = small
    rows = dict(c.sql("SELECT g, median(nullif(v, 0)) FROM t GROUP BY g")
                .strings())
    assert rows["6"] == "NULL"
    assert {k for k, v in rows.items() if v != "NULL"} == {str(i) for i in
                                                           range(6)}


def test_ungrouped_quantiles(small):
    c, t = small
    v = t["v"][t["v"] != 0]
    (med, q1, md), = c.sql("SELECT median(nullif(v, 0)), "
                           "quantile_cont(v, 0.25), median(d) FROM t"
                           ).strings()
    assert float(med) == pytest.approx(_quantile(v, 0.5), rel=1e-12)
    assert float(q1) == pytest.approx(_quantile(t["v"], 0.25), rel=1e-12)
    assert float(md) == pytest.approx(_quantile(t["d"], 0.5), rel=1e-12)
    # an odd count's median is its middle value, an even count's the mean
    # of its two middle values
    live = t["v"] > 0
    by_d = t["v"][live][np.argsort(t["d"][live])]
    for rows in (7, 8):
        (got,), = c.sql(f"SELECT median(v) FROM (SELECT v, d FROM t WHERE v > 0 "
                        f"ORDER BY d LIMIT {rows}) AS s").strings()
        w = np.sort(by_d[:rows])
        mid = w[3] if rows == 7 else (w[3] + w[4]) / 2
        assert float(got) == mid


def test_a_quantile_fraction_must_be_a_constant_in_0_1(small):
    c, _ = small
    for bad in ("quantile_cont(v, 1.5)", "quantile_cont(v, g)",
                "quantile_cont(v)", "median(v, 0.5)"):
        with pytest.raises(ValueError):
            c.sql(f"SELECT {bad} FROM t").strings()


def test_the_median_span_and_its_attributes(small):
    c, t = small
    PROF.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        c.sql("SELECT g, median(v) FROM t GROUP BY g").strings()
    spans = [s for s in PROF.spans() if s[0] == "db.agg.median"]
    assert len(spans) == 1
    assert spans[0][5] == {"rows": len(t["v"]) + (-len(t["v"]) % 8192),
                           "groups": 7}
    root, = [s for s in PROF.spans() if s[0] == "db.sql"]
    assert root[5]["group_rows_dense"] > 0 and root[5]["median_rows"] > 0
    assert root[5]["group_rows_sort"] == root[5]["group_rows_fk"] == 0
    PROF.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_median_span_times_the_card(cuda_device):
    rng = np.random.default_rng(9)
    c = connect(None, device=cuda_device)
    c.register_numpy("t", {"g": rng.integers(0, 7, 100_000).astype(np.int32),
                           "d": rng.normal(size=100_000)})
    q = "SELECT g, median(d) FROM t GROUP BY g"
    c.sql(q).strings()
    PROF.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        c.sql(q).strings()
    span, = [s for s in PROF.spans() if s[0] == "db.agg.median"]
    assert set(span[5]) == {"rows", "groups", "device_ms"}
    assert span[5]["device_ms"] > 0
    PROF.reset()


# ------------------------------------------------------------------ corr

def test_corr_against_numpy_and_its_null_cases(small):
    """corr(y, x) is the population covariance over the product of the
    population standard deviations; as the SQL standard's CORR (and
    PostgreSQL), NULL for a group of one row and for a group whose x or y
    does not vary."""
    c, t = small
    rows = dict((k, v) for k, v in c.sql(
        "SELECT g, corr(d, v) FROM t GROUP BY g").strings())
    for k in range(6):
        at = t["g"] == k
        want = np.corrcoef(t["d"][at], t["v"][at])[0, 1]
        assert float(rows[str(k)]) == pytest.approx(want, rel=1e-9)
    assert rows["6"] == "NULL"          # v is 0 on every row of g = 6
    single = c.sql("SELECT corr(v, d) FROM (SELECT v, d FROM t "
                   "ORDER BY d LIMIT 1) AS one").strings()
    assert single == [["NULL"]]
    flat = c.sql("SELECT corr(d, g) FROM t WHERE g = 3").strings()
    assert flat == [["NULL"]]
    # a pair counts only where both are non-NULL
    (pair,), = c.sql("SELECT corr(nullif(v, 0), d) FROM t WHERE g < 6"
                     ).strings()
    keep = (t["g"] < 6) & (t["v"] != 0)
    assert float(pair) == pytest.approx(
        np.corrcoef(t["v"][keep], t["d"][keep])[0, 1], rel=1e-9)


# --------------------------------------------------------- encode_strings

def _unique(values):
    d, c = np.unique(values, return_inverse=True)
    return c.astype(np.int32), d


def _same(got, want):
    return (np.array_equal(got[0], want[0]) and got[1].dtype == want[1].dtype
            and got[1].tobytes() == want[1].tobytes())


@pytest.mark.parametrize("width", [1, 5, 8, 12, 13, 20])
def test_ranking_bytes_is_np_unique(width):
    """Random bytes (NULs and bytes past 127 among them), NUL-padded short
    values and repeats: codes and dictionary byte for byte."""
    rng = np.random.default_rng(width)
    raw = rng.integers(0, 256, (60_000, width), dtype=np.uint8)
    raw[rng.random(raw.shape) < 0.2] = 0
    short = rng.random(len(raw)) < 0.3
    raw[short, width // 2:] = 0
    vals = raw.view(f"S{width}").ravel()
    vals = vals[rng.integers(0, len(vals) // 4, len(vals))]
    assert _same(T._rank_bytes(vals), _unique(vals))


def test_ranking_bytes_of_an_id_column_is_np_unique():
    rng = np.random.default_rng(2)
    ids = np.array([b"id%010d" % i for i in range(1, 20_001)], dtype="S12")
    vals = ids[rng.integers(0, len(ids), 200_000)]
    assert _same(T._rank_bytes(vals), _unique(vals))


@pytest.mark.parametrize("rows,distinct,ranked", [
    (T.PROBE_ROWS - 1, 5_000, False),   # short: np.unique
    (T.PROBE_ROWS, 900, False),         # the sample's probe takes it
    (T.PROBE_ROWS, 5_000, True),        # past the probe's limit: ranked
    (T.PROBE_ROWS + 7, 200_000, True)])
def test_encode_strings_either_side_of_the_probe(monkeypatch, rows, distinct,
                                                 ranked):
    rng = np.random.default_rng(rows + distinct)
    words = rng.integers(0, 256, (distinct, 12), dtype=np.uint8)
    words[:, 9:] = 0                     # values of 9 to 12 bytes
    words[: distinct // 2, 11] = 65
    vals = words.view("S12").ravel()[rng.integers(0, distinct, rows)]
    calls = []
    real = T._rank_bytes

    def spy(values, device=None):
        calls.append(len(values))
        return real(values, device)

    monkeypatch.setattr(T, "_rank_bytes", spy)
    assert _same(T.encode_strings(vals), _unique(vals))
    assert bool(calls) == ranked


def test_verification_legs_agree_on_the_new_aggregates(small):
    """The four legs of `enable_verification` (the row-by-row one computes
    quantile_cont in Python) agree on median, quantile_cont and corr."""
    c, _ = small
    c.sql("SET enable_verification = true")
    try:
        rows = c.sql("SELECT g, median(d), quantile_cont(v, 0.9), "
                     "corr(d, v) FROM t GROUP BY g").strings()
        legs = [name for name, _ in c.executor.last_legs]
    finally:
        c.sql("SET enable_verification = false")
    assert len(rows) == 7
    assert legs == ["production", "eager", "unoptimized", "row-by-row"]
