"""db-benchmark's group-by suite (`suites/h2o.py`): its data against
groupby-datagen.R's rules, the cell through `run.run_cell` on the CPU at
N = 1e5, its float32 control, its readers, and a mis-grouped answer
caught by the checksum."""

import numpy as np
import pytest

from tpchbench import control, h2o_roofline, run, spans
from tpchbench import h2o_reference as ref
from tpchbench.suites import h2o

CELL = "h2o-groupby-1e8.questions"
N = 100_000


def _run(seed, traced=False):
    return run.run_cell(run.load_benchmark(), CELL, seed, 0.5, traced,
                        device="cpu", sf=N)


def test_the_data_follows_groupby_datagen():
    """N rows, K = 100: id1 and id2 over "id001".."id100", id3 over
    "id0000000001".."id{N/K}", id4 and id5 over 1..K, id6 over 1..N/K, v1
    1..5, v2 1..15, v3 in [0, 100] with at most 6 decimals; every column
    drawn uniformly, and the seed decides the draw."""
    n, k = 400_000, 100
    x = h2o.generate(n, k, 2**31 + 3)["x"]
    assert all(len(a) == n for a in x.values())
    small = {b"id%03d" % i for i in range(1, k + 1)}
    for c in ("id1", "id2"):
        assert x[c].dtype == "S5" and set(np.unique(x[c]).tolist()) == small
    assert x["id3"].dtype == "S12"
    ids3 = np.unique(x["id3"])
    assert ids3[0] == b"id0000000001" and ids3[-1] == b"id%010d" % (n // k)
    assert len(ids3) > 0.98 * (n // k)
    for c, hi in (("id4", k), ("id5", k), ("id6", n // k), ("v1", 5),
                  ("v2", 15)):
        a = x[c]
        assert a.dtype == np.int32 and a.min() == 1 and a.max() == hi, c
        # uniform: each value's count within 5 standard deviations
        counts = np.bincount(a)[1:]
        assert np.abs(counts - n / hi).max() < 5 * np.sqrt(n / hi), c
    v3 = x["v3"]
    assert v3.dtype == np.float64 and 0 <= v3.min() and v3.max() <= 100
    assert np.array_equal(np.round(v3, 6), v3)
    assert len(np.unique(v3)) > 0.99 * n
    assert abs(v3.mean() - 50) < 0.5
    again, other = (h2o.generate(n, k, s)["x"] for s in (2**31 + 3, 4))
    assert all(np.array_equal(x[c], again[c]) for c in x)
    assert not np.array_equal(x["id6"], other["id6"])


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 3_000_000_019])
def test_the_cell_runs_correct(seed):
    res, rec = _run(seed)
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 10
    assert res["compared"]["wrong_cells"]["value"] == 0
    assert {q[0] for q in rec.queries} == set(h2o.QUESTIONS)
    assert set(res["metrics"]) == {"geomean_ms", "setup_s"}


def test_a_traced_run_reads_the_new_metrics():
    res, rec = _run(2**31 + 77, traced=True)
    assert res["correct"] is True, res["compared"]
    names = {s[0] for s in rec.trace["spans"]}
    assert {"sql:h2o01", "strings:h2o10"} <= names
    # at N = 1e5 id6 has a domain of 1,000 values and groups densely;
    # question 10 alone takes the sort route, once a cycle
    got = res["metrics"]
    assert got["group_sort_pct.h2o"] == {"value": pytest.approx(100 / 9),
                                         "unit": "%"}
    assert got["operator_self_ms.h2o"]["value"] > 0
    # a CPU run has no device trace and no device time in the median's
    # spans; with them the idle share, the median's device ms and the
    # roofline share read
    for name in ("h2o10_roofline", "median_ms.h2o", "device_idle_pct.h2o"):
        assert name not in got, name
    recorded = spans.program()
    medians = [i for i, s in enumerate(recorded) if s[0] == "db.agg.median"]
    assert medians
    timed = [(*s[:5], {**(s[5] or {}), "device_ms": 2.5})
             if s[0] == "db.agg.median" else s for s in recorded]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spans, "program", lambda: timed)
        h = spans.held(rec)
        runs = spans.runs(h, "sql:h2o06")
        held = sum(1 for i in medians if h.holder[i] is not None
                   and h.holder[i] >= 0
                   and h.harness[h.holder[i]][0] == "sql:h2o06")
        assert runs > 0 and held >= runs
        assert run.load_reader("median_ms.h2o")(rec) == \
            pytest.approx(2.5 * held / runs)
    q10 = [s for s in rec.trace["spans"] if s[0] == "sql:h2o10"]
    rec.trace["device"] = sorted((f"k{i}", s[1], s[1] + 1_000_000)
                                 for i, s in enumerate(q10))
    share = run.load_reader("h2o10_roofline")(rec)
    want = 100 * h2o_roofline.h2o10_bytes(rec.db["x"]) / 3.35e12 / 1e-3
    assert share == pytest.approx(want)


def test_the_readers_find_nothing_without_a_trace():
    rec = run.Records(cell={"name": CELL})
    for name in ("group_sort_pct.h2o", "median_ms.h2o", "h2o10_roofline",
                 "device_idle_pct.h2o", "operator_self_ms.h2o"):
        assert run.load_reader(name)(rec) is None


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_the_float32_control_is_not_correct(seed):
    r = control.readings(CELL, seed, sf=N)
    assert r["fails_limits"] and r["double_gap"] > 1e-9, r


def test_stored_widths_are_the_engines():
    from duckdb_cubit_tpu_torch.api import connect

    x = h2o.generate(N, 100, 11)["x"]
    conn = connect(None, device="cpu")
    conn.register_numpy("x", {c: np.array(a) for c, a in x.items()})
    t = conn.catalog.table("x")
    for c in h2o_roofline.Q10_COLUMNS:
        assert h2o_roofline.stored_width(x[c]) == \
            t.columns[c].data.element_size(), c
    # id3's codes: int16 here (1,000 values), int32 at 1e8 rows
    assert h2o_roofline.stored_width(x["id3"]) == 2
    assert h2o_roofline.stored_width(np.arange(40_000).astype("S8")) == 4


def test_each_statement_wraps_its_question_in_the_checksum():
    assert h2o.statement(10) == (
        "SELECT count(*) AS out_rows, sum(v3) AS v3, sum(count) AS count, "
        "sum(v3 * v3) AS v3_v3, sum(v3 * id4) AS v3_id4, "
        "sum(v3 * id5) AS v3_id5, sum(v3 * id6) AS v3_id6, "
        "sum(count * count) AS count_count, sum(count * id4) AS count_id4, "
        "sum(count * id5) AS count_id5, sum(count * id6) AS count_id6 "
        "FROM (" + h2o.QUESTIONS[10] + ") AS ans")
    assert h2o.statement(1) == (
        "SELECT count(*) AS out_rows, sum(v1) AS v1, sum(v1 * v1) AS v1_v1 "
        "FROM (" + h2o.QUESTIONS[1] + ") AS ans")
    t = h2o.Traffic(run.load_mix("questions"), N, 1)
    assert [s[1] for s in t.cycle(0)] == list(range(1, 11))
    assert t.warmup() == t.cycle(5)
    assert [t.label(n) for n in (1, 10)] == ["h2o01", "h2o10"]


def _misgrouped(n, ans):
    """Question n's answer with rows moved between two of its groups, the
    group count and every db-benchmark checksum column's total kept."""
    out = {c: v.clone() for c, v in ans.items()}
    if n == 1:
        # one row of v1 = 3 leaves group 0 for group 1
        out["v1"][0] -= 3
        out["v1"][1] += 3
    else:
        # question 10's groups are single rows: two of them, with other
        # id4, id5 and id6, trade their rows' v3 (and so their rows)
        i = 0
        j = next(j for j in range(1, len(out["v3"]))
                 if all(out[k][j] != out[k][i] for k in ref.INT_KEYS))
        out["v3"][[i, j]] = out["v3"][[j, i]]
    return out


@pytest.mark.parametrize("n", [1, 10])
def test_a_misgrouped_answer_is_not_correct(n):
    """Rows moved between groups keep db-benchmark's own checksum (the
    column totals, the row count) but not the squares or the key-weighted
    sums: `verify` finds the answer wrong."""
    x = h2o.generate(20_000, 100, 2**31 + 41)["x"]
    db = {"x": x, "data": ref.load(x, "cpu"), "rows": {}}
    ans = ref.answer(n, db["data"])
    bad = ref.checksum(n, _misgrouped(n, ans))
    good = ref.checksum(n, ans)
    own = 1 + len(ref.QUESTIONS[n][1])
    assert bad[:own] == pytest.approx(good[:own], rel=1e-12)
    got = [[str(v) if k == "x" else v for v, k in
            zip(bad, "x" + "".join(t[3] for t in ref.terms(n)))]]
    traffic = h2o.Traffic({"order": [n]}, 20_000, 1)
    res = h2o.verify(db, traffic, 20_000, 1, 1, {(0, n): [got]}, 1, [])
    assert res["wrong_cells"] > 0 or res["double_gap"] > 1e-10, res
    fine = h2o.verify(db, traffic, 20_000, 1, 1,
                      {(0, n): [h2o.answer(n, db).rows]}, 1, [])
    assert fine == {"wrong_cells": 0, "double_gap": 0.0}
