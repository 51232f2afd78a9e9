"""A configuration brings its own suite: schema, data, queries and
reference, found by the configuration's `suite` through `run.load_suite`.

The toy star under `tests/toy/` (a configuration, a mix and
`suites/toystar.py`, files alone) runs through `run.run_cell` on the CPU:
its engine is opened with `connect(None)`, `register_numpy` and CREATE
UNIQUE / CUBIT INDEX statements, and its window is held against its own
NumPy reference."""

import os

import numpy as np
import pytest

from tpchbench import control, run

TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy")
CELL = "toy-star.scan"
BENCH = {
    "workloads": [{"name": CELL, "config": "toy-star", "traffic": "toy-scan",
                   "chips": 1}],
    "end_to_end": [{"name": "geomean_ms", "unit": "ms"},
                   {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": "sql_call_ms", "unit": "ms"},
                  {"name": "frontend_ms", "unit": "ms"}],
}
SEED = 2**31 + 77


def _run(traced=False, seed=SEED):
    return run.run_cell(BENCH, CELL, seed, 0.3, traced, device="cpu",
                        base=TOY)


def test_the_default_suite_is_tpch():
    for name in ("tpch-sf1", "tpch-sf1-rf"):
        config = run.load_config(name)
        assert "suite" not in config
        assert run.load_suite(config).__file__ == os.path.join(
            run.HERE, "suites", "tpch.py")


def test_the_toy_star_probes_an_unsorted_key():
    config = run.load_config("toy-star", TOY)
    suite = run.load_suite(config, TOY)
    t = suite.tables(config, suite.scale(config))
    fk = t["fact"]["f_dkey"]
    keys = t["dim"]["d_key"]
    assert np.any(np.diff(fk) < 0) and np.any(np.diff(keys) < 0)
    assert np.array_equal(np.sort(keys), np.arange(1, len(keys) + 1))


# Seed 5 asks `f_qty < 45`, inside the last bin of `f_qty`'s `bins=8`
# index: the engine takes that whole bin (PERF.md, Open questions).
LAST_BIN_FAULT = pytest.mark.xfail(
    strict=False, reason="binned CUBIT index: a range ending inside the "
    "last bin takes the whole bin (PERF.md, Open questions)")


@pytest.mark.parametrize("seed", [SEED, 2, pytest.param(
    5, marks=LAST_BIN_FAULT)])
def test_a_suite_added_by_files_runs_correct(seed):
    res, rec = _run(seed=seed)
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert res["correct"] is True, res["compared"]
    assert res["compared"]["wrong_cells"]["value"] == 0
    assert res["compared"]["double_gap"]["value"] <= 1e-12
    assert {q[0] for q in rec.queries} == {1, 2}
    assert set(res["metrics"]) == {"geomean_ms", "setup_s"}


def test_a_traced_suite_run_names_its_spans_by_label():
    res, rec = _run(traced=True)
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert res["compared"]["wrong_cells"]["value"] == 0
    assert res["compared"]["double_gap"]["value"] <= 1e-12
    names = {s[0] for s in rec.trace["spans"]}
    assert {"sql:star1", "strings:star1", "sql:star2"} <= names
    assert set(res["metrics"]) <= {"sql_call_ms", "frontend_ms"}
    assert "sql_call_ms" in res["metrics"]


def test_a_reference_with_one_wrong_cell_is_not_correct(monkeypatch):
    config = run.load_config("toy-star", TOY)
    suite = run.load_suite(config, TOY)
    answer = suite.answer

    def one_wrong(n, db, p, low=False):
        a = answer(n, db, p, low)
        if n == 1:
            a.rows[0][1] = str(int(a.rows[0][1]) + 1)
        return a

    monkeypatch.setattr(suite, "answer", one_wrong)
    monkeypatch.setattr(run, "load_suite", lambda config, base=TOY: suite)
    res, _ = _run()
    assert res["correct"] is False
    assert res["compared"]["wrong_cells"]["value"] >= 1
    assert res["compared"]["double_gap"]["value"] <= 1e-12


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_the_toy_control_fails(seed):
    r = control.readings(CELL, seed, bench=BENCH, base=TOY)
    assert r["fails_limits"], r
    assert r["per_query"][2][1] > 1e-9
