"""The Star Schema Benchmark's suite (`suites/ssb.py`) through
`run.run_cell` on the CPU at SF 0.01, its control, its data against the
specification's filter factors at SF 1, and its roofline byte rules."""

import numpy as np
import pytest

from tpchbench import control, roofline, run, ssb_roofline
from tpchbench.suites import ssb

CELL = "ssb-sf20.flights"


def _run(seed, traced=False):
    return run.run_cell(run.load_benchmark(), CELL, seed, 0.5, traced,
                        device="cpu", sf=0.01)


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 3_000_000_019])
def test_the_cell_runs_correct(seed):
    res, rec = _run(seed)
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 13
    assert res["compared"]["wrong_cells"]["value"] == 0
    assert {q[0] for q in rec.queries} == set(ssb.TEXTS)
    assert set(res["metrics"]) == {"geomean_ms", "setup_s"}


def test_a_traced_run_reads_the_sort_probe_share_and_no_device_metric():
    res, rec = _run(2**31 + 77, traced=True)
    assert res["correct"] is True, res["compared"]
    names = {s[0] for s in rec.trace["spans"]}
    assert {"sql:ssb11", "strings:ssb43"} <= names
    # a CPU run has no device trace: the device metrics are left out; the
    # host layers' readers read the engine's spans and the host clock
    assert res["metrics"]["sort_probe_pct.ssb"] == {"value": 0.0,
                                                    "unit": "%"}
    assert set(res["metrics"]) == {"sort_probe_pct.ssb", "sql_call_ms.ssb",
                                   "host_wait_ms.ssb",
                                   "operator_self_ms.ssb"}
    for name in ("sql_call_ms.ssb", "operator_self_ms.ssb"):
        assert res["metrics"][name]["value"] > 0, name
    assert res["metrics"]["host_wait_ms.ssb"]["value"] >= 0


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_the_float32_control_is_not_correct(seed):
    r = control.readings(CELL, seed, sf=0.01)
    assert r["fails_limits"] and r["wrong_cells"] > 0, r


def test_the_data_follows_the_seed():
    a, b, c = ssb.generate(0.01, 5), ssb.generate(0.01, 5), \
        ssb.generate(0.01, 6)
    for t in a:
        for col in a[t]:
            assert np.array_equal(a[t][col], b[t][col])
    assert not np.array_equal(a["lineorder"]["lo_partkey"][:100],
                              c["lineorder"]["lo_partkey"][:100])


def test_a_holder_is_filled_by_the_traffic():
    t = ssb.tables({}, 0.01)
    mix = run.load_mix("flights")
    ssb.traffic({}, mix, 0.01, 42)
    assert t._data is not None
    assert np.array_equal(t["part"]["p_partkey"],
                          ssb.generate(0.01, 42)["part"]["p_partkey"])


def test_selectivities_at_sf1_meet_the_specs_filter_factors():
    """O'Neil et al., section 3: Q1.1 0.019, Q2.1 1/125, Q3.1 0.034, Q4.1
    0.016 of lineorder's rows, each within 10%.  Q3.1's 0.034 takes six of
    seven years as 6/7; order dates end on 1998-08-02 (TPC-H's rule, which
    the specification keeps), so six whole years are 2,192 of 2,406 days,
    and the factor is held to that share (0.0364).  Its other factors are
    the shares of ASIA among 2,000 suppliers and 30,000 customers, whose
    nations are drawn at random: about 5% of spread at SF 1."""
    db = ssb.reference({}, ssb.generate(1.0, 2**31 + 1), 1.0)
    n = len(db["tables"]["lineorder"]["lo_orderkey"])
    assert 5_900_000 < n < 6_100_000
    got = {11: len(ssb._mask(db, ssb._Q1[11])) / n}
    for q in (21, 31, 41):
        got[q] = len(ssb._mask(db, ssb._GROUPED[q][0])) / n
    years = 2192 / ssb.ORDER_DAYS
    for q, ff in {11: 0.019, 21: 1 / 125, 31: 0.034 / (6 / 7) * years,
                  41: 0.016}.items():
        assert abs(got[q] / ff - 1) < 0.10, (q, got[q], ff)


def test_probe_bytes_is_gather_bytes_less_the_keys():
    rng = np.random.default_rng(8)
    keys = rng.integers(19920101, 19981230, 30_001).astype(np.int32)
    for t in (1, 2, 3):
        assert ssb_roofline.probe_bytes(keys, t) == \
            roofline.gather_bytes(keys, t) - 4 * len(keys)
    assert ssb_roofline.probe_bytes(keys[:0], 2) == 0


def test_the_roofline_byte_rules_count_what_reaches_each_step():
    db = ssb.reference({}, ssb.generate(0.01, 4), 0.01)
    lo = db["tables"]["lineorder"]
    n = len(lo["lo_orderkey"])
    b11, b41 = ssb_roofline.ssb11_bytes(db), ssb_roofline.ssb41_bytes(db)
    # Q1.1 reads less than its three fact columns whole; Q4.1 at least
    # lo_custkey whole and its probe's two outputs, and less than its six
    # fact columns whole and every probe's outputs at every row
    assert ssb_roofline.sectors(np.flatnonzero(
        (lo["lo_discount"] >= 1) & (lo["lo_discount"] <= 3))) // 2 < b11
    assert b11 < 3 * 4 * n
    assert 4 * n + 8 * n < b41 < 6 * 4 * n + 6 * 4 * n + 32 * 6 * n
    assert ssb_roofline.sectors(np.arange(n)) == 4 * ((n + 7) // 8) * 8


@pytest.mark.parametrize("share", [0.001, 0.05, 0.5])
def test_sectors_at_sorted_rows_is_scan_sum_bytes_less_the_words(share):
    mask = np.random.default_rng(11).random(100_003) < share
    assert ssb_roofline.sectors(np.flatnonzero(mask)) == \
        roofline.scan_sum_bytes(mask, 1) - 4 * ((len(mask) + 31) // 32)
    assert ssb_roofline.sectors(np.flatnonzero(mask[:0])) == 0
