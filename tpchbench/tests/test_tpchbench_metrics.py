"""The metric readers' arithmetic on synthetic records, and the roofline's
frozen byte rules against the engine's own."""

import math

import numpy as np
import pytest
import torch

from tpchbench import roofline, run, trace


def _rec(latencies, window_s, refreshes=()):
    bench = run.load_benchmark()
    rec = run.Records(cell=bench["workloads"][0])
    rec.queries = [(1, t, t * 0.9, t * 0.1, 0) for t in latencies]
    rec.refreshes = list(refreshes)
    rec.window_s = window_s
    return rec


def read(name, rec):
    return run.load_reader(name)(rec)


def test_rate_tail_and_geomean():
    lat = [0.01] * 90 + [0.1] * 10
    rec = _rec(lat, window_s=sum(lat))
    assert read("qps", rec) == pytest.approx(100 / 1.9)
    assert read("query_p95_ms", rec) == pytest.approx(100.0)
    assert read("geomean_ms", rec) == pytest.approx(
        1000 * math.exp(0.9 * math.log(0.01) + 0.1 * math.log(0.1)))


def test_a_stall_moves_rate_tail_and_geomean():
    lat = [0.01] * 95 + [0.02] * 5
    calm = _rec(lat, sum(lat))
    stalled_lat = [0.01] * 90 + [0.5] * 5 + [0.02] * 5
    stall = _rec(stalled_lat, sum(stalled_lat))
    assert read("qps", stall) < read("qps", calm)
    assert read("query_p95_ms", stall) > read("query_p95_ms", calm)
    assert read("geomean_ms", stall) > read("geomean_ms", calm)


def test_refresh_means():
    rec = _rec([0.01], 10.0, refreshes=[("rf1", 1, 3.0, [], 0),
                                         ("rf2", 1, 1.0, [], 0),
                                         ("rf1", 2, 5.0, [], 1)])
    assert read("refresh_s", rec) == pytest.approx(3.0)
    assert read("rf1_s", rec) == pytest.approx(4.0)
    assert read("rf2_s", rec) == pytest.approx(1.0)


def test_readers_find_nothing_without_a_trace():
    rec = _rec([0.01, 0.02], 1.0)
    for name in ("device_idle_pct", "device_idle_pct.refresh", "sql_call_ms",
                 "render_ms", "q6_roofline", "q12_roofline"):
        assert read(name, rec) is None
    assert read("rf1_s", rec) is None and read("refresh_s", rec) is None


def _tr():
    s = 10**9
    return {"spans": [("window", 0, 10 * s), ("sql:q06", s, 2 * s),
                      ("strings:q06", 2 * s, 3 * s), ("sql:q06", 5 * s,
                                                     6 * s)],
            "device": [("k1", s + 10, s + 1010), ("copy", 2 * s, 2 * s + 500),
                       ("k1", 5 * s, 5 * s + 1000),
                       ("k1", 5 * s + 500, 5 * s + 1500),
                       ("other", 8 * s, 9 * s)]}


def test_trace_arithmetic():
    tr = _tr()
    assert trace.busy_s(tr) == pytest.approx((1000 + 500 + 1500 + 1e9) / 1e9)
    dev, runs = trace.device_s_in(tr, ("sql:q06", "strings:q06"))
    assert runs == 2 and dev == pytest.approx(3500 / 1e9)
    gaps = trace.idle_gaps(tr)
    assert gaps[0][1] == pytest.approx(3.0, rel=1e-6)   # 5 s .. 8 s
    assert trace.top_device_ops(tr)[0][0] == "other"


def test_idle_share_and_roofline_readers():
    rec = _rec([0.01], 10.0)
    rec.trace = _tr()
    idle = read("device_idle_pct", rec)
    assert idle == pytest.approx(100 * (1 - trace.busy_s(rec.trace) / 10))
    assert 0 < idle < 100


def test_scan_sum_bytes_is_the_engines_rule():
    from duckdb_cubit_tpu_torch.ops import bitmap as bm
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs
    rng = np.random.default_rng(3)
    for n, p in ((1000, 0.02), (8192 * 3 + 77, 0.3), (64, 0.0)):
        mask = rng.random(n) < p
        words = bm.pack_mask(torch.as_tensor(mask), bm.num_words(n))
        for k in (1, 2, 3):
            assert roofline.scan_sum_bytes(mask, k) == fs.scan_sum_bytes(
                words, n, k)


def test_gather_bytes_is_the_engines_rule():
    from duckdb_cubit_tpu_torch.ops import probe
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 5000, 3001).astype(np.int32)
    for k in (1, 2, 4):
        assert roofline.gather_bytes(keys, k) == probe.gather_bytes(
            torch.as_tensor(keys), k)


def test_share_is_bound_over_time():
    assert roofline.share_pct(3_350_000, 1e-6) == pytest.approx(100.0)
    assert roofline.share_pct(3_350_000, 1e-5) == pytest.approx(10.0)
    assert roofline.share_pct(1, 0.0) is None
