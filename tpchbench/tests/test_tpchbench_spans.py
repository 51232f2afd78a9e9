"""The readers of the engine's own spans (`tpchbench/spans.py` and eight
metrics) on synthetic spans and a synthetic trace; None without a trace or
without the engine's recorder; each in a traced rehearsal of its cells."""

import json
import os
import subprocess
import sys

import pytest

from tpchbench import run, spans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NEW = ("frontend_ms", "host_wait_ms", "prepare_hit_pct", "dict_eval_ms",
       "operator_self_ms", "rf1_parse_s", "rf1_encode_s", "rf1_index_s")


def us(x):
    return int(x * 1000)


# the harness's spans (trace.collect's form) and the engine's
TRACE = {"device": [], "kinds": {},
         "spans": [("window", 0, us(10_000)),
                   ("sql:q13", us(100), us(2000)),
                   ("strings:q13", us(2000), us(2100)),
                   ("sql:q06", us(3000), us(4000)),
                   ("rf1", us(5000), us(9000))]}


def _s(name, a, b, parent, qid=1, attrs=None):
    return (name, us(a), us(b), parent, qid, attrs)


SPANS = [
    _s("db.sql", 110, 1990, -1, 1, {"prepare_hits": 1,
                                     "prepare_misses": 1}),   # 0
    _s("db.parse", 120, 220, 0),                              # 1
    _s("db.bind", 220, 320, 0),                               # 2
    _s("db.optimize", 320, 370, 0),                           # 3
    _s("db.prepare", 370, 400, 0, attrs={"hit": False}),      # 4
    _s("db.stage", 400, 1900, 0),                             # 5
    _s("db.op.hash_join", 400, 1800, 5),                      # 6
    _s("db.op.table_scan", 500, 1500, 6),                     # 7
    _s("db.dict.Like", 600, 1400, 7, attrs={"entries": 9}),   # 8
    _s("db.wait", 1600, 1650, 6, attrs={"what": "count"}),    # 9
    _s("db.format", 2010, 2090, -1, None),                    # 10
    _s("db.sql", 3010, 3990, -1, 2, {"prepare_hits": 2,
                                      "prepare_misses": 0}),  # 11
    _s("db.parse", 3020, 3120, 11, 2),                        # 12
    _s("db.dict.Substr", 3200, 3300, 11, 2),                  # 13
    _s("db.dict.StrMap", 3220, 3260, 13, 2),                  # 14
    _s("db.sql", 5010, 8990, -1, 3, {"prepare_hits": 0,
                                      "prepare_misses": 0}),  # 15
    _s("db.parse", 5020, 6020, 15, 3),                        # 16
    _s("db.insert.literals", 6020, 6520, 15, 3),              # 17
    _s("db.dml.encode", 6600, 7600, 15, 3),                   # 18
    _s("db.dml.cubit", 7600, 8100, 15, 3),                    # 19
    _s("db.dml.pk", 8100, 8300, 15, 3),                       # 20
    _s("py.gc", 8300, 8400, 15, 3),                           # 21
    # after the window: not read
    _s("db.sql", 20_000, 21_000, -1, 4, {"prepare_hits": 0,
                                          "prepare_misses": 50}),
    _s("db.parse", 20_010, 20_500, 22, 4),
]


def _rec(traced=True):
    rec = run.Records(cell=run.load_benchmark()["workloads"][0])
    rec.trace = TRACE if traced else None
    return rec


def read(name, rec):
    return run.load_reader(name)(rec)


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(spans, "program", lambda: list(SPANS))


def test_each_reader_on_synthetic_spans(synthetic):
    rec = _rec()
    ms = 1e-3    # one synthetic microsecond in milliseconds
    # two sql: spans; parse 100 + 100, bind 100, optimize 50
    assert read("frontend_ms", rec) == pytest.approx(350 * ms / 2)
    assert read("host_wait_ms", rec) == pytest.approx(50 * ms / 2)
    # LIKE 800 and substring 100; the map inside the substring once
    assert read("dict_eval_ms", rec) == pytest.approx(900 * ms / 2)
    # hash join 1400 less its scan 1000 and its wait 50; scan 1000 less
    # LIKE 800
    assert read("operator_self_ms", rec) == pytest.approx(550 * ms / 2)
    assert read("prepare_hit_pct", rec) == pytest.approx(75.0)
    # one rf1 span
    assert read("rf1_parse_s", rec) == pytest.approx(1500e-6)
    assert read("rf1_encode_s", rec) == pytest.approx(1000e-6)
    assert read("rf1_index_s", rec) == pytest.approx(700e-6)


def test_spans_are_held_by_the_harness_span_at_their_start(synthetic):
    h = spans.held(_rec())
    names = [h.harness[k][0] if k is not None and k >= 0 else k
             for k in h.holder]
    assert names[:10] == ["sql:q13"] * 10
    assert names[10] == "strings:q13"
    assert names[11:15] == ["sql:q06"] * 4
    assert names[15:22] == ["rf1"] * 7
    assert names[22:] == [None, None]
    assert spans.runs(h, "sql:") == 2 and spans.runs(h, "rf1") == 1


def test_readers_find_nothing_without_a_trace(synthetic):
    for name in NEW:
        assert read(name, _rec(traced=False)) is None


def test_readers_find_nothing_without_the_recorder(monkeypatch):
    """On an engine that records no spans (an older one) every reader
    returns None and none raises."""
    from duckdb_cubit_tpu_torch.exec import profiler
    monkeypatch.delattr(profiler, "spans")
    assert spans.program() is None
    for name in NEW:
        assert read(name, _rec()) is None
    monkeypatch.undo()
    monkeypatch.setattr(spans, "program", lambda: [])
    for name in NEW:
        assert read(name, _rec()) is None


def test_readers_of_a_kind_of_run_the_window_lacks(synthetic, monkeypatch):
    """A power window has no rf1 span: the refresh readers give None."""
    monkeypatch.setitem(TRACE, "spans", TRACE["spans"][:4])
    rec = _rec()
    for name in ("rf1_parse_s", "rf1_encode_s", "rf1_index_s"):
        assert read(name, rec) is None
    assert read("frontend_ms", rec) is not None


def test_each_new_metric_is_declared_for_its_cells():
    bench = run.load_benchmark()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = by_name[name]
        assert m["workloads"] and m["moves"] in ("geomean_ms", "refresh_s")
    assert by_name["prepare_hit_pct"]["workloads"] == [
        "tpch-sf1.power", "tpch-sf1-rf.power-test"]


REHEARSE = ("import json, sys\n"
            "from tpchbench import run\n"
            "res, rec = run.run_cell(run.load_benchmark(), sys.argv[1], "
            "int(sys.argv[2]), 0.5, True, device='cpu', sf=0.01)\n"
            "print(json.dumps(res))\n")


@pytest.mark.parametrize("cell", ["tpch-sf1.power",
                                  "tpch-sf1-rf.power-test"])
def test_a_traced_rehearsal_prints_each_new_metric(cell):
    p = subprocess.run([sys.executable, "-c", REHEARSE, cell,
                        str(2**31 + 101)], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    bench = run.load_benchmark()
    want = {m["name"] for m in bench["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]}
    assert want and want <= set(res["metrics"])
    for name in want:
        assert res["metrics"][name]["value"] >= 0


def test_the_split_attributes_idle_time_to_the_innermost_span(synthetic,
                                                              monkeypatch):
    """`tpchbench.split` on the synthetic spans, with the card busy in
    [1000, 1200) us of q13 and nowhere else."""
    from tpchbench import split

    monkeypatch.setitem(TRACE, "device", [("k", us(1000), us(1200))])
    out = split.split(_rec())
    assert out["clock"] == {"roots": 3, "held": 3, "wholly_inside": 3,
                            "max_overhang_us": 0.0}
    q13 = {row[0]: row[1:] for row in out["queries"]["q13"]["spans"]}
    # LIKE is innermost over [600, 1400): 800 us of host time, 600 idle
    assert q13["db.dict.Like"][:2] == pytest.approx([0.8, 0.6])
    assert q13["db.op.table_scan"][:2] == pytest.approx([0.2, 0.2])
    # the harness's q13 spans: 1900 + 100 us, each with 10 us at either
    # end that no engine span covers
    assert out["queries"]["q13"]["ms_per_run"] == pytest.approx(2.0)
    assert q13["-"][0] == pytest.approx(0.04)
    # idle in sql: spans, 2700 us: 40 under no engine span, 880 under the
    # roots alone (q13's 100, q06's 780), the rest below them
    sql = out["idle.sql"]
    assert sql["idle_s"] == pytest.approx(2700e-6)
    top = dict(sql["top"])
    assert top["db.sql"] == pytest.approx(880e-6)
    assert top["db.dict.Like"] == pytest.approx(600e-6)
    assert sql["below_root_pct"] == pytest.approx(100 * 1780 / 2700)
    (rf1,) = out["rf1"]
    assert rf1["spans_s"]["db.dml.encode"] == pytest.approx(1000e-6)
    assert rf1["gc_by_generation"] == {0: 1, 1: 0, 2: 0}
    # roots without a kind: 10, 4 and 7 spans
    assert out["spans_per_statement"]["other"] == [4, 7.0, 10]
