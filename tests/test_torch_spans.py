"""The engine's span recorder (`duckdb_cubit_tpu_torch/exec/profiler.py`):
on exactly while torch.profiler records, spans on the profiler's clock with
their parents, one query id a statement and the counters' deltas on the
statement's root, closed by exceptions, bounded.  SF0.01 on the CPU."""

import gc
from collections import OrderedDict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from duckdb_cubit_tpu_torch.api import Connection, QueryTimeoutError, connect
from duckdb_cubit_tpu_torch.config import EngineConfig
from duckdb_cubit_tpu_torch.exec import profiler as PROF
from duckdb_cubit_tpu_torch.exec.executor import Executor
from duckdb_cubit_tpu_torch.ops import probe
from duckdb_cubit_tpu_torch.plan import physical as P
from duckdb_cubit_tpu_torch.tpch.load import load_catalog
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL

# the benchmark's own span names, which no program span may start with
HARNESS = ("window", "sql:", "strings:", "rf1", "rf2")

ORDER = ("(60001, 1, 'O', 1234.56, '1996-01-02', '5-LOW', "
         "'Clerk#000000951', 0, 'a comment no order had before')")
LINES = ("(60001, 1, 1, 1, 17.00, 1234.56, 0.04, 0.02, 'N', 'O', "
         "'1996-03-13', '1996-02-12', '1996-03-22', 'DELIVER IN PERSON', "
         "'TRUCK', 'a lineitem comment never seen'), "
         "(60001, 2, 2, 2, 3.00, 99.10, 0.00, 0.08, 'N', 'O', "
         "'1996-04-01', '1996-03-01', '1996-04-11', 'NONE', 'MAIL', "
         "'another new lineitem comment')")


@pytest.fixture(autouse=True)
def fresh_recorder():
    PROF.reset()
    yield
    PROF.reset()


def traced(fn):
    """Run `fn` under torch.profiler (CPU); -> (its result, the profile)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def closed_and_nested(spans):
    """Every span closed, and inside its parent."""
    for i, (name, s, e, parent, _, _) in enumerate(spans):
        assert e is not None and s <= e, (i, name)
        assert -1 <= parent < i, (i, name)
        if parent >= 0:
            ps, pe = spans[parent][1], spans[parent][2]
            assert ps <= s and e <= pe, (i, name, spans[parent][0])


def test_select_span_tree():
    conn = connect(0.01, device="cpu")
    conn.sql(SQL[13]).strings()
    traced(lambda: conn.sql(SQL[13]).strings())
    spans = PROF.spans()
    closed_and_nested(spans)
    names = [s[0] for s in spans]
    assert all(n.startswith(("db.", "py.")) for n in names)
    assert not any(n.startswith(HARNESS) for n in names)
    root = names.index("db.sql")
    assert spans[root][3] == -1 and spans[root][5]["kind"] == "select"
    qid = spans[root][4]
    # (a garbage collection may fall anywhere)
    inside = [s for s in spans if s[4] == qid and s[0] != "py.gc"]
    assert {s[0] for s in inside} >= {
        "db.sql", "db.parse", "db.bind", "db.optimize", "db.prepare",
        "db.stage", "db.wait", "db.op.table_scan", "db.op.hash_join",
        "db.op.group_aggregate", "db.dict.Like"}
    # parse, bind, optimize and prepare hang off the root, in that order
    top = [s[0] for s in inside if s[3] == root]
    assert top[:4] == ["db.parse", "db.bind", "db.optimize", "db.prepare"]
    # a stage nests in a stage; LIKE runs inside the scan that filters
    stages = [i for i, s in enumerate(spans) if s[0] == "db.stage"]
    assert any(spans[i][3] in stages for i in stages)
    like = names.index("db.dict.Like")
    assert spans[spans[like][3]][0] == "db.op.table_scan"
    assert spans[like][5]["entries"] == len(
        conn.catalog.table("orders").columns["o_comment"].dictionary)
    # rendering happens after the call, outside its query id
    assert {s[0] for s in spans if s[4] is None} >= {"db.materialize",
                                                      "db.format"}
    waits = [s for s in inside if s[0] == "db.wait"]
    assert spans[root][5]["host_waits"] == len(waits) > 0
    assert {w[5]["what"] for w in waits} <= {"count", "checks"}
    assert spans[root][5]["dict_entries"] == spans[like][5]["entries"]


def test_prepare_miss_then_hit_on_the_root(monkeypatch):
    monkeypatch.setattr(Executor, "_prepare_cache", OrderedDict())
    conn = connect(0.01, device="cpu")
    traced(lambda: [conn.sql(SQL[6]).strings() for _ in range(2)])
    roots = [s for s in PROF.spans() if s[0] == "db.sql"]
    assert len(roots) == 2 and roots[0][4] != roots[1][4]
    first, second = roots[0][5], roots[1][5]
    assert first["prepare_misses"] >= 1 and first["prepare_hits"] == 0
    assert second["prepare_misses"] == 0 and second["prepare_hits"] >= 1
    hits = [s[5]["hit"] for s in PROF.spans() if s[0] == "db.prepare"]
    assert hits[0] is False and hits[-1] is True
    totals = PROF.counters()
    assert totals["prepare_hits"] == second["prepare_hits"]
    assert totals["spans"] == len(PROF.spans())
    assert totals["spans_dropped"] == 0


def test_refresh_like_transactions():
    """An RF1-like transaction (two INSERTs) and a DELETE rolled back, on
    a catalog of the test's own."""
    conn = Connection(load_catalog(0.01, device="cpu", cache=False),
                      device="cpu")
    statements = ["BEGIN", f"INSERT INTO orders VALUES {ORDER}",
                  f"INSERT INTO lineitem VALUES {LINES}", "COMMIT",
                  "BEGIN", "DELETE FROM orders WHERE o_orderkey IN (60001)",
                  "ROLLBACK"]
    traced(lambda: [conn.sql(s) for s in statements])
    spans = PROF.spans()
    closed_and_nested(spans)
    roots = [(i, s) for i, s in enumerate(spans) if s[0] == "db.sql"]
    assert [s[5]["kind"] for _, s in roots] == [
        "begin", "insert", "insert", "commit", "begin", "delete",
        "rollback"]
    assert len({s[4] for _, s in roots}) == len(statements)

    def under(k):
        i, root = roots[k]
        return [s for s in spans if s[4] == root[4] and s[0] != "py.gc"]

    assert [s[0] for s in under(0)] == ["db.sql", "db.parse", "db.begin"]
    assert [s[0] for s in under(3)] == ["db.sql", "db.parse", "db.commit"]
    assert [s[0] for s in under(6)] == ["db.sql", "db.parse",
                                        "db.rollback"]
    for k, rows in ((1, 1), (2, 2)):
        names = {s[0] for s in under(k)}
        assert names >= {"db.parse", "db.insert.literals", "db.dml.encode",
                         "db.dml.device", "db.dml.cubit", "db.dml.pk",
                         "db.dml.stats"}
        attrs = roots[k][1][5]
        assert attrs["rows_written"] == rows and attrs["cubit_merges"] >= 1
    assert {s[0] for s in under(5)} >= {"db.dml.match", "db.bind",
                                        "db.op.table_scan", "db.dml.delete"}
    assert roots[5][1][5]["rows_written"] == 1
    # a DML phase hangs off the INSERT's root
    encode = next(s for s in under(2) if s[0] == "db.dml.encode")
    assert spans[encode[3]][0] == "db.sql"


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    real = PROF._range

    def counting(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(PROF, "_range", counting)
    conn = connect(0.01, device="cpu")
    conn.sql(SQL[13]).strings()
    assert PROF.spans() == [] and opened == []
    assert PROF.span("db.x") is PROF.NULL is PROF.wait("count")
    assert PROF.statement(conn.executor) is PROF.NULL
    assert PROF.counters()["spans"] == 0
    # on, every span opens its range
    traced(lambda: conn.sql(SQL[6]).strings())
    assert opened == [s[0] for s in PROF.spans()]


def _host_ranges(prof, prefix):
    out = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(prefix) and hasattr(e, "activity_type"):
            # no user annotation: the profiler would project it onto the
            # device timeline, where it reads as work on the card
            assert "user_annotation" not in str(e.activity_type()), name
        if name.startswith(prefix) and \
                "cuda" not in str(e.device_type()).lower():
            start = e.start_ns() if hasattr(e, "start_ns") else \
                e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") else \
                e.duration_us() * 1000
            out.setdefault(name, []).append((start, start + dur))
    return {k: sorted(v) for k, v in out.items()}


def test_spans_lie_on_the_profiler_clock():
    conn = connect(0.01, device="cpu")
    _, prof = traced(lambda: [conn.sql(SQL[n]).strings()
                              for n in (13, 6, 3)])
    ranges = _host_ranges(prof, "db.")
    ours: dict = {}
    for name, s, e, *_ in PROF.spans():
        if name.startswith("db."):
            ours.setdefault(name, []).append((s, e))
    assert set(ranges) == set(ours) and len(ours) >= 10
    for name, theirs in ranges.items():
        mine = sorted(ours[name])
        assert len(mine) == len(theirs), name
        for (s, e), (ts, te) in zip(mine, theirs):
            assert abs(s - ts) < 2_000_000 and abs(e - te) < 2_000_000, name


def _slow_execute(seconds):
    real = P.GroupAggregate._execute

    def run(self, ctx):
        import time
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            time.sleep(0.01)
        return real(self, ctx)
    return run


def test_spans_close_on_a_raised_deadline(monkeypatch):
    cfg = EngineConfig()
    cfg.query_timeout_s = 0.2
    conn = Connection(config=cfg, device="cpu")
    conn.register_numpy("big", {"k": np.arange(1000, dtype=np.int64)})
    monkeypatch.setattr(P.GroupAggregate, "_execute", _slow_execute(2.0))

    def run():
        with pytest.raises(QueryTimeoutError):
            conn.sql("SELECT count(*) AS c FROM big WHERE k >= 0")
        with PROF.span("db.after"):
            pass
    traced(run)
    spans = PROF.spans()
    closed_and_nested(spans)
    errors = {s[0] for s in spans
              if (s[5] or {}).get("error") == "QueryTimeoutError"}
    assert {"db.sql", "db.stage", "db.op.group_aggregate"} <= errors
    # the stack is clean: the next span is a root again
    assert spans[-1][0] == "db.after" and spans[-1][3] == -1


def test_spans_close_on_a_forced_retry(monkeypatch):
    """A check that fails once runs the stage again (the root counts the
    retry); one that keeps failing raises through every span."""
    monkeypatch.setattr(Executor, "_prepare_cache", OrderedDict())
    conn = Connection(load_catalog(0.01, device="cpu", cache=False),
                      device="cpu")
    real = probe.monotone_gather_many
    seen = []

    def overflow(luts, keys, times):
        outs, ovf = real(luts, keys)
        seen.append(1)
        return outs, ovf + 1 if len(seen) <= times else ovf
    monkeypatch.setattr(probe, "monotone_gather_many",
                        lambda luts, keys: overflow(luts, keys, 1))
    traced(lambda: conn.sql(SQL[12]).strings())
    spans = PROF.spans()
    closed_and_nested(spans)
    root = next(s for s in spans if s[0] == "db.sql")
    # K2's plain body on the CPU counts no launch
    assert root[5]["retries"] == 1 and root[5]["k2_launches"] == 0
    assert any(s[0] == "db.wait" and s[5]["what"] == "checks"
               for s in spans)
    # the stage with the join ran again
    assert [s[0] for s in spans].count("db.op.hash_join") == 2

    PROF.reset()
    seen.clear()
    monkeypatch.setattr(Executor, "MAX_ATTEMPTS", 1)
    monkeypatch.setattr(Executor, "_prepare_cache", OrderedDict())
    conn2 = Connection(load_catalog(0.01, device="cpu", cache=False),
                       device="cpu")

    def fails():
        with pytest.raises(RuntimeError, match="retry limit"):
            conn2.sql(SQL[12])
    traced(fails)
    spans = PROF.spans()
    closed_and_nested(spans)
    root = next(s for s in spans if s[0] == "db.sql")
    assert root[5]["error"] == "RuntimeError"
    assert any(s[0] == "db.stage" and s[5] and s[5]["error"] == "RuntimeError"
               for s in spans)


def test_nested_spans_close_on_an_exception():
    def run():
        with pytest.raises(ValueError):
            with PROF.span("db.a"):
                with PROF.span("db.b"):
                    raise ValueError("boom")
        with PROF.span("db.a") as outer:
            # a span whose exit never runs (an alarm inside its entry)
            PROF.span("db.lost").__enter__()
            outer.set(n=1)
    traced(run)
    spans = PROF.spans()
    at = {}
    for i, sp in enumerate(spans):
        at.setdefault(sp[0], []).append(i)
    (a, a2), (b,), (lost,) = at["db.a"], at["db.b"], at["db.lost"]
    assert spans[a][5] == {"error": "ValueError"} == spans[b][5]
    assert spans[b][3] == a and spans[a2][3] == -1
    assert spans[a2][5] == {"n": 1}
    assert spans[lost][3] == a2 and spans[lost][2] == spans[a2][2]
    assert spans[lost][5] == {"error": "unclosed"}


def test_garbage_collections_are_spans():
    def run():
        with PROF.span("db.a"):
            gc.collect()
    traced(run)
    gcs = [s for s in PROF.spans() if s[0] == "py.gc"]
    full = [s for s in gcs if s[5]["generation"] == 2]
    assert full and full[0][3] == 0 and full[0][2] >= full[0][1]
    gc.collect()
    assert len([s for s in PROF.spans() if s[0] == "py.gc"]) == len(gcs)


def test_the_bound_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(PROF, "MAX_SPANS", 5)
    conn = connect(0.01, device="cpu")
    traced(lambda: conn.sql(SQL[13]).strings())
    spans = PROF.spans()
    assert len(spans) == 5
    closed_and_nested(spans)
    assert PROF.counters()["spans_dropped"] > 10
    PROF.reset()
    assert PROF.counters()["spans_dropped"] == 0 and PROF.spans() == []
