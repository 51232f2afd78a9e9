"""Query profiler (EXPLAIN ANALYZE) and the engine's span recorder.

`QueryProfiler` is the counterpart of `duckdb_cubit_tpu/exec/profiler.py`.
`PhysicalOperator.execute` wraps each operator's run in `operator(op,
profiler)` and, when the context holds a profiler, waits for the card inside
it (`torch.cuda.synchronize`, so an operator's time holds its own kernels and
its children's) and records the live row count.  `render` prints the tree as
EXPLAIN ANALYZE shows it, `to_json` the same tree as JSON.

**Spans.**  The engine marks where its work happens with `span(name)` (and
`statement`, `wait`, `dict_walk`, `operator`).  The recorder is on exactly
while torch.profiler records (`torch._C._autograd._profiler_enabled()`);
with it off, each of these returns one shared null context and records
nothing, at the cost of that one flag read.  While it is on, a span is kept
in memory as `(name, start_ns, end_ns, parent, query_id, attrs)` and opened
as a profiler range of the same name, so a chrome trace exported from the
profiler shows the engine's spans under the caller's ranges.  The range is
a function-scope one (`torch._C._profiler._RecordFunctionFast`, a CPU op in
the trace), not a `record_function` user annotation: the profiler projects
each user annotation onto the device timeline as `gpu_user_annotation`
activity, which a reader of the device's busy time would take for work on
the card.

- `start_ns`, `end_ns`: `perf_counter_ns()` plus one offset to `time_ns()`,
  taken when the recorder first records after import or `reset()`.
  torch.profiler's event times are Unix-epoch nanoseconds, so the spans lie
  on the device trace's clock.
- `parent`: the index in `spans()` of the enclosing span, -1 at the top.
- `query_id`: shared by every span of one `Connection.sql` call (its root,
  `db.sql`, opened by `statement`); None outside one.
- `attrs`: a dict or None.  A span closed by an exception carries `error`,
  the exception's class name (the deadline's SIGALRM raises through them).
  The root carries `kind` and the deltas of the engine's counters over the
  statement (`COUNTERS`, plus `host_waits`: its `db.wait` spans).
- At most `MAX_SPANS` are kept; `counters()["spans_dropped"]` counts the
  rest.
- `py.gc`: each garbage collection while the recorder is on (one
  `gc.callbacks` hook, installed the first time it records), attrs
  `generation` and `collected`.

Every span name starts with `db.` or `py.`.  The recorder serves one
thread: the engine runs its statements on one.
"""

from __future__ import annotations

import contextlib
import gc
import json
import time

import torch

_enabled = getattr(getattr(torch._C, "_autograd", None),
                   "_profiler_enabled", lambda: False)
_Range = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast",
                 None)

MAX_SPANS = 2_000_000

# the engine's counters a statement's root records as deltas
COUNTERS = ("prepare_hits", "prepare_misses", "k1_launches", "k2_launches",
            "retries", "compacted", "dict_entries", "cubit_merges",
            "rows_written", "k6_launches", "pk_probe_rows",
            "sort_probe_rows", "k7_launches")


class _State:
    def __init__(self):
        self.spans: list[list] = []
        self.stack: list[int] = []
        self.dropped = 0
        self.offset: int | None = None
        self.query: int | None = None
        self.queries = 0
        self.gc_start: list | None = None


_S = _State()
_gc_hooked = False


def spans() -> list[tuple]:
    """Every recorded span, `(name, start_ns, end_ns, parent, query_id,
    attrs)`, in the order they opened (`end_ns` is None while open)."""
    return [tuple(s) for s in _S.spans]


def counters() -> dict:
    """The recorded statements' counter deltas summed, with the number of
    spans kept (`spans`) and dropped past the bound (`spans_dropped`)."""
    out = dict.fromkeys(COUNTERS + ("host_waits",), 0)
    for s in _S.spans:
        if s[0] == "db.sql" and s[5]:
            for k in out:
                out[k] += s[5].get(k, 0)
    out["spans"] = len(_S.spans)
    out["spans_dropped"] = _S.dropped
    return out


def reset():
    """Forget every span; the next span takes the clock offset anew."""
    global _S
    _S = _State()


class _Null:
    """The shared context of every span while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NULL = _Null()


def _start():
    global _gc_hooked
    if not _gc_hooked:
        gc.callbacks.append(_on_gc)
        _gc_hooked = True
    _S.offset = time.time_ns() - time.perf_counter_ns()


def _now() -> int:
    return time.perf_counter_ns() + _S.offset


def _range(name: str):
    return _Range(name) if _Range is not None else NULL


class _Span:
    __slots__ = ("name", "attrs", "index", "range")

    def __init__(self, name: str, attrs: dict | None = None):
        self.name = name
        self.attrs = attrs
        self.index = -1

    def set(self, **attrs):
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self):
        st = _S
        if st.offset is None:
            _start()
        if len(st.spans) >= MAX_SPANS:
            st.dropped += 1
            return self
        self.range = _range(self.name)
        self.range.__enter__()
        self.index = len(st.spans)
        st.spans.append([self.name, _now(), None,
                         st.stack[-1] if st.stack else -1, st.query, None])
        st.stack.append(self.index)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.index < 0:
            return False
        st = _S
        end = _now()
        # spans an exception left open inside this one close with it
        while st.stack and st.stack[-1] > self.index:
            inner = st.spans[st.stack.pop()]
            if inner[2] is None:
                inner[2] = end
                inner[5] = {**(inner[5] or {}), "error": "unclosed"}
        if st.stack and st.stack[-1] == self.index:
            st.stack.pop()
        if exc_type is not None:
            self.set(error=exc_type.__name__)
        rec = st.spans[self.index]
        rec[2], rec[5] = end, self.attrs
        self.range.__exit__(exc_type, exc, tb)
        return False


def span(name: str):
    """A span named `name` (starting with `db.` or `py.`) around a `with`
    block; `.set(key=value)` adds attributes."""
    if not _enabled():
        return NULL
    return _Span(name)


def wait(what: str):
    """`db.wait`: the host blocked on a device read (`what` names it)."""
    if not _enabled():
        return NULL
    return _Span("db.wait", {"what": what})


def dict_walk(expr: str, entries: int):
    """`db.dict.<expr>`: a host walk over `entries` dictionary entries."""
    if not _enabled():
        return NULL
    return _Span("db.dict." + expr, {"entries": entries})


def operator(op, profiler: "QueryProfiler | None" = None):
    """The one hook around an operator's run: `db.op.<name>`, and the
    operator's EXPLAIN ANALYZE record when `profiler` is given."""
    if profiler is not None:
        return profiler.operator(op)
    if not _enabled():
        return NULL
    return _Span("db.op." + op.name)


def _counter_values(executor) -> list[int]:
    from ..index import cubit
    from ..ops import compact, dict_like, expressions, fused_scan, join, probe
    from ..plan import physical
    from ..storage import dml

    return [executor.prepare_hits, executor.prepare_misses,
            fused_scan.launch_count, probe.launch_count,
            executor.retry_count, executor.compacted_boundaries,
            expressions.dict_entries, cubit.merge_count, dml.rows_written,
            dict_like.launch_count, physical.pk_probe_rows, join.probe_rows,
            compact.launch_count]


class _Statement(_Span):
    """`db.sql`: one `Connection.sql` call, under a query id of its own,
    with the counters' deltas as attributes."""
    __slots__ = ("executor", "before", "outer")

    def __init__(self, executor):
        super().__init__("db.sql", {"kind": "other"})
        self.executor = executor

    def __enter__(self):
        self.outer = _S.query
        _S.queries += 1
        _S.query = _S.queries
        self.before = _counter_values(self.executor)
        return super().__enter__()

    def __exit__(self, exc_type, exc, tb):
        st = _S
        after = _counter_values(self.executor)
        self.set(**{k: a - b for k, a, b in zip(COUNTERS, after,
                                                 self.before)})
        if self.index >= 0:
            self.set(host_waits=sum(s[0] == "db.wait"
                                    for s in st.spans[self.index + 1:]))
        st.query = self.outer
        return super().__exit__(exc_type, exc, tb)


def statement(executor):
    """`db.sql`, the root span of one `Connection.sql` call."""
    if not _enabled():
        return NULL
    return _Statement(executor)


def _on_gc(phase: str, info: dict):
    """`py.gc`, recorded only while the recorder is on."""
    st = _S
    if phase == "start":
        if not _enabled() or st.offset is None \
                or len(st.spans) >= MAX_SPANS:
            st.gc_start = None
            return
        rf = _range("py.gc")
        rf.__enter__()
        st.gc_start = [rf, len(st.spans)]
        st.spans.append(["py.gc", _now(), None,
                         st.stack[-1] if st.stack else -1, st.query, None])
    elif st.gc_start is not None:
        rf, i = st.gc_start
        st.gc_start = None
        rec = st.spans[i]
        rec[2] = _now()
        rec[5] = {"generation": info.get("generation"),
                  "collected": info.get("collected")}
        rf.__exit__(None, None, None)


class QueryProfiler:
    def __init__(self, enabled: bool = True, measure_cardinality: bool = True):
        self.enabled = enabled
        self.measure_cardinality = measure_cardinality
        self.records: dict[int, dict] = {}
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def operator(self, op):
        rec = self.records.setdefault(
            id(op), {"name": op.describe(), "time": 0.0, "cardinality": None,
                     "children": [id(c) for c in op.children]})
        with operator(op):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                rec["time"] += time.perf_counter() - t0

    def record_cardinality(self, op, count: int):
        self.records[id(op)]["cardinality"] = count

    def render(self, root) -> str:
        lines = []

        def walk(op, depth):
            rec = self.records.get(id(op))
            if rec:
                card = rec["cardinality"]
                lines.append("  " * depth + f"{rec['name']}  "
                             f"[{rec['time']*1e3:.2f} ms"
                             + (f", {card} rows]" if card is not None else "]"))
            for c in op.children:
                walk(c, depth + 1)

        walk(root, 0)
        if self.phases:
            lines.append("phases: " + ", ".join(
                f"{k}={v*1e3:.2f}ms" for k, v in self.phases.items()))
        return "\n".join(lines)

    def to_json(self, root) -> str:
        def node(op):
            rec = self.records.get(id(op), {})
            return {
                "name": rec.get("name", op.describe()),
                "time_ms": rec.get("time", 0.0) * 1e3,
                "cardinality": rec.get("cardinality"),
                "children": [node(c) for c in op.children],
            }
        return json.dumps({"plan": node(root), "phases": self.phases})
