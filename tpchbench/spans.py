"""The engine's own spans in a traced run, matched to the harness's.

The engine records its spans while torch.profiler records
(`duckdb_cubit_tpu_torch.exec.profiler`: `(name, start_ns, end_ns, parent,
query_id, attrs)`, on the profiler's clock).  `held(rec)` keeps those that
start inside the harness's `window` span of `rec.trace` and gives each the
harness span (`sql:qNN`, `strings:qNN`, `rf1`, `rf2`) that holds its start.
That assignment is itself a check that the two clocks are one: a root
`db.sql` that a harness span does not hold shows they are not
(`tpchbench/split.py` prints it).  An engine without the recorder gives
None, and so does a run without a trace.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from . import trace


def program() -> list | None:
    """Every span the engine recorded; None where it records none."""
    try:
        from duckdb_cubit_tpu_torch.exec import profiler
        return profiler.spans()
    except (ImportError, AttributeError):
        return None


@dataclass
class Held:
    spans: list        # the engine's spans, indices as recorded
    holder: list       # per span: index into `harness`, -1 outside every
                       # harness span, None outside the window (or open)
    harness: list      # the harness's spans in the window but `window`


def held(rec) -> Held | None:
    if rec.trace is None:
        return None
    w = trace.window(rec.trace)
    spans = program()
    if w is None or not spans:
        return None
    harness = [s for s in rec.trace["spans"]
               if s[0] != "window" and w[0] <= s[1] < w[1]]
    starts = [h[1] for h in harness]
    holder = []
    for s in spans:
        if s[2] is None or not w[0] <= s[1] < w[1]:
            holder.append(None)
            continue
        i = bisect.bisect_right(starts, s[1]) - 1
        holder.append(i if i >= 0 and s[1] < harness[i][2] else -1)
    return Held(spans, holder, harness)


def _held_by(h: Held, i: int, runs: str) -> bool:
    k = h.holder[i]
    return k is not None and k >= 0 and h.harness[k][0].startswith(runs)


def runs(h: Held, prefix: str) -> int:
    """The harness spans whose names start with `prefix`."""
    return sum(1 for s in h.harness if s[0].startswith(prefix))


def per_run_s(rec, names: tuple[str, ...], prefix: str,
              self_time: bool = False) -> float | None:
    """Seconds per harness span named `prefix...` in the engine's spans
    whose names start with one of `names` and that those spans hold: each
    counted once (a match inside a match is not counted again), or with
    `self_time` each less its direct children (any engine span)."""
    h = held(rec)
    if h is None:
        return None
    n = runs(h, prefix)
    if n == 0:
        return None
    spans = h.spans
    total = 0
    children: dict[int, int] = {}
    if self_time:
        for s in spans:
            if s[3] >= 0 and s[2] is not None:
                children[s[3]] = children.get(s[3], 0) + s[2] - s[1]
    for i, s in enumerate(spans):
        if not s[0].startswith(names) or not _held_by(h, i, prefix):
            continue
        if self_time:
            total += s[2] - s[1] - children.get(i, 0)
            continue
        p = s[3]
        while p >= 0 and not spans[p][0].startswith(names):
            p = spans[p][3]
        if p < 0:
            total += s[2] - s[1]
    return total / 1e9 / n


def roots_in_window(rec) -> list | None:
    """The attributes of every `db.sql` root that starts in the window."""
    h = held(rec)
    if h is None:
        return None
    return [s[5] or {} for i, s in enumerate(h.spans)
            if s[0] == "db.sql" and h.holder[i] is not None]
