"""Where the host time of a traced run goes, by the engine's own spans.

    python3 -m tpchbench.split --workload <cell> --seed <n> --seconds <s> \\
        [--out <file.json>]

Runs the cell once with `--trace 1` (`run.run_cell`), prints its result line
like `tpchbench.run`, and writes the split as JSON (to `--out`, by default
`tpchbench/_build/split_<cell>_<seed>.json`):

- `clock`: each `db.sql` root against the harness span that holds its start
  (`spans.held`): how many lie wholly inside it, and the farthest overhang.
- `idle`: the device-idle time inside the harness's `sql:` spans (power) or
  `rf1` spans (refresh), the share of it under an engine span below
  `db.sql`, and the innermost engine spans by idle time.
- `queries`: per query (and `all`), over its `sql:` and `strings:` spans,
  host ms a run by innermost engine span (`-` where none is open) with the
  device-idle ms under each.
- `rf1`: per RF1 of the window in order, its seconds, the seconds in each
  engine span by name (inclusive), and its garbage collections.
- `spans_per_statement`: the engine's spans per statement, by kind.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

from . import run, spans, trace


def innermost(prog: list, idx: list[int]) -> list[tuple[int, int, str]]:
    """The timeline of the innermost open span among `prog[idx]` (spans in
    the order they opened): [(start, end, name)], gaps left out."""
    out, stack, cur = [], [], None

    def advance(t):
        nonlocal cur
        if cur is not None and t > cur and stack:
            out.append((cur, t, stack[-1][1]))
        cur = t if cur is None or t > cur else cur

    for i in idx:
        name, s, e = prog[i][0], prog[i][1], prog[i][2]
        while stack and stack[-1][0] <= s:
            advance(stack[-1][0])
            stack.pop()
        advance(s)
        stack.append((e, name))
    while stack:
        advance(stack[-1][0])
        stack.pop()
    return out


def intersect(a: list, b: list) -> list[tuple[int, int, object, object]]:
    """The overlaps of two sorted lists of disjoint intervals (start, end,
    label...): [(start, end, label of a, label of b)]."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e, a[i][2] if len(a[i]) > 2 else None,
                        b[j][2] if len(b[j]) > 2 else None))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_gaps(tr: dict) -> list[tuple[int, int]]:
    w = trace.window(tr)
    busy = trace.busy_intervals(tr, *w)
    edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def split(rec) -> dict:
    h = spans.held(rec)
    if h is None:
        return {}
    prog = h.spans
    inside = [i for i, k in enumerate(h.holder) if k is not None]
    timeline = innermost(prog, inside)
    harness = [(s, e, k) for k, (_, s, e) in enumerate(h.harness)]
    idle = idle_gaps(rec.trace)
    out: dict = {}

    # the two clocks: each root wholly inside the harness span at its start
    roots = [i for i in inside if prog[i][0] == "db.sql"]
    over = [max(0, h.harness[h.holder[i]][1] - prog[i][1],
                prog[i][2] - h.harness[h.holder[i]][2])
            for i in roots if h.holder[i] >= 0]
    out["clock"] = {"roots": len(roots),
                    "held": sum(h.holder[i] >= 0 for i in roots),
                    "wholly_inside": sum(o == 0 for o in over),
                    "max_overhang_us": max(over, default=0) / 1e3}

    # host time and device-idle time by innermost span, per harness span
    host = intersect(timeline, harness)
    idle_in = intersect([(s, e, name) for s, e, _, name
                         in intersect(idle, timeline)], harness)
    idle_all = intersect(idle, harness)

    def table(keep) -> dict:
        runs = {k for _, _, k in harness if keep(h.harness[k][0])}
        n = sum(1 for k in runs if h.harness[k][0].startswith("sql:"))
        host_ns: dict = {}
        idle_ns: dict = {}
        for s, e, name, k in host:
            if k in runs:
                host_ns[name] = host_ns.get(name, 0) + e - s
        for s, e, _, k in idle_all:
            if k in runs:
                idle_ns["-"] = idle_ns.get("-", 0) + e - s
        for s, e, name, k in idle_in:
            if k in runs:
                idle_ns[name] = idle_ns.get(name, 0) + e - s
                idle_ns["-"] -= e - s
        span_ns = sum(h.harness[k][2] - h.harness[k][1] for k in runs)
        host_ns["-"] = span_ns - sum(host_ns.values())
        total_idle = sum(idle_ns.values())
        rows = sorted(set(host_ns) | set(idle_ns),
                      key=lambda x: -host_ns.get(x, 0))
        return {"runs": n,
                "ms_per_run": span_ns / 1e6 / max(n, 1),
                "idle_ms_per_run": total_idle / 1e6 / max(n, 1),
                "spans": [[x, host_ns.get(x, 0) / 1e6 / max(n, 1),
                           idle_ns.get(x, 0) / 1e6 / max(n, 1),
                           idle_ns.get(x, 0) / total_idle * 100
                           if total_idle else 0.0] for x in rows]}

    names = {n[0] for n in h.harness}
    queries = sorted({n.split(":")[1] for n in names if n.startswith("sql:")})
    out["queries"] = {q: table(lambda n, q=q: n in (f"sql:{q}",
                                                    f"strings:{q}"))
                      for q in queries}
    out["queries"]["all"] = table(lambda n: n.startswith(("sql:",
                                                          "strings:")))

    # the criterion: idle time inside sql: (or rf1) spans under an engine
    # span below the root
    for prefix in ("sql:", "rf1"):
        tot = sum(e - s for s, e, _, k in idle_all
                  if h.harness[k][0].startswith(prefix))
        if not tot:
            continue
        by: dict = {}
        for s, e, name, k in idle_in:
            if h.harness[k][0].startswith(prefix):
                by[name] = by.get(name, 0) + e - s
        below = sum(v for n, v in by.items() if n != "db.sql")
        out[f"idle.{prefix.rstrip(':')}"] = {
            "idle_s": tot / 1e9, "below_root_pct": 100.0 * below / tot,
            "top": [[n, v / 1e9] for n, v in sorted(
                by.items(), key=lambda x: -x[1])[:8]]}

    # each RF1 in order: seconds by span name (inclusive, outermost of a
    # name), garbage collections
    rf1 = []
    for k, (name, s, e) in enumerate(h.harness):
        if name != "rf1":
            continue
        by: dict = {}
        gcs = {0: 0, 1: 0, 2: 0}
        for i in inside:
            if h.holder[i] != k:
                continue
            sp = prog[i]
            p = sp[3]
            while p >= 0 and prog[p][0] != sp[0]:
                p = prog[p][3]
            if p < 0:
                by[sp[0]] = by.get(sp[0], 0) + sp[2] - sp[1]
            if sp[0] == "py.gc":
                gcs[(sp[5] or {}).get("generation", 0)] += 1
        merges = sum((prog[i][5] or {}).get("cubit_merges", 0)
                     for i in inside
                     if h.holder[i] == k and prog[i][0] == "db.sql")
        rf1.append({"s": (e - s) / 1e9,
                    "spans_s": {n: v / 1e9 for n, v in sorted(by.items())},
                    "gc_by_generation": gcs, "cubit_merges": merges})
    if rf1:
        out["rf1"] = rf1

    # spans per statement, by kind
    count = Counter(prog[j][4] for j in inside)
    per: dict = {}
    for i in roots:
        kind = (prog[i][5] or {}).get("kind", "other")
        per.setdefault(kind, []).append(count[prog[i][4]])
    out["spans_per_statement"] = {k: [min(v), sum(v) / len(v), max(v)]
                                  for k, v in per.items()}
    out["spans_outside_statements"] = sum(1 for i in inside
                                          if prog[i][4] is None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sf", type=float)
    args = ap.parse_args(argv)
    run.cache_dirs()
    bench = run.load_benchmark()
    result, rec = run.run_cell(bench, args.workload, args.seed,
                               args.seconds, True, device=args.device,
                               sf=args.sf)
    out = split(rec)
    path = args.out or os.path.join(
        run.HERE, "_build", f"split_{args.workload}_{args.seed}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"result": result, "split": out}, f, indent=1)
    for key in ("clock", "idle.sql", "idle.rf1", "spans_per_statement"):
        if key in out:
            print(key, json.dumps(out[key]), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
