"""Run one benchmark cell once and print its result as the last line.

    python3 -m tpchbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout on a machine with an NVIDIA card.  The cell,
its configuration (`configs/<config>.json`), its traffic mix
(`traffic/<mix>.json`) and its metrics (`metrics/<metric>.py`) are all found
by the names in `BENCHMARK.json`, and the configuration's suite
(`suites/<suite>.py`, `tpch` where it names none) by its `suite`: the
benchmark's own data, the engine's opening, the traffic and the reference.
The engine under test is the PyTorch and CUDA port, driven through its
public API: `connect`, `Connection.sql`, `Result.strings()`.

A run: set-up (import, card, `connect`, one warm-up pass over every query
text the window sends), a closed-loop window of `--seconds` (whole streams
or whole refresh cycles, started while time is left), then the comparison
of what the window returned with the plain reference.  With `--trace 1` the
window runs under torch.profiler and the result carries the per-layer
metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "duckdb_cubit_tpu")


@dataclass
class Records:
    """What a run saw; the metric readers take their numbers from it."""
    cell: dict
    # per query of the window: (query number, seconds, seconds inside
    # conn.sql, seconds in Result.strings(), cycle)
    queries: list = field(default_factory=list)
    # per refresh function: (kind, update set, seconds, statuses, cycle)
    refreshes: list = field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    setup_parts: dict = field(default_factory=dict)
    trace: dict | None = None          # trace.collect's output
    db: object = None                  # the suite's reference database
    params: dict = field(default_factory=dict)   # the first cycle's


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(name: str, base: str = HERE) -> dict:
    with open(os.path.join(base, "configs", f"{name}.json")) as f:
        return json.load(f)


def load_mix(name: str, base: str = HERE) -> dict:
    with open(os.path.join(base, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _load_module(kind: str, name: str, path: str):
    spec = importlib.util.spec_from_file_location(
        f"tpchbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    """`metrics/<name>.py`'s `read(records) -> float | None`."""
    return _load_module("metric", name,
                        os.path.join(HERE, "metrics", f"{name}.py")).read


def load_suite(config: dict, base: str = HERE):
    """`suites/<suite>.py` named by the configuration (`suites/tpch.py`'s
    docstring lists what a suite provides)."""
    name = config.get("suite", "tpch")
    return _load_module("suite", name,
                        os.path.join(base, "suites", f"{name}.py"))


def metrics_for(bench: dict, cell: str, traced: bool) -> list[dict]:
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(HERE, "_build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_loaded_rows(conn, tables: dict):
    """The engine's loaded host columns equal the benchmark's own arrays,
    column by column (strings through the engine's dictionaries)."""
    import numpy as np

    for tname, cols in tables.items():
        t = conn.catalog.table(tname)
        n = t.num_rows
        for cname, want in cols.items():
            c = t.columns[cname]
            got = c.host[:n]
            if c.dictionary is not None:
                got = c.dictionary[got]
            ok = (len(got) == len(want) and np.array_equal(
                got, want) if want.dtype.kind == "S" else
                np.array_equal(np.asarray(got).astype(np.int64),
                               np.asarray(want).astype(np.int64)))
            if not ok:
                raise RuntimeError(f"{tname}.{cname}: the engine loaded other "
                                   "rows than the benchmark generated")


def per_query_table(rec: Records, label) -> str:
    """Per query of the window (named by `label(n)`): runs, median / min /
    max ms, and the median ms inside conn.sql and in strings(); then each
    refresh kind."""
    import numpy as np

    lines = [f"{name} {load_reader(name)(rec)!r}" for name in (
        "qps", "query_p95_ms", "geomean_ms")]
    lines.append("q  runs  median  min  max  sql  strings (ms)")
    for n in sorted({q[0] for q in rec.queries}):
        q = np.array([x[1:4] for x in rec.queries if x[0] == n]) * 1000
        lines.append(f"{label(n)} {len(q)} {np.median(q[:, 0]):.3f} "
                     f"{q[:, 0].min():.3f} {q[:, 0].max():.3f} "
                     f"{np.median(q[:, 1]):.3f} {np.median(q[:, 2]):.3f}")
    for kind in ("rf1", "rf2"):
        t = [r[2] for r in rec.refreshes if r[0] == kind]
        if t:
            lines.append(f"{kind} {len(t)} {np.median(t) * 1000:.3f} "
                         f"{min(t) * 1000:.3f} {max(t) * 1000:.3f}")
    # the slowest queries' latencies in window order, whole ms
    slow = sorted({q[0] for q in rec.queries}, key=lambda n: -np.median(
        [x[1] for x in rec.queries if x[0] == n]))[:3]
    for n in slow:
        lines.append(f"{label(n)} in order: " + " ".join(
            str(round(x[1] * 1000)) for x in rec.queries if x[0] == n))
    for kind in ("rf1", "rf2"):
        t = [r[2] for r in rec.refreshes if r[0] == kind]
        if t:
            lines.append(f"{kind} in order: " + " ".join(
                str(round(x * 1000)) for x in t))
    return "\n".join(lines)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, *, device: str = "cuda", sf: float | None = None,
             log=sys.stderr, base: str = HERE) -> tuple[dict, Records]:
    """One run of one cell.  Returns (result line, records).  `device` and
    `sf` other than the cell's are for rehearsals on the CPU only; `base`
    is the directory the cell's configuration, mix and suite are found
    under."""
    import torch

    from . import check, trace

    cell = find(bench["workloads"], workload, "workload")
    config = load_config(cell["config"], base)
    suite = load_suite(config, base)
    mix = load_mix(cell["traffic"], base)
    sf = suite.scale(config, sf)
    on_card = device == "cuda"
    rec = Records(cell=cell)
    parts = rec.setup_parts
    if on_card:
        torch.cuda.init()
        torch.cuda.get_device_name(0)
    parts["import_and_card_s"] = time.perf_counter() - T0

    # the benchmark's own data and traffic (not set-up)
    t = time.perf_counter()
    tables = suite.tables(config, sf)
    traffic = suite.traffic(config, mix, sf, seed)
    rec.params = traffic.params(0)
    harness_s = time.perf_counter() - t

    t = time.perf_counter()
    conn = suite.connect(config, tables, sf, device)
    parts["connect_s"] = time.perf_counter() - t

    t = time.perf_counter()
    check_loaded_rows(conn, tables)
    harness_s += time.perf_counter() - t

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t = time.perf_counter()
    for _, n, sql in traffic.warmup():
        conn.sql(sql).strings()
    sync()
    parts["warmup_s"] = time.perf_counter() - t
    rec.setup_s = (parts["import_and_card_s"] + parts["connect_s"]
                   + parts["warmup_s"])
    parts["harness_data_s"] = harness_s
    print(f"set-up {rec.setup_s:.3f} s {parts}", file=log, flush=True)

    # ------------------------------------------------------------- window
    # the distinct rows each query returned, by (parameter set, query
    # number) without refresh functions and by (cycle, query number) with
    # them: bounded, so the window's heap does not grow with its length
    rows_of: dict = {}
    attempted = failed = 0
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()

    def span(name):
        if not traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    with span("window"):
        start = time.perf_counter()
        deadline = start + seconds
        c = 0
        while True:
            for step in traffic.cycle(c):
                attempted += 1
                kind = step[0]
                try:
                    if kind == "query":
                        n, sql = step[1], step[2]
                        name = traffic.label(n)
                        t0 = time.perf_counter()
                        with span(f"sql:{name}"):
                            res = conn.sql(sql)
                            t1 = time.perf_counter()
                            if traced:
                                sync()
                        t2 = time.perf_counter()
                        with span(f"strings:{name}"):
                            rows = res.strings()
                        t3 = time.perf_counter()
                        rec.queries.append((n, t3 - t0, t1 - t0, t3 - t2, c))
                        key = (c if traffic.refresh
                               else c % len(traffic.param_sets), n)
                        kept = rows_of.setdefault(key, [])
                        if not any(rows == k for k in kept):
                            kept.append(rows)
                        del rows, res
                    else:
                        t0 = time.perf_counter()
                        with span(kind):
                            statuses = [conn.sql(s).status for s in step[2]]
                        rec.refreshes.append((kind, step[1],
                                              time.perf_counter() - t0,
                                              statuses, c))
                except Exception:
                    failed += 1
                    print(f"cycle {c} step {kind} {step[1]} failed:\n"
                          + traceback.format_exc(), file=log, flush=True)
                    if kind != "query":     # end the refresh's transaction
                        with contextlib.suppress(Exception):
                            conn.sql("ROLLBACK")
            c += 1
            if time.perf_counter() >= deadline:
                break
        rec.window_s = time.perf_counter() - start
    cycles = c
    if traced:
        prof.__exit__(None, None, None)
        t = time.perf_counter()
        rec.trace = trace.collect(prof)
        del prof
        print(f"trace read in {time.perf_counter() - t:.3f} s: "
              f"{len(rec.trace['device'])} device events, "
              f"{len(rec.trace['spans'])} spans; events by kind "
              f"{rec.trace['kinds']}", file=log, flush=True)

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    del conn
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---------------------------------------------------------- correctness
    t = time.perf_counter()
    rec.db = suite.reference(config, tables, sf)
    compared = suite.verify(rec.db, traffic, sf, seed, cycles, rows_of,
                            len(rec.queries), rec.refreshes)
    ok = (failed == 0 and all(v <= check.LIMITS[k]
                              for k, v in compared.items()))
    print(f"reference and comparison {time.perf_counter() - t:.3f} s over "
          f"{cycles} cycles", file=log, flush=True)

    # -------------------------------------------------------------- metrics
    metrics = {}
    for m in metrics_for(bench, workload, traced):
        value = load_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind_name,
           "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        w = trace.window(rec.trace)
        dev["busy_s"] = trace.busy_s(rec.trace) or 0.0
        dev["window_s"] = (w[1] - w[0]) / 1e9 if w else rec.window_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(rec.trace),
                               "idle_gaps": trace.idle_gaps(rec.trace)}
    result["compared"] = {k: {"value": v, "limit": check.LIMITS[k]}
                          for k, v in compared.items()}
    print(f"{len(rec.queries)} queries, {len(rec.refreshes)} refresh "
          f"functions in {rec.window_s:.3f} s", file=log)
    print(per_query_table(rec, traffic.label), file=log)
    for k, v in compared.items():
        print(f"{k} {v!r} limit {check.LIMITS[k]!r}", file=log, flush=True)
    return result, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    bench = load_benchmark()
    cell = find(bench["workloads"], args.workload, "workload")
    import torch
    need = int(cell.get("chips", 1))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"needs {need} CUDA device(s); found {have}: no result",
              file=sys.stderr)
        return 2
    result, _ = run_cell(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace))
    stray = forbidden_modules()
    if stray:
        print("loaded in the process that reports: " + ", ".join(stray),
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
