"""Where a TPC-H plan's time goes on the card: host and device time per
operator, per host-evaluated expression and per executor phase.

    python -m duckdb_cubit_tpu_torch.benchmarks.plan_profile --sf 1 \
        --queries 7 9 13 16 22

Each plan of `tpch/queries.py` runs `--runs` times under torch.profiler
after one warm run.  For the profile only, `PhysicalOperator.execute` runs
an operator's children first and then its own `_execute` inside a range
named `op:<operator>`, so a range holds the operator's own work (an
operator that skips a child, as the fused scan-sum skips its scan, has the
child run here all the same).  LIKE, substring, year and IN evaluations run
inside `expr:<class>` ranges (nested in their operator's range), and the
optimizer, the prepare step, the check read and the rendering of rows
inside `phase:<name>` ranges (`phase:query` holds the whole plan but the
rendering).  Per range: host ms per run (inclusive) and
the device ms of the kernels and copies it launched.  Device-to-host
copies are listed with the range and the op that issued them.  One JSON
line per plan; on a CPU device the device columns are 0.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..exec import executor as X
from ..exec.result import to_strings
from ..ops import expressions as E
from ..plan import optimizer as opt
from ..plan import physical as P
from ..tpch import queries

EXPRESSIONS = ("Like", "Substr", "ExtractYear", "InList")


def _ranged(fn, label):
    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def _execute_in_range(self, ctx):
    """`PhysicalOperator.execute` with the children first, then the
    operator's own work inside its range."""
    key = id(self)
    if key not in ctx._cache:
        for c in self.children:
            c.execute(ctx)
        with record_function(f"op:{self.name}"):
            ctx._cache[key] = self._execute(ctx)
    return ctx._cache[key]


@contextlib.contextmanager
def ranges():
    """The profile's ranges, patched in for the duration."""
    saved = [(P.PhysicalOperator, "execute",
              P.PhysicalOperator.execute),
             (opt, "optimize", opt.optimize),
             (X.Executor, "_prepare", X.Executor._prepare),
             (X.Executor, "_failed_checks", X.Executor.__dict__[
                 "_failed_checks"])]
    saved += [(getattr(E, n), "eval", getattr(E, n).eval)
              for n in EXPRESSIONS]
    try:
        P.PhysicalOperator.execute = _execute_in_range
        opt.optimize = _ranged(opt.optimize, "phase:optimize")
        X.Executor._prepare = _ranged(X.Executor._prepare, "phase:prepare")
        X.Executor._failed_checks = _ranged(X.Executor._failed_checks,
                                            "phase:checks")
        for n in EXPRESSIONS:
            cls = getattr(E, n)
            cls.eval = _ranged(cls.eval, f"expr:{n}")
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def _device_us(event) -> float:
    return getattr(event, "device_time_total",
                   getattr(event, "cuda_time_total", 0.0))


def _range_of(event) -> str:
    """The innermost profile range around a host event."""
    e = event
    while e is not None:
        if e.name.split(":")[0] in ("op", "expr", "phase"):
            return e.name
        e = e.cpu_parent
    return "(outside the ranges)"


def profile_plan(conn, n: int, runs: int) -> dict:
    """One plan under the profiler; -> its summary (ms per run)."""
    def run():
        with record_function("phase:query"):
            rel = queries.run(conn.executor, n)
        with record_function("phase:to_strings"):
            return to_strings(rel)

    cuda = conn.device.type == "cuda"
    run()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with ranges(), profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    per_range = {}
    for e in prof.key_averages():
        if e.key.split(":")[0] in ("op", "expr", "phase") and \
                e.device_type != torch.autograd.DeviceType.CUDA:
            per_range[e.key] = {
                "host_ms": e.cpu_time_total / 1e3 / runs,
                "device_ms": _device_us(e) / 1e3 / runs,
                "calls": e.count / runs}
    copies = collections.Counter()
    for e in prof.events():
        for k in getattr(e, "kernels", []):
            if "DtoH" in k.name:
                copies[f"{_range_of(e)} / {e.name}"] += \
                    k.duration / 1e3 / runs
    device_ms = sum(_device_us(e) for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e3 / runs
    return {"query": n, "wall_ms": wall_ms, "device_ms": device_ms,
            "ranges": dict(sorted(per_range.items(),
                                  key=lambda kv: -kv[1]["host_ms"])),
            "dtoh_ms": dict(copies.most_common(8))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--queries", type=int, nargs="*",
                    default=sorted(queries.QUERIES))
    args = ap.parse_args(argv)
    from ..api import connect
    from .timing import card_line

    conn = connect(sf=args.sf, device=args.device)
    card = card_line() if conn.device.type == "cuda" else "cpu"
    for n in args.queries:
        out = profile_plan(conn, n, args.runs)
        out["card"] = card
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
