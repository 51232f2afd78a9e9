"""The control of the comparison that decides `correct`.

The control is the plain reference put in the engine's place and computed
one precision below what the configurations state (for TPC-H
`reference.queries.LOW`: DECIMAL in float64 dollars, DOUBLE in float32).
For each seed it answers the cell's queries, at the state the window's
first cycle queries, and holds those answers against the exact reference
with `check.compare`, through the configuration's suite (`suite.control`).
The readings must fail the limits in `check.LIMITS`.

    python3 -m tpchbench.control --workload <cell> --seeds 1 2 3

prints one JSON line per seed.  It needs no card: the chip's machine runs
it at the cell's own size so that its readings and the engine's come from
the same data.
"""

from __future__ import annotations

import argparse
import json
import time

from . import check, run


def readings(workload: str, seed: int, sf: float | None = None,
             bench: dict | None = None, base: str = run.HERE) -> dict:
    bench = bench or run.load_benchmark()
    cell = run.find(bench["workloads"], workload, "workload")
    config = run.load_config(cell["config"], base)
    suite = run.load_suite(config, base)
    sf = suite.scale(config, sf)
    traffic = suite.traffic(config, run.load_mix(cell["traffic"], base), sf,
                            seed)
    per_query = suite.control(config, suite.tables(config, sf), traffic)
    wrong = sum(w for w, _ in per_query.values())
    gap = max((g for _, g in per_query.values()), default=0.0)
    return {"workload": workload, "seed": seed, "sf": sf,
            "wrong_cells": wrong, "double_gap": gap, "per_query": per_query,
            "fails_limits": wrong > check.LIMITS["wrong_cells"]
            or gap > check.LIMITS["double_gap"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(args.workload, seed)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
