"""The control of the comparison that decides `correct`.

The control is the plain reference put in the engine's place and computed
one precision below what the configurations state (`reference.queries.LOW`:
DECIMAL in float64 dollars, DOUBLE in float32).  For each seed it answers
the cell's 22 queries, at the state the window's first cycle queries, and
holds those answers against the exact reference with `check.compare`.  The
readings must fail the limits in `check.LIMITS`.

    python3 -m tpchbench.control --workload <cell> --seeds 1 2 3

prints one JSON line per seed.  It needs no card: the chip's machine runs
it at the cell's own size so that its readings and the engine's come from
the same data.
"""

from __future__ import annotations

import argparse
import json
import time

from . import check, datagen, generator, run
from .reference import queries
from .reference.db import Database


def readings(workload: str, seed: int, sf: float | None = None,
             bench: dict | None = None) -> dict:
    bench = bench or run.load_benchmark()
    cell = run.find(bench["workloads"], workload, "workload")
    config = run.load_config(cell["config"])
    sf = float(config["scale_factor"] if sf is None else sf)
    traffic = generator.Traffic(generator.load_mix(cell["traffic"]), sf, seed)
    db = Database(datagen.base_tables(sf))
    if traffic.refresh:
        db.insert(*datagen.update_set(sf, traffic.update_set(0)))
    wrong, gap, per_query = 0, 0.0, {}
    for n in traffic.order:
        p = traffic.params(0)[n]
        exact = queries.answer(n, db, p, queries.EXACT)
        low = queries.answer(n, db, p, queries.LOW)
        got = [[c if isinstance(c, str) else repr(float(c)) for c in row]
               for row in low.rows[:low.limit]]
        w, g = check.compare(got, exact)
        per_query[n] = [w, g]
        wrong += w
        gap = max(gap, g)
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
