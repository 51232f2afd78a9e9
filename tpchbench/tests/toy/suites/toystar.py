"""A two-table star: a suite brought by files alone, which
`tests/test_tpchbench_suites.py` runs through `run.run_cell`.

`fact` holds an unsorted foreign key `f_dkey` into `dim`, whose keys
`d_key` are a permutation of 1..n.  The engine is opened empty
(`connect(None)`), the benchmark's arrays are registered with
`register_numpy`, and the configuration's indexes are built with
`CREATE UNIQUE INDEX` and `CREATE CUBIT INDEX ... WITH (bins=N)`.  Two
queries join the star; the reference answers them in NumPy.
"""

from __future__ import annotations

import numpy as np

from tpchbench import check
from tpchbench.reference.queries import Answer

GROUPS = [f"GROUP#{i}".encode() for i in range(5)]
INDEXES = ("CREATE UNIQUE INDEX ON dim(d_key)",
           "CREATE CUBIT INDEX ON fact(f_qty) WITH (bins=8)")


def scale(config: dict, sf: float | None = None) -> float:
    return float(config["scale"] if sf is None else sf)


def tables(config: dict, sf: float) -> dict:
    rng = np.random.default_rng(config["data_seed"])
    n_dim = max(1, int(config["rows"]["dim"] * sf))
    n_fact = max(1, int(config["rows"]["fact"] * sf))
    dim = {"d_key": rng.permutation(n_dim).astype(np.int64) + 1,
           "d_group": np.array(GROUPS)[rng.integers(0, len(GROUPS), n_dim)],
           "d_weight": rng.random(n_dim)}
    fact = {"f_dkey": rng.integers(1, n_dim + 1, n_fact).astype(np.int64),
            "f_qty": rng.integers(1, 51, n_fact).astype(np.int64),
            "f_price": rng.integers(100, 100_000, n_fact).astype(np.int64)}
    return {"dim": dim, "fact": fact}


def connect(config: dict, tables: dict, sf: float, device: str):
    from duckdb_cubit_tpu_torch.api import connect
    conn = connect(None, device=device)
    for name, cols in tables.items():
        conn.register_numpy(name, {c: np.array(a) for c, a in cols.items()})
    for stmt in INDEXES:
        conn.sql(stmt)
    return conn


def text(n: int, p: dict) -> str:
    if n == 1:
        return ("SELECT d_group, count(*) AS n, sum(f_qty) AS qty "
                "FROM fact, dim WHERE f_dkey = d_key "
                f"AND f_qty BETWEEN {p['lo']} AND {p['hi']} "
                "GROUP BY d_group ORDER BY d_group")
    return ("SELECT sum(f_price * d_weight) AS w FROM fact, dim "
            f"WHERE f_dkey = d_key AND d_group = '{p['group']}' "
            f"AND f_qty < {p['below']}")


class Traffic:
    refresh = False

    def __init__(self, mix: dict, sf: float, seed: int):
        rng = np.random.default_rng([int(seed) & (2**64 - 1)])
        self.order = [int(n) for n in mix["order"]]
        self.param_sets = []
        for _ in range(int(mix["substitution_sets"])):
            lo = int(rng.integers(1, 30))
            self.param_sets.append({
                1: {"lo": lo, "hi": lo + int(rng.integers(5, 20))},
                2: {"group": GROUPS[int(rng.integers(0, len(GROUPS)))]
                    .decode(), "below": int(rng.integers(20, 51))}})

    @staticmethod
    def label(n: int) -> str:
        return f"star{n}"

    def params(self, cycle: int) -> dict:
        return self.param_sets[cycle % len(self.param_sets)]

    def warmup(self) -> list:
        seen, steps = set(), []
        for c in range(len(self.param_sets)):
            for step in self.cycle(c):
                if step[2] not in seen:
                    seen.add(step[2])
                    steps.append(step)
        return steps

    def cycle(self, c: int) -> list:
        p = self.params(c)
        return [("query", n, text(n, p[n])) for n in self.order]


def traffic(config: dict, mix: dict, sf: float, seed: int) -> Traffic:
    return Traffic(mix, sf, seed)


def reference(config: dict, tables: dict, sf: float) -> dict:
    return tables


def answer(n: int, db: dict, p: dict, low: bool = False) -> Answer:
    """Query n in NumPy; `low` sums DOUBLEs in float32 (the control)."""
    dim, fact = db["dim"], db["fact"]
    row = np.full(int(dim["d_key"].max()) + 1, -1, dtype=np.int64)
    row[dim["d_key"]] = np.arange(len(dim["d_key"]))
    r = row[fact["f_dkey"]]
    qty = fact["f_qty"]
    if n == 1:
        m = (qty >= p["lo"]) & (qty <= p["hi"])
        g = dim["d_group"][r[m]]
        return Answer([[k.decode(), str(int((g == k).sum())),
                        str(int(qty[m][g == k].sum()))]
                       for k in np.unique(g)], "xxx", key=(0,))
    m = (dim["d_group"][r] == p["group"].encode()) & (qty < p["below"])
    w = fact["f_price"][m] * dim["d_weight"][r[m]]
    return Answer([[float(w.astype(np.float32).sum(dtype=np.float32))
                    if low else float(w.sum())]], "f")


def verify(db, traffic: Traffic, sf: float, seed: int, cycles: int,
           rows_of: dict, answered: int, refreshes: list) -> dict:
    """Every answer of the window against the reference's."""
    wrong, gap = cycles * len(traffic.order) - answered, 0.0
    for (s, n), got_list in sorted(rows_of.items()):
        ref = answer(n, db, traffic.param_sets[s][n])
        for got in got_list:
            w, g = check.compare(got, ref)
            wrong += w
            gap = max(gap, g)
    return {"wrong_cells": wrong, "double_gap": gap}


def control(config: dict, tables: dict, traffic: Traffic) -> dict:
    out = {}
    for n in traffic.order:
        p = traffic.params(0)[n]
        low = answer(n, tables, p, low=True)
        got = [[c if isinstance(c, str) else repr(c) for c in r]
               for r in low.rows]
        out[n] = list(check.compare(got, answer(n, tables, p)))
    return out
