"""db-benchmark's group-by task: the suite of the configurations that name
`"suite": "h2o"`.

H2O.ai's db-benchmark, kept since 2023 by DuckDB Labs
(`duckdblabs/db-benchmark`): one table `x`, drawn by
`_data/groupby-datagen.R` (N rows, K groups, here no NA and unsorted), and
the ten questions of its group-by task as `duckdb/groupby-duckdb.R` asks
them.

- **Data** (`tables`): groupby-datagen.R's rules, drawn with NumPy from
  the run's `--seed` (R's generator is not reproduced): `id1`, `id2`
  uniform over "id001".."idK", `id3` over "id0000000001".."id{N/K}", `id4`,
  `id5` uniform over 1..K, `id6` over 1..N/K, `v1` 1..5, `v2` 1..15, `v3`
  uniform over [0, 100) rounded to 6 decimals.  The ids are `|S` bytes,
  the integers int32, `v3` float64.  `run.py` hands the seed to `traffic`,
  not to `tables`; so `tables` returns an empty holder and `traffic` fills
  it, as `suites/ssb.py` does (neither is timed).
- **Connect**: `connect(None)` and `register_numpy("x", ...)`;
  db-benchmark makes no index, so there is none.
- **Traffic**: one client in a closed loop, questions 1-10 in order, each
  sent as one statement `SELECT count(*) AS out_rows, <checksum> FROM
  (<question>) AS ans`: db-benchmark's protocol (the answer made in the
  engine, then its row count and checksum) in one statement, so that no
  answer's rows are rendered to the client (question 10's has about N).
  The checksum is db-benchmark's `chk` (the sum of each answer column)
  with terms that change when rows go to the wrong group
  (`h2o_reference.terms`: squares, and sums weighted by integer keys).
- **Reference** (`tpchbench/h2o_reference.py`): plain PyTorch in float64,
  on the card where there is one; `verify` holds the one row of each
  answer of the window to the reference's: the integers exact, the DOUBLEs
  to `check.LIMITS`.  The control computes in float32.
"""

from __future__ import annotations

import weakref
from collections.abc import Mapping

import numpy as np
import torch

from tpchbench import check
from tpchbench import h2o_reference as ref
from tpchbench.reference.queries import Answer

QUESTIONS = {
    1: "SELECT id1, sum(v1) AS v1 FROM x GROUP BY id1",
    2: "SELECT id1, id2, sum(v1) AS v1 FROM x GROUP BY id1, id2",
    3: "SELECT id3, sum(v1) AS v1, avg(v3) AS v3 FROM x GROUP BY id3",
    4: ("SELECT id4, avg(v1) AS v1, avg(v2) AS v2, avg(v3) AS v3 FROM x "
        "GROUP BY id4"),
    5: ("SELECT id6, sum(v1) AS v1, sum(v2) AS v2, sum(v3) AS v3 FROM x "
        "GROUP BY id6"),
    6: ("SELECT id4, id5, median(v3) AS median_v3, stddev(v3) AS sd_v3 "
        "FROM x GROUP BY id4, id5"),
    7: ("SELECT id3, max(v1) - min(v2) AS range_v1_v2 FROM x "
        "GROUP BY id3"),
    8: ("SELECT id6, largest2_v3 FROM (SELECT id6, v3 AS largest2_v3, "
        "row_number() OVER (PARTITION BY id6 ORDER BY v3 DESC) AS order_v3 "
        "FROM x WHERE v3 IS NOT NULL) sub_query WHERE order_v3 <= 2"),
    9: ("SELECT id2, id4, pow(corr(v1, v2), 2) AS r2 FROM x "
        "GROUP BY id2, id4"),
    10: ("SELECT id1, id2, id3, id4, id5, id6, sum(v3) AS v3, "
         "count(*) AS count FROM x GROUP BY id1, id2, id3, id4, id5, id6"),
}


def statement(n: int) -> str:
    """Question n with its checksum (`h2o_reference.terms`) around it."""
    chk = ", ".join(f"sum({c}) AS {a}" if w is None else
                    f"sum({c} * {w}) AS {a}"
                    for a, c, w, _ in ref.terms(n))
    return (f"SELECT count(*) AS out_rows, {chk} FROM ({QUESTIONS[n]}) "
            "AS ans")


# ------------------------------------------------------------------ data

def _ids(width: int, count: int) -> np.ndarray:
    return np.array([b"id%0*d" % (width, i) for i in range(1, count + 1)],
                    dtype=f"S{width + 2}")


def generate(n: int, k: int, seed: int) -> dict:
    """Table `x` of n rows and k groups, drawn from `seed`."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x420])
    nk = max(1, n // k)
    small, large = _ids(3, k), _ids(10, nk)
    i32 = np.int32
    return {"x": {
        "id1": small[rng.integers(0, k, n, dtype=i32)],
        "id2": small[rng.integers(0, k, n, dtype=i32)],
        "id3": large[rng.integers(0, nk, n, dtype=i32)],
        "id4": rng.integers(1, k + 1, n, dtype=i32),
        "id5": rng.integers(1, k + 1, n, dtype=i32),
        "id6": rng.integers(1, nk + 1, n, dtype=i32),
        "v1": rng.integers(1, 6, n, dtype=i32),
        "v2": rng.integers(1, 16, n, dtype=i32),
        "v3": np.round(rng.random(n) * 100.0, 6),
    }}


class Tables(Mapping):
    """`{"x": {column: array}}`, filled from the run's seed by `traffic`
    (or, read first, from the seed `traffic` was last given)."""

    def __init__(self, n: int, k: int):
        self.n, self.k = n, k
        self._data: dict | None = None

    def fill(self, seed: int):
        if self._data is None:
            self._data = generate(self.n, self.k, seed)

    def _get(self) -> dict:
        if self._data is None:
            if _SEED["seed"] is None:
                raise RuntimeError("table x is drawn from the run's seed: "
                                   "make the traffic first")
            self.fill(_SEED["seed"])
        return self._data

    def __getitem__(self, name):
        return self._get()[name]

    def __iter__(self):
        return iter(self._get())

    def __len__(self):
        return len(self._get())


_SEED: dict = {"seed": None}
_PENDING: list = []       # weak references to holders not yet filled


def scale(config: dict, sf: float | None = None) -> int:
    """The rows of `x` (a rehearsal gives its own)."""
    return int(config["rows"] if sf is None else sf)


def tables(config: dict, sf: int) -> Tables:
    t = Tables(sf, int(config["k"]))
    _PENDING.append(weakref.ref(t))
    return t


def connect(config: dict, tables: Mapping, sf: int, device: str):
    from duckdb_cubit_tpu_torch.api import connect
    conn = connect(None, device=device)
    conn.register_numpy("x", {c: np.array(a)
                              for c, a in tables["x"].items()})
    return conn


# --------------------------------------------------------------- traffic

class Traffic:
    """One client in a closed loop: the ten questions in order, with no
    parameters (one set)."""
    refresh = False

    def __init__(self, mix: dict, sf: int, seed: int):
        self.order = [int(n) for n in mix["order"]]
        self.param_sets = [{n: {} for n in self.order}]
        self.sf = sf

    @staticmethod
    def label(n: int) -> str:
        return f"h2o{n:02d}"

    def params(self, cycle: int) -> dict:
        return self.param_sets[0]

    def warmup(self) -> list:
        return self.cycle(0)

    def cycle(self, c: int) -> list:
        return [("query", n, statement(n)) for n in self.order]


def traffic(config: dict, mix: dict, sf: int, seed: int) -> Traffic:
    _SEED["seed"] = int(seed)
    while _PENDING:
        t = _PENDING.pop()()
        if t is not None and t.n == sf:
            t.fill(seed)
    return Traffic(mix, sf, seed)


# ------------------------------------------------------------- reference

def reference(config: dict, tables: Mapping, sf: int,
              dtype=torch.float64) -> dict:
    """The reference's database: table `x` (the roofline's byte rule reads
    it too) and its tensors, on the card where there is one."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    x = tables["x"]
    return {"x": x, "data": ref.load(x, device, dtype), "rows": {}}


def _cell(v, kind: str):
    if v is None:
        return "NULL"
    return str(v) if kind == "x" else v


def answer(n: int, db: dict) -> Answer:
    """The one row of question n's statement."""
    got = db["rows"].get(n)
    if got is None:
        row = ref.checksum(n, ref.answer(n, db["data"]))
        kinds = "x" + "".join(t[3] for t in ref.terms(n))
        got = db["rows"][n] = Answer(
            [[_cell(v, k) for v, k in zip(row, kinds)]], kinds)
    return got


def verify(db, traffic: Traffic, sf: int, seed: int, cycles: int,
           rows_of: dict, answered: int, refreshes: list) -> dict:
    """Every answer of the window against the reference's."""
    wrong, gap = cycles * len(traffic.order) - answered, 0.0
    for (_, n), got_list in sorted(rows_of.items()):
        for got in got_list:
            w, g = check.compare(got, answer(n, db))
            wrong += w
            gap = max(gap, g)
    return {"wrong_cells": wrong, "double_gap": gap}


def control(config: dict, tables: Mapping, traffic: Traffic) -> dict:
    """Per question, the reference in float32 held against float64."""
    exact = reference(config, tables, traffic.sf)
    low = reference(config, tables, traffic.sf, dtype=torch.float32)
    out = {}
    for n in traffic.order:
        out[n] = list(check.compare(answer(n, low).rows, answer(n, exact)))
    return out
