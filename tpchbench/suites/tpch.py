"""TPC-H: the suite of every configuration that names no other.

A suite is the engine-facing half of the benchmark, which `run.py` loads
by the configuration's `suite` (`run.load_suite`).  It provides:

- `scale(config, sf)`: the scale the run uses (`sf` overrides the
  configuration's, for rehearsals on the CPU);
- `tables(config, sf)`: the benchmark's own tables, `{table: {column:
  array}}`; not timed;
- `connect(config, tables, sf, device)`: the engine opened on `device`
  through its public API and loaded, from `tables` where the suite hands
  the engine the benchmark's own data (copies, where the engine may keep
  them); timed as `connect_s`.  `run.py` then checks that the engine holds
  the same rows as `tables`;
- `traffic(config, mix, sf, seed)`: an object with `warmup()`, `cycle(c)`,
  `params(c)`, `param_sets`, `order`, `refresh` and `label(n)`; a step is
  ("query", n, sql) or (kind, id, [statements]);
- `reference(config, tables, sf)`: the plain reference's database;
- `verify(db, traffic, sf, seed, cycles, rows_of, answered, refreshes)`:
  the numbers `check.LIMITS` holds the window to;
- `control(config, tables, traffic)`: per query, `[wrong_cells,
  double_gap]` of the reference one precision down against the exact one.

This one wraps the TPC-H modules beside `run.py` and moves none of them.
"""

from __future__ import annotations

from tpchbench import check, datagen, generator
from tpchbench.reference import queries
from tpchbench.reference import verify as _verify
from tpchbench.reference.db import Database


class Traffic(generator.Traffic):
    @staticmethod
    def label(n: int) -> str:
        return f"q{n:02d}"


def scale(config: dict, sf: float | None = None) -> float:
    return float(config["scale_factor"] if sf is None else sf)


def tables(config: dict, sf: float) -> dict:
    return datagen.base_tables(sf)


def connect(config: dict, tables: dict, sf: float, device: str):
    """The engine generates TPC-H itself (`connect(sf)`)."""
    from duckdb_cubit_tpu_torch.api import connect
    return connect(sf, device=device)


def traffic(config: dict, mix: dict, sf: float, seed: int) -> Traffic:
    return Traffic(mix, sf, seed)


def reference(config: dict, tables: dict, sf: float) -> Database:
    return Database(tables)


verify = _verify.verify


def control(config: dict, tables: dict, traffic: Traffic) -> dict:
    """The first cycle's queries, at the state they see: after its RF1
    where the mix refreshes."""
    db = Database(tables)
    if traffic.refresh:
        db.insert(*datagen.update_set(traffic.sf, traffic.update_set(0)))
    out = {}
    for n in traffic.order:
        p = traffic.params(0)[n]
        exact = queries.answer(n, db, p, queries.EXACT)
        low = queries.answer(n, db, p, queries.LOW)
        got = [[c if isinstance(c, str) else repr(float(c)) for c in row]
               for row in low.rows[:low.limit]]
        out[n] = list(check.compare(got, exact))
    return out
