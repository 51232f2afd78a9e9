"""The byte rules of the Star Schema Benchmark's roofline shares.

The least bytes a query's plan must move, counted from the suite's own
arrays with `roofline.scan_sum_bytes` and `roofline.gather_bytes`' rule and
divided, as `roofline.share_pct` does, by the card's published bandwidth:

- each fact column is read over the rows that reach it in the plan's join
  order (EXPLAIN's), one 32-B sector for each 8 rows that hold one;
- a CUBIT-filtered scan reads the words of its bitmap once;
- each key-to-row probe writes its outputs and reads its tables
  (`gather_bytes` with one table for the row and one for each dimension
  column the query reads after the join); its keys are counted with their
  fact column.

The rows that reach each step are followed as sorted row numbers through
the reference's key-to-row maps (`suites/ssb.fact_rows`, cached on the
reference's `db`), so that only the first step passes over the whole fact
table.
"""

from __future__ import annotations

import numpy as np

from .suites.ssb import fact_rows

_DIM = {"c": ("lo_custkey", "customer", "c_custkey"),
        "s": ("lo_suppkey", "supplier", "s_suppkey"),
        "p": ("lo_partkey", "part", "p_partkey"),
        "d": ("lo_orderdate", "ddate", "d_datekey")}


def sectors(at: np.ndarray) -> int:
    """Bytes of one int32 fact column read at the sorted rows `at`: one
    32-B sector for each 8-row group that holds one (`scan_sum_bytes` less
    the bitmap's words)."""
    if len(at) == 0:
        return 0
    group = at >> 3
    return 32 * (1 + int(np.count_nonzero(group[1:] != group[:-1])))


def probe_bytes(keys: np.ndarray, tables: int) -> int:
    """A probe of `keys` (or of the dimension rows they map to, one for
    one) into `tables` slot tables: `gather_bytes` less the keys' own read,
    with the distinct keys counted by a bincount (the sort `gather_bytes`
    runs takes seconds over the fact table's keys)."""
    n = len(keys)
    if n == 0:
        return 0
    distinct = int(np.count_nonzero(np.bincount(keys - keys.min())))
    return 4 * n * tables + 32 * tables * (distinct >> 3)


def _words(n: int) -> int:
    """Bytes of the bitmap over n rows."""
    return 4 * ((n + 31) // 32)


def ssb11_bytes(db: dict) -> int:
    """Q1.1: the scan of the CUBIT ranges' rows (`lo_discount` 1-3,
    `lo_quantity` < 25) reading `lo_orderdate`, its probe of the date table
    (`d_year` = 1993), and the two measure columns at the rows left."""
    lo = db["tables"]["lineorder"]
    disc = lo["lo_discount"]
    cand = np.flatnonzero((disc >= 1) & (disc <= 3)
                          & (lo["lo_quantity"] < 25))
    rows = fact_rows(db, *_DIM["d"])[cand]
    kept = cand[db["tables"]["ddate"]["d_year"][rows] == 1993]
    return (_words(len(disc)) + sectors(cand) + probe_bytes(rows, 1)
            + 2 * sectors(kept))


def ssb41_bytes(db: dict) -> int:
    """Q4.1: the whole of `lo_custkey` and its probe of customer
    (`c_region` = AMERICA; the row and `c_nation`), then in EXPLAIN's order
    the supplier probe (`s_region` = AMERICA), the part probe (`p_mfgr`
    MFGR#1 or #2) and the date probe (the row and `d_year`), each at the
    rows the earlier ones kept, and the two measure columns at the last."""
    t = db["tables"]
    america = np.bytes_(b"AMERICA")
    steps = [("c", lambda d: d["c_region"] == america, 2),
             ("s", lambda d: d["s_region"] == america, 1),
             ("p", lambda d: np.isin(d["p_mfgr"], [b"MFGR#1", b"MFGR#2"]), 1),
             ("d", lambda d: np.ones(len(d["d_datekey"]), dtype=bool), 2)]
    at = np.arange(len(t["lineorder"]["lo_custkey"]))
    total = 0
    for p, keep, tables in steps:
        fk, dim, key = _DIM[p]
        rows = fact_rows(db, fk, dim, key)[at]
        total += sectors(at) + probe_bytes(rows, tables)
        at = at[keep(t[dim])[rows]]
    return total + 2 * sectors(at)


BYTES = {11: ssb11_bytes, 41: ssb41_bytes}
