"""The comparison that decides `correct`.

`compare(got, ref)` holds the rows an engine returned (`Result.strings()`)
against the reference's `Answer` and gives two numbers:

- `wrong_cells`: cells compared as text that differ, plus every cell of a
  row missing or extra.  Exact, so its limit is 0.
- `double_gap`: the widest relative gap of a DOUBLE cell, |got - ref| / |ref|
  (|got| where ref is 0).

Rows whose ORDER BY key is equal may come in any order, and with a LIMIT
the rows tied with the last one kept may be any of the tied ones.
"""

from __future__ import annotations

import math

# wrong_cells is exact.  double_gap's limit lies between its two readings
# on the H100 at SF1 (PERF.md, section 2): 2.3e-16, the widest of 71 sound
# runs, and 5.8e-8, the narrowest reading of the control
LIMITS = {"wrong_cells": 0, "double_gap": 1e-10}


def _gap(got: str, ref) -> float:
    if ref is None or ref == "NULL":
        return 0.0 if got == "NULL" else math.inf
    try:
        g = float(got)
    except ValueError:
        return math.inf
    if math.isnan(g):
        return math.inf
    r = float(ref)
    return abs(g - r) / abs(r) if r != 0 else abs(g)


def _row_cost(got: list, ref: list, kinds: str) -> tuple[int, float]:
    wrong, gap = 0, 0.0
    if len(got) != len(ref):
        return len(kinds), math.inf
    for g, r, k in zip(got, ref, kinds):
        if k == "f":
            gap = max(gap, _gap(g, r))
        elif g != r:
            wrong += 1
    return wrong, gap


def compare(got: list[list[str]], ref) -> tuple[int, float]:
    kinds = ref.kinds
    want = len(ref.rows) if ref.limit is None else min(ref.limit,
                                                       len(ref.rows))
    wrong = abs(len(got) - want) * len(kinds)
    gap = 0.0
    ncols = len(kinds)

    def key(row):
        return tuple(row[i] for i in ref.key) if ref.key else ()

    # the reference's rows grouped by ORDER BY key, in order
    groups: dict[tuple, list] = {}
    for r in ref.rows:
        groups.setdefault(key([_cell(c, k) for c, k in zip(r, kinds)]),
                          []).append(r)
    ref_keys = [key([_cell(c, k) for c, k in zip(r, kinds)])
                for r in ref.rows[:want]]
    for i, row in enumerate(got[:want]):
        if len(row) != ncols:
            wrong += ncols
            continue
        k = key(row)
        if i < len(ref_keys) and k != ref_keys[i]:
            # out of order, or a key that should not be there
            wrong += sum(1 for j in ref.key if row[j] != _cell(
                ref.rows[i][j], kinds[j]))
        pool = groups.get(k)
        if not pool:
            best = (ncols, math.inf)
        else:
            costs = [_row_cost(row, [_cell(c, t) for c, t in zip(r, kinds)],
                               kinds) for r in pool]
            j = min(range(len(costs)), key=lambda j: costs[j])
            best = costs[j]
            pool.pop(j)       # each reference row matches one row only
        wrong += best[0]
        gap = max(gap, best[1])
    return wrong, gap


def _cell(c, kind: str):
    """A reference cell as the engine prints it (DOUBLEs stay floats)."""
    if c is None:
        return "NULL"
    return c if kind == "f" else str(c)
