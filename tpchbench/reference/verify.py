"""Hold what a window returned against the plain reference.

Without refresh functions every answer of the window is compared: the
query's rows of each stream (streams that returned the same rows are
compared once).  With them, each refresh statement's reported row count is
compared with the reference's, and one cycle, drawn from the seed after
the window, has all its queries compared against the reference's tables as
that cycle's RF1 left them.
"""

from __future__ import annotations

from .. import check, datagen, generator
from . import queries


def _status_wrong(got: list, want: list) -> int:
    if len(got) != len(want):
        return max(len(got), len(want))
    return sum(1 for g, w in zip(got, want)
               if str(g).split(" (")[0] != w)


def verify(db, traffic, sf: float, seed: int, cycles: int, rows_of: dict,
           answered: int, refreshes: list, num=queries.EXACT) -> dict:
    """`rows_of` maps (parameter set, or cycle with refresh functions, query
    number) to the distinct rows the window returned; `answered` counts the
    queries that returned."""
    wrong, gap = 0, 0.0
    # answers due in the window that never came (a failed query)
    wrong += cycles * len(traffic.order) - answered

    def hold(n: int, c: int, got_list: list, state):
        nonlocal wrong, gap
        ref = queries.answer(n, state, traffic.params(c)[n], num)
        for got in got_list:
            w, g = check.compare(got, ref)
            wrong += w
            gap = max(gap, g)

    if not traffic.refresh:
        for (s, n), got in sorted(rows_of.items()):
            hold(n, s, got, db)
        return {"wrong_cells": wrong, "double_gap": gap}

    chosen = int(generator.seed_rng(seed, 1).integers(0, max(cycles, 1)))
    state = db.copy()
    done = {(kind, c): st for kind, _, _, st, c in refreshes}
    for c in range(cycles):
        u = traffic.update_set(c)
        orders, lineitem = datagen.update_set(sf, u)
        state.insert(orders, lineitem)
        wrong += _status_wrong(done.get(("rf1", c), []), [
            "BEGIN", f"INSERT {len(orders['o_orderkey'])}",
            f"INSERT {len(lineitem['l_orderkey'])}", "COMMIT"])
        if c == chosen:
            for n in traffic.order:
                if (c, n) in rows_of:
                    hold(n, c, rows_of[(c, n)], state)
        n_lines, n_orders = state.delete(datagen.delete_keys(sf, u))
        wrong += _status_wrong(done.get(("rf2", c), []), [
            "BEGIN", f"DELETE {n_lines}", f"DELETE {n_orders}", "COMMIT"])
    return {"wrong_cells": wrong, "double_gap": gap}
