"""group_sort_pct.h2o: the share of the rows GroupAggregate grouped that
took the sort route (`group_rows_sort`) rather than dense codes
(`group_rows_dense`) or a foreign key's rows (`group_rows_fk`), in
percent, summed over the `db.sql` roots of the traced window."""

from tpchbench import spans

ROUTES = ("group_rows_dense", "group_rows_fk", "group_rows_sort")


def read(rec):
    roots = spans.roots_in_window(rec)
    if roots is None:
        return None
    rows = {r: sum(a.get(r, 0) for a in roots) for r in ROUTES}
    total = sum(rows.values())
    return 100.0 * rows["group_rows_sort"] / total if total else None
