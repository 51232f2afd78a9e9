"""prepare_hit_pct: the engine's prepare-cache hits over its lookups, in
percent, summed over the `db.sql` roots of the traced window (their
`prepare_hits` and `prepare_misses` counter deltas)."""

from tpchbench import spans


def read(rec):
    roots = spans.roots_in_window(rec)
    if roots is None:
        return None
    hits = sum(r.get("prepare_hits", 0) for r in roots)
    looked = hits + sum(r.get("prepare_misses", 0) for r in roots)
    return 100.0 * hits / looked if looked else None
