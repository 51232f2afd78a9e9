"""sort_probe_pct.ssb: the share of join probe rows that took the
sort-merge probe (`sort_probe_rows`) rather than a key-to-row table
(`pk_probe_rows`), in percent, summed over the `db.sql` roots of the
traced window.  0 while every star join probes a key-to-row table."""

from tpchbench import spans


def read(rec):
    roots = spans.roots_in_window(rec)
    if roots is None:
        return None
    pk = sum(r.get("pk_probe_rows", 0) for r in roots)
    srt = sum(r.get("sort_probe_rows", 0) for r in roots)
    return 100.0 * srt / (pk + srt) if pk + srt else None
