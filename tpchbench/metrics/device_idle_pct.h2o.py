"""device_idle_pct.h2o: the share of the traced window in which no kernel,
copy or set ran on the card, in db-benchmark's group-by cell."""

from tpchbench import trace


def read(rec):
    return trace.idle_pct(rec.trace)
