"""device_idle_pct.ssb: the share of the traced window in which no kernel,
copy or set ran on the card, in the Star Schema Benchmark's cell."""

from tpchbench import trace


def read(rec):
    return trace.idle_pct(rec.trace)
