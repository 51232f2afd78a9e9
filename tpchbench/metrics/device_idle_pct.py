"""device_idle_pct: the share of the traced window in which no kernel, copy
or set ran on the card."""

from tpchbench import trace


def read(rec):
    return trace.idle_pct(rec.trace)
