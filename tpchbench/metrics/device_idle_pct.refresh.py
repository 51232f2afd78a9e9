"""device_idle_pct.refresh: the share of the traced window in which no
kernel, copy or set ran on the card, in a cell with refresh functions,
where it moves refresh_s."""

from tpchbench import trace


def read(rec):
    return trace.idle_pct(rec.trace)
