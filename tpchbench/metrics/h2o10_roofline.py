"""h2o10_roofline: the least bytes db-benchmark's question 10 must move
(h2o_roofline.h2o10_bytes: its seven input columns at their stored widths,
read once) over 3.35 TB/s, divided by the device time of every kernel,
copy and set inside its spans, per execution."""

from tpchbench import h2o_roofline, roofline, trace


def read(rec):
    db = rec.db
    if rec.trace is None or not isinstance(db, dict) or "x" not in db:
        return None
    device_s, runs = trace.device_s_in(rec.trace, ("sql:h2o10",
                                                   "strings:h2o10"))
    if runs == 0 or device_s <= 0:
        return None
    return roofline.share_pct(h2o_roofline.BYTES[10](db["x"]),
                              device_s / runs)
