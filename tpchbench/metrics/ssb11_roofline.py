"""ssb11_roofline: the least bytes SSB Q1.1's plan must move
(ssb_roofline.ssb11_bytes) over 3.35 TB/s, divided by the device time of
every kernel, copy and set inside Q1.1's spans, per execution."""

from tpchbench import roofline, ssb_roofline, trace


def read(rec):
    db = rec.db
    if rec.trace is None or not isinstance(db, dict) or "tables" not in db:
        return None
    device_s, runs = trace.device_s_in(rec.trace, ("sql:ssb11",
                                                   "strings:ssb11"))
    if runs == 0 or device_s <= 0:
        return None
    return roofline.share_pct(ssb_roofline.BYTES[11](db), device_s / runs)
