"""q12_roofline: the least bytes Q12's plan must move
(roofline.q12_bytes) over 3.35 TB/s, divided by the device time of every
kernel, copy and set inside Q12's spans, per execution."""

from tpchbench import roofline, trace


def read(rec):
    if rec.trace is None or rec.db is None or 12 not in rec.params:
        return None
    device_s, runs = trace.device_s_in(rec.trace, ("sql:q12",
                                                   "strings:q12"))
    if runs == 0 or device_s <= 0:
        return None
    return roofline.share_pct(roofline.BYTES[12](rec.db, rec.params[12]),
                              device_s / runs)
