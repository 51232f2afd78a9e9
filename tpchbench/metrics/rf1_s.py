"""rf1_s: mean seconds per RF1 (BEGIN, its statements, COMMIT), from
the harness's spans."""


def read(rec):
    times = [r[2] for r in rec.refreshes if r[0] == "rf1"]
    return sum(times) / len(times) if times else None
