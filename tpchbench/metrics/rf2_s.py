"""rf2_s: mean seconds per RF2 (BEGIN, its statements, COMMIT), from
the harness's spans."""


def read(rec):
    times = [r[2] for r in rec.refreshes if r[0] == "rf2"]
    return sum(times) / len(times) if times else None
