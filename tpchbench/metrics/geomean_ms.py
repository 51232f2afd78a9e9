"""geomean_ms: the geometric mean of every query's latency in the window
(the core of TPC-H's Power@Size)."""

import math


def read(rec):
    if not rec.queries:
        return None
    logs = [math.log(q[1]) for q in rec.queries]
    return math.exp(sum(logs) / len(logs)) * 1000.0
