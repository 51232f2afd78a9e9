"""query_p95_ms: the 95th percentile of every query's latency in the window,
from the `conn.sql` call to the end of `Result.strings()`."""

import numpy as np


def read(rec):
    if not rec.queries:
        return None
    return float(np.percentile([q[1] for q in rec.queries], 95)) * 1000.0
