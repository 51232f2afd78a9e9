"""operator_self_ms.h2o: mean host milliseconds per question in the
engine's `db.op.*` spans, each less the engine's spans nested directly in
it (child operators, a quantile's `db.agg.median`, waits); in
db-benchmark's group-by cell."""

from tpchbench import spans


def read(rec):
    s = spans.per_run_s(rec, ("db.op.",), "sql:", self_time=True)
    return None if s is None else 1000.0 * s
