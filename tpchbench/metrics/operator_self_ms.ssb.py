"""operator_self_ms.ssb: mean host milliseconds per query in the engine's
`db.op.*` spans, each less the engine's spans nested directly in it (child
operators, dictionary walks, probes, waits); in the Star Schema Benchmark's
cell."""

from tpchbench import spans


def read(rec):
    s = spans.per_run_s(rec, ("db.op.",), "sql:", self_time=True)
    return None if s is None else 1000.0 * s
