"""host_wait_ms.ssb: mean host milliseconds per query in the engine's
`db.wait` spans, where the host blocks on a device read (stage-boundary
counts, check flags, the result's count under a deadline); in the Star
Schema Benchmark's cell."""

from tpchbench import spans


def read(rec):
    s = spans.per_run_s(rec, ("db.wait",), "sql:")
    return None if s is None else 1000.0 * s
