"""sql_call_ms.ssb: mean host milliseconds per query inside `conn.sql`
(parse, bind, optimize, prepare, enqueue, stage-boundary reads), from the
harness's host clock in the traced run, which synchronises the card after
the call; in the Star Schema Benchmark's cell."""


def read(rec):
    if rec.trace is None or not rec.queries:
        return None
    return 1000.0 * sum(q[2] for q in rec.queries) / len(rec.queries)
