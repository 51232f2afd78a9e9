"""render_ms: mean host milliseconds per query in `Result.strings()`, after
the traced run's synchronise."""


def read(rec):
    if rec.trace is None or not rec.queries:
        return None
    return 1000.0 * sum(q[3] for q in rec.queries) / len(rec.queries)
