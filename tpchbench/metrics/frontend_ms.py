"""frontend_ms: mean host milliseconds per query in the engine's spans
`db.parse`, `db.bind` and `db.optimize` (its own recorder, on the traced
run's clock, inside the harness's `sql:` spans)."""

from tpchbench import spans


def read(rec):
    s = spans.per_run_s(rec, ("db.parse", "db.bind", "db.optimize"), "sql:")
    return None if s is None else 1000.0 * s
