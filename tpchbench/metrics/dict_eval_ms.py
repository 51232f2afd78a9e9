"""dict_eval_ms: mean host milliseconds per query in the engine's
`db.dict.*` spans, its host walks over whole dictionaries (LIKE and IN
truth tables, substring, the string maps, concat)."""

from tpchbench import spans


def read(rec):
    s = spans.per_run_s(rec, ("db.dict.",), "sql:")
    return None if s is None else 1000.0 * s
