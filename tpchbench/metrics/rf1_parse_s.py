"""rf1_parse_s: mean seconds per RF1 in the engine's `db.parse` and
`db.insert.literals` spans (the INSERT texts parsed, each literal cell
converted)."""

from tpchbench import spans


def read(rec):
    return spans.per_run_s(rec, ("db.parse", "db.insert.literals"), "rf1")
