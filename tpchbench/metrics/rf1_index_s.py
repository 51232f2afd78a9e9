"""rf1_index_s: mean seconds per RF1 in the engine's `db.dml.cubit` and
`db.dml.pk` spans (CUBIT deltas, merges and rebuilds; the primary-key
indexes rebuilt)."""

from tpchbench import spans


def read(rec):
    return spans.per_run_s(rec, ("db.dml.cubit", "db.dml.pk"), "rf1")
