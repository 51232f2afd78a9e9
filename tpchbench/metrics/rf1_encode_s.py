"""rf1_encode_s: mean seconds per RF1 in the engine's `db.dml.encode` spans
(appended values to storage codes; a VARCHAR column's dictionary merged and
its stored codes remapped)."""

from tpchbench import spans


def read(rec):
    return spans.per_run_s(rec, ("db.dml.encode",), "rf1")
