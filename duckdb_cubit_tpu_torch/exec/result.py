"""Result materialization: device Relation -> host rows, DuckDB-style text.

Counterpart of `duckdb_cubit_tpu/exec/result.py`, character for character:
decimals print with their full scale, dates ISO, doubles shortest
round-trip.
"""

from __future__ import annotations

from ..plan.physical import Relation
from ..types import TypeId, days_to_date


def format_decimal(v: int, scale: int) -> str:
    if scale == 0:
        return str(int(v))
    v = int(v)
    sign = "-" if v < 0 else ""
    v = abs(v)
    ip, fp = divmod(v, 10**scale)
    return f"{sign}{ip}.{fp:0{scale}d}"


def format_value(v, dtype, dictionary=None) -> str:
    if v is None:
        return "NULL"
    if dtype.id == TypeId.DECIMAL:
        return format_decimal(int(v), dtype.scale)
    if dtype.id == TypeId.DATE:
        return days_to_date(int(v)).isoformat()
    if dtype.id == TypeId.VARCHAR:
        return dictionary[int(v)].decode("latin-1")
    if dtype.id == TypeId.CHAR1:
        return chr(int(v))
    if dtype.id == TypeId.DOUBLE:
        return repr(float(v))
    if dtype.id == TypeId.BOOL:
        return "true" if v else "false"
    return str(int(v))


def materialize(rel: Relation, columns: list[str] | None = None):
    """-> (column_names, list of row tuples of python values, metas)."""
    names = columns or list(rel.columns.keys())
    mask = rel.mask.cpu().numpy()
    host = {}
    for n in names:
        c = rel.columns[n]
        arr = c.array.cpu().numpy()[mask]
        if c.valid is not None:
            valid = c.valid.cpu().numpy()[mask]
            arr = [None if not v else a for a, v in zip(arr.tolist(), valid)]
        host[n] = (arr, c.dtype, c.dictionary)
    n_rows = int(mask.sum())
    rows = []
    for i in range(n_rows):
        rows.append(tuple(host[n][0][i] for n in names))
    return names, rows, [(host[n][1], host[n][2]) for n in names]


def to_strings(rel: Relation, columns: list[str] | None = None) -> list[list[str]]:
    names, rows, metas = materialize(rel, columns)
    out = []
    for row in rows:
        out.append([format_value(v, dt, d) for v, (dt, d) in zip(row, metas)])
    return out
