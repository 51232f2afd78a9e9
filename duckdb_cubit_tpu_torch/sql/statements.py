"""Non-SELECT statements: DDL, DML, SET, transactions, PRAGMA, EXPLAIN.

Counterpart of `duckdb_cubit_tpu/sql/statements.py`, built on the port's
storage (`storage/table.from_numpy`, `storage/dml`), indexes and
`EngineConfig`.  Each statement that changes a table bumps its version (or
replaces it), so the executor's prepare cache never serves a plan built
for the old table.  DELETE and UPDATE find their rows by running the WHERE
predicate through the query path (`_match_rows`); BEGIN / COMMIT /
ROLLBACK go to the connection's snapshot transactions (`api.py`).  EXPLAIN
ANALYZE runs the optimized plan once with the profiler and appends each
operator's milliseconds and rows; PRAGMA enable_verification /
disable_verification set the session's verification.  On a mesh every rank
runs each statement, with the same global row ids (`storage/dml.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..exec import profiler as PROF
from ..exec import result as R
from ..index.cubit import CubitIndex
from ..index.pk import DirectPKIndex
from ..ops.expressions import _as_double, _wide
from ..plan.physical import TableScan
from ..storage import dml
from ..storage.table import from_numpy
from ..types import (BOOL, CHAR1, DATE, DOUBLE, INT32, INT64, VARCHAR,
                     DataType, TypeId, date_to_days, decimal_to_int)
from . import ast as A


class StatementError(ValueError):
    pass


_TYPE_MAP = {
    "integer": INT32, "int": INT32, "int4": INT32, "smallint": INT32,
    "bigint": INT64, "int8": INT64, "hugeint": INT64,
    "double": DOUBLE, "float": DOUBLE, "real": DOUBLE, "float8": DOUBLE,
    "date": DATE,
    "varchar": VARCHAR, "text": VARCHAR, "string": VARCHAR,
    "boolean": BOOL, "bool": BOOL,
}


def _column_type(cd: A.ColumnDef) -> DataType:
    t = cd.type_name
    if t in ("decimal", "numeric"):
        scale = cd.params[1] if len(cd.params) > 1 else 2
        return DataType(TypeId.DECIMAL, scale)
    if t == "char":
        if cd.params and cd.params[0] == 1:
            return CHAR1
        return VARCHAR
    if t in _TYPE_MAP:
        return _TYPE_MAP[t]
    raise StatementError(f"unsupported column type {t}")


def _empty_np(dtype: DataType) -> np.ndarray:
    if dtype.id == TypeId.VARCHAR:
        return np.array([], dtype="S1")
    return np.array([], dtype=dtype.np_dtype)


def _literal_value(node, dtype: DataType):
    """A literal (or signed literal) INSERT value in the column's host
    representation."""
    neg = False
    while isinstance(node, A.UnaryOp) and node.op == "-":
        neg = not neg
        node = node.child
    if isinstance(node, A.CastExpr):
        node = node.child
    if not isinstance(node, A.Literal):
        raise StatementError(f"INSERT values must be literals, got {node!r}")
    v = node.value
    if v is None:
        return None
    if dtype.id == TypeId.DECIMAL:
        out = decimal_to_int(v, dtype.scale)
        return -out if neg else out
    if dtype.id == TypeId.DATE:
        return date_to_days(str(v))
    if dtype.id == TypeId.VARCHAR:
        return str(v).encode()
    if dtype.id == TypeId.CHAR1:
        s = str(v)
        if len(s) != 1:
            raise StatementError(f"CHAR(1) literal {v!r} not one char")
        return ord(s)
    if dtype.id == TypeId.DOUBLE:
        out = float(v)
        return -out if neg else out
    if dtype.id == TypeId.BOOL:
        return bool(v) if not isinstance(v, str) else v.lower() == "true"
    out = int(v)
    return -out if neg else out


def _match_rows(conn, table_name: str, where) -> np.ndarray:
    """The global host row ids a WHERE predicate selects (live rows only),
    the same on every rank of a mesh.  The predicate runs through the same
    TableScan / expression path as queries, so DML predicate semantics are
    exactly query semantics; the executor returns a replicated relation, so
    its mask is the whole table's.  Without a WHERE the live rows are read
    from `num_rows` and the (gathered) deleted mask."""
    with PROF.span("db.dml.match"):
        if where is None:
            return dml.live_row_ids(conn.catalog.table(table_name))
        with PROF.span("db.bind"):
            expr = conn.binder.bind_table_expr(table_name, where)
        rel = conn.executor.execute(TableScan(table_name, filters=[expr]),
                                    optimize=False, verify=False)
        return np.nonzero(rel.mask.cpu().numpy())[0]


def _host_values(arr, rowids: np.ndarray) -> np.ndarray:
    """A column (or a constant) at `rowids`, on the host."""
    if isinstance(arr, torch.Tensor) and arr.ndim == 1:
        return arr[torch.as_tensor(rowids, device=arr.device)].cpu().numpy()
    if isinstance(arr, torch.Tensor):
        arr = arr.item()
    return np.full(len(rowids), arr)


def _half_away(x: np.ndarray) -> np.ndarray:
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def _cast_values(t, dtype: DataType, rowids: np.ndarray) -> np.ndarray:
    """An evaluated expression's values at `rowids`, in the storage form of
    a column of `dtype` (a DECIMAL at the column's scale, rounded half away
    from zero where it narrows; the reference stores the raw values)."""
    if dtype.id == TypeId.DOUBLE:
        return _host_values(_as_double(t), rowids).astype(np.float64)
    src_scale = t.dtype.scale if t.dtype.id == TypeId.DECIMAL else 0
    dst_scale = dtype.scale if dtype.id == TypeId.DECIMAL else 0
    if t.dtype.id == TypeId.DOUBLE:
        v = _host_values(t.array, rowids).astype(np.float64)
        return _half_away(v * 10.0 ** dst_scale).astype(np.int64)
    v = _host_values(_wide(t.array), rowids).astype(np.int64)
    if dst_scale >= src_scale:
        return v * 10 ** (dst_scale - src_scale)
    p = 10 ** (src_scale - dst_scale)
    return np.sign(v) * ((np.abs(v) + p // 2) // p)


def _create_table_as(conn, stmt):
    if stmt.name in conn.catalog.tables:
        raise StatementError(f"table {stmt.name} already exists")
    rel = conn.executor.execute(conn.binder.bind(stmt.select))
    mask = rel.mask.cpu().numpy()
    data, schema, nullmasks = {}, {}, {}
    for cname, c in rel.columns.items():
        arr = c.array.cpu().numpy()[mask]
        if c.valid is not None:
            nm = ~c.valid.cpu().numpy()[mask]
            if nm.any():
                nullmasks[cname] = nm
        if c.dictionary is not None:
            data[cname] = np.asarray(c.dictionary)[arr]
        else:
            # a narrowed int8 / int16 column widens for the ingest (the
            # reference passes it on and its from_numpy refuses it)
            data[cname] = arr.astype(np.int32) \
                if arr.dtype in (np.int8, np.int16) else arr
            schema[cname] = c.dtype
    t = from_numpy(stmt.name, data, schema or None,
                   device="cpu" if conn.mesh is not None else conn.device)
    for cname, nm in nullmasks.items():
        t.columns[cname].set_nulls(nm, t.capacity)
    conn.register_table(t)
    return f"CREATE TABLE {stmt.name} AS ({t.num_rows} rows)", []


def _create_index(conn, stmt):
    table = conn.catalog.table(stmt.table)
    col = table.columns[stmt.column]
    host = col.host[: table.num_rows] if col.host is not None else \
        col.data[: table.num_rows].cpu().numpy()
    dev = table.device
    # on a mesh the bitmap index is built whole on the host, then this
    # rank's block of its words is taken (`shard_index`); a PK lut is
    # replicated
    bitmap_dev = "cpu" if conn.mesh is not None else dev
    capacity = table.global_capacity
    if stmt.using == "pk":
        pk = DirectPKIndex.build(stmt.column, host, table.num_rows,
                                 device=dev)
        if pk is None:
            raise StatementError(
                f"{stmt.column} unsuitable for a direct PK index")
        table.pk_indexes[stmt.column] = pk
    else:
        if col.dictionary is not None:
            idx = CubitIndex.build(stmt.column, host.astype(np.int32),
                                   capacity, table.num_rows,
                                   max(len(col.dictionary), 1),
                                   device=bitmap_dev)
        elif stmt.n_bins is not None:
            vals = host.astype(np.int64)
            lo = int(vals.min()) if len(vals) else 0
            hi = int(vals.max()) + 1 if len(vals) else 1
            edges = np.unique(np.linspace(
                lo, hi, stmt.n_bins + 1).astype(np.int64))[:-1]
            idx = CubitIndex.build(stmt.column, vals, capacity,
                                   table.num_rows, len(edges),
                                   bin_edges=edges, device=bitmap_dev)
        else:
            values = np.unique(host.astype(np.int64))
            if len(values) > (1 << 16):
                raise StatementError(
                    f"{stmt.column}: {len(values)} distinct values; give "
                    f"WITH (bins=N) to bin the bitmap index")
            idx = CubitIndex.build(stmt.column, host.astype(np.int64),
                                   capacity, table.num_rows,
                                   max(len(values), 1), bin_edges=values,
                                   device=bitmap_dev)
        if conn.mesh is not None:
            from ..parallel.shard import shard_index

            idx = shard_index(idx, conn.mesh, table.sharded)
        table.indexes[stmt.column] = idx
    table.version += 1
    return f"CREATE INDEX on {stmt.table}({stmt.column})", []


def _insert(conn, stmt):
    table = conn.catalog.table(stmt.table)
    if stmt.select is not None:
        raise StatementError("INSERT ... SELECT not supported yet")
    cols = stmt.columns or list(table.columns.keys())
    if set(cols) != set(table.columns.keys()):
        raise StatementError("INSERT must provide every column")
    rows, nulls = {}, {}
    with PROF.span("db.insert.literals"):
        for pos, cname in enumerate(cols):
            dtype = table.columns[cname].dtype
            vals = [_literal_value(r[pos], dtype) for r in stmt.rows]
            nmask = np.array([v is None for v in vals])
            if nmask.any():
                # a placeholder under each NULL (masked everywhere)
                filler = b"" if dtype.id == TypeId.VARCHAR else 0
                vals = [filler if v is None else v for v in vals]
                nulls[cname] = nmask
            if dtype.id == TypeId.VARCHAR:
                rows[cname] = np.array(vals, dtype="S")
            else:
                rows[cname] = np.array(vals, dtype=dtype.np_dtype)
    first = dml.append_rows(table, rows, nulls=nulls or None)
    return f"INSERT {len(stmt.rows)} (first rowid {first})", []


def _delete(conn, stmt):
    table = conn.catalog.table(stmt.table)
    rowids = _match_rows(conn, stmt.table, stmt.where)
    if len(rowids):
        with PROF.span("db.dml.delete"):
            dml.delete_rows(table, rowids)
    else:
        table.version += 1
    return f"DELETE {len(rowids)}", []


def _update(conn, stmt):
    """Every assignment is evaluated against the rows as they were before
    the statement (SQL semantics), then written column by column."""
    table = conn.catalog.table(stmt.table)
    rowids = _match_rows(conn, stmt.table, stmt.where)
    if not len(rowids):
        table.version += 1
        return "UPDATE 0", []
    rel = None
    writes = []
    for col_name, expr in stmt.assignments:
        dtype = table.columns[col_name].dtype
        try:
            v = _literal_value(expr, dtype)
            nulls = np.full(len(rowids), v is None)
            vals = np.full(len(rowids), 0 if v is None else v)
        except StatementError:
            # a general expression over the table's rows
            if rel is None:
                rel = conn.executor.execute(TableScan(stmt.table),
                                            optimize=False, verify=False)
            with PROF.span("db.bind"):
                bound = conn.binder.bind_table_expr(stmt.table, expr)
            t = rel.evaluate(bound)
            vals = _cast_values(t, dtype, rowids)
            nulls = None if t.valid is None else \
                ~_host_values(t.valid, rowids).astype(bool)
        writes.append((col_name, vals, nulls))
    for col_name, vals, nulls in writes:
        dml.update_column(table, col_name, rowids, vals, new_nulls=nulls)
    return f"UPDATE {len(rowids)}", []


def _transaction(conn, stmt):
    {"begin": conn.begin, "commit": conn.commit,
     "rollback": conn.rollback}[stmt.kind]()
    return stmt.kind.upper(), []


def _explain(conn, stmt):
    from ..plan import optimizer as opt

    plan = opt.optimize(conn.binder.bind(stmt.query), conn.catalog)
    lines = []

    def walk(op, d):
        lines.append("  " * d + op.describe())
        for c in op.children:
            walk(c, d + 1)

    walk(plan, 0)
    if stmt.analyze:
        # the plan above, run once with the profiler (already optimized)
        conn.executor.execute(plan, profile=True, optimize=False)
        lines.append(conn.executor.profiler.render(plan))
    return "EXPLAIN", [[line] for line in lines]


# PRAGMAs the reference accepts as no-ops: harness knobs (thread-count
# stress, profiler output routing) with no counterpart in the engine
_NOOP_PRAGMAS = ("verify_parallelism", "disable_verify_parallelism",
                 "enable_profiling", "disable_profiling", "explain_output",
                 "verify_external", "disable_verify_external")


def _pragma(conn, stmt):
    name = stmt.name.lower()
    if name == "tpch":
        from ..tpch import queries

        return "PRAGMA tpch", R.to_strings(
            queries.run(conn.executor, int(stmt.args[0])))
    if name in ("enable_verification", "disable_verification"):
        # every later SELECT runs through the legs of
        # exec/executor._execute_verified, which must agree
        conn.config.enable_verification = name == "enable_verification"
        return f"PRAGMA {name}", []
    if name in _NOOP_PRAGMAS:
        return f"PRAGMA {name}", []
    raise StatementError(f"unknown pragma {stmt.name}")


def _drop_table(conn, stmt):
    if stmt.name not in conn.catalog.tables:
        if stmt.if_exists:
            return "DROP TABLE (skipped)", []
        raise StatementError(f"unknown table {stmt.name}")
    conn.catalog.drop(stmt.name)
    return f"DROP TABLE {stmt.name}", []


def _create_table(conn, stmt):
    if stmt.name in conn.catalog.tables:
        raise StatementError(f"table {stmt.name} already exists")
    schema = {cd.name: _column_type(cd) for cd in stmt.columns}
    data = {cd.name: _empty_np(schema[cd.name]) for cd in stmt.columns}
    conn.register_table(from_numpy(
        stmt.name, data, schema,
        device="cpu" if conn.mesh is not None else conn.device))
    return f"CREATE TABLE {stmt.name}", []


def _set(conn, stmt):
    conn.config.set(stmt.name, stmt.value)
    return f"SET {stmt.name} = {stmt.value}", []


_HANDLERS = {A.CreateTable: _create_table, A.CreateTableAs: _create_table_as,
             A.CreateIndex: _create_index,
             A.Insert: _insert, A.Delete: _delete, A.Update: _update,
             A.DropTable: _drop_table, A.SetStmt: _set,
             A.TransactionStmt: _transaction,
             A.ExplainStmt: _explain, A.PragmaStmt: _pragma}



def execute_statement(conn, stmt):
    """Execute a non-SELECT statement; -> (status string, rows)."""
    handler = _HANDLERS.get(type(stmt))
    if handler is None:
        raise StatementError(f"unhandled statement {type(stmt).__name__}")
    return handler(conn, stmt)
