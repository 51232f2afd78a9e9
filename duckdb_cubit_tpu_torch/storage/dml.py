"""Appends, deletes and updates with index maintenance.

Counterpart of `duckdb_cubit_tpu/storage/dml.py`.  An append writes the new
rows into fresh column tensors (grown, copied and padded when the capacity
runs out), remaps a VARCHAR column's codes when new strings arrive
(dictionaries stay sorted), extends the per-column NULL masks, buffers one
CUBIT insert delta per row and publishes it with one merge per index (or
rebuilds the index when the capacity or the code space changed), rebuilds
every direct PK index (which drops its cached value luts), refreshes zone
maps and domains, and bumps the table's version, so no prepared plan built
for the old table is served again.  Tensors are never written in place: a reader of the previous
version keeps a consistent snapshot.

A delete is a validity epoch: rows never move (so PK luts and bitmap row
positions stay valid); the table's `deleted` mask, which `Table.row_mask`
honours, hides them and the CUBIT bitmaps drop their bits.  An update
rewrites one column's values (a VARCHAR column would need re-encoding, and
is refused as in the reference), moves the rows' bits between bins, and
leaves no state derived from the old values: the column's sortedness is
reset, and each PK index holding a value lut of the column is replaced by
one without it (copy-on-write: a transaction snapshot keeps the old index
with luts that match its data).

On a mesh (`parallel/shard.py`) a table is a row block, and every rank runs
the same call with the same global row ids and values.  Each rank writes
its device `data`, `nulls` and `deleted` only at the rows of its block,
shifted to local positions; every rank makes the same change to the global
host state (host mirrors, `num_rows`, `version`, zone maps, domains,
dictionaries, CUBIT bin counts, PK luts), so every later plan decision reads
the same values on every rank.  An append that grows the capacity moves
every block's bounds: each rank cuts its new block of every column, NULL
mask and `deleted` from the global host mirrors (and the gathered deleted
mask), and rebuilds each index over the whole column and keeps its block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..exec import profiler as PROF
from ..index.cubit import CubitIndex
from ..index.pk import DirectPKIndex
from ..types import TypeId
from .table import Table, _build_zone_map, _int_domain, pad_count


class DmlError(RuntimeError):
    pass


# rows appended, deleted or updated
PROF.declare("rows_written")


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(str(t.dtype).removeprefix("torch."))


def _host(col, num_rows: int) -> np.ndarray:
    return (col.host[:num_rows] if col.host is not None
            else col.data[:num_rows].cpu().numpy())


def _host_at(col, row_ids: np.ndarray) -> np.ndarray:
    # a row block always keeps its host mirror (`shard_table`)
    return (col.host[row_ids] if col.host is not None
            else col.data[torch.as_tensor(row_ids, device=col.data.device)]
            .cpu().numpy())


def _local_rows(table: Table, row_ids: np.ndarray):
    """The global `row_ids` that fall in this table's block: (their local
    positions, on the table's device; which of `row_ids` they are)."""
    local = row_ids - table.row_offset
    keep = (local >= 0) & (local < table.capacity)
    return torch.as_tensor(local[keep], device=table.device), keep


def _ensure_deleted_mask(table: Table):
    if table.deleted is None:
        table.deleted = torch.zeros(table.capacity, dtype=torch.bool,
                                    device=table.device)


def global_deleted(table: Table) -> np.ndarray | None:
    """The whole table's deleted mask on the host, None when no row was
    ever deleted.  Of a row block it is gathered over the mesh: a
    collective, which every rank must reach."""
    if table.deleted is None:
        return None
    if not table.sharded:
        return table.deleted.cpu().numpy()
    from ..parallel.shard import all_gather_rows

    return all_gather_rows(table.deleted, table.mesh).cpu().numpy()


def live_row_ids(table: Table) -> np.ndarray:
    """The global ids of the live rows, the same on every rank."""
    deleted = global_deleted(table)
    live = np.ones(table.num_rows, bool)
    if deleted is not None:
        live &= ~deleted[:table.num_rows]
    return np.nonzero(live)[0]


def _block_from_host(host: np.ndarray, dtype, num_rows: int, capacity: int,
                     offset: int, device) -> torch.Tensor:
    """Rows [offset, offset + capacity) of a whole column, padded past
    `num_rows` with its last value (masked everywhere)."""
    out = np.empty(capacity, dtype=dtype)
    part = host[offset:min(offset + capacity, num_rows)]
    out[:len(part)] = part
    out[len(part):] = host[num_rows - 1] if num_rows else 0
    return torch.as_tensor(out, device=device)


def _index_over_host(table: Table, name: str, values: np.ndarray,
                     n_bins: int, bin_edges) -> CubitIndex:
    """A CUBIT index built over the whole column's host values, holding
    this table's block of the words (on a mesh, `shard_index`)."""
    mesh = table.mesh
    idx = CubitIndex.build(name, values, table.global_capacity,
                           table.num_rows, n_bins, bin_edges=bin_edges,
                           device="cpu" if mesh is not None
                           else table.device)
    if mesh is None:
        return idx
    from ..parallel.shard import shard_index

    return shard_index(idx, mesh, table.sharded)


def append_rows(table: Table, rows: dict[str, np.ndarray],
                nulls: dict[str, np.ndarray] | None = None) -> int:
    """Append host rows; returns the first new row id.

    `nulls[col]` marks the NULL slots of the appended rows.  Its phases
    are spans (`exec/profiler.py`): `db.dml.encode` (values to storage
    codes; a VARCHAR column with new strings gets the merged dictionary and
    its stored codes remapped), `db.dml.device` (each column's new host
    mirror, device tensor and NULL mask), `db.dml.cubit` (CUBIT deltas,
    merges and rebuilds), `db.dml.pk` and `db.dml.stats`."""
    n_new = len(next(iter(rows.values())))
    PROF.count("rows_written", n_new)
    first = table.num_rows
    new_count = first + n_new
    grow = new_count > table.global_capacity
    # on a mesh a grown table is placed anew: each rank's block of the new
    # capacity, cut from the global host state
    regrown = grow and table.mesh is not None
    if regrown:
        from ..parallel.shard import block_bounds

        old_deleted = global_deleted(table)
        new_global = pad_count(new_count)
        capacity, offset, sharded = block_bounds(new_global, table.mesh)
    else:
        capacity = pad_count(new_count) if grow else table.capacity
        offset = table.row_offset
    dev = table.device
    remapped_dict_cols = []
    for name, col in table.columns.items():
        with PROF.span("db.dml.encode"):
            vals = rows[name]
            if col.dictionary is not None:
                # codes are order-preserving (ordered string predicates, LIKE
                # truth tables and CUBIT dictionary bins rely on it), so new
                # strings re-encode: the merged sorted dictionary, and one
                # device gather remaps the stored codes
                vals_b = np.array([v if isinstance(v, bytes)
                                   else str(v).encode()
                                   for v in np.asarray(vals)], dtype="S")
                old_dict = col.dictionary
                width = max(old_dict.dtype.itemsize, vals_b.dtype.itemsize,
                            1)
                merged = np.unique(np.concatenate(
                    [old_dict.astype(f"S{width}"),
                     vals_b.astype(f"S{width}")]))
                if len(merged) != len(old_dict):
                    old_to_new = np.searchsorted(
                        merged, old_dict.astype(f"S{width}")).astype(np.int32)
                    if len(old_to_new):
                        col.data = torch.as_tensor(old_to_new, device=dev)[
                            col.data.to(torch.int64)]
                        if col.host is not None:
                            col.host = old_to_new[col.host]
                    col.dictionary = merged
                    remapped_dict_cols.append(name)
                codes = np.searchsorted(
                    merged, vals_b.astype(f"S{width}")).astype(np.int32)
                dt = _np_dtype(col.data)
                if dt.kind == "i" and dt.itemsize < 4 and \
                        len(merged) >= np.iinfo(dt).max:
                    col.data = col.data.to(torch.int32)
                    if col.host is not None:
                        col.host = col.host.astype(np.int32)
                host_new = codes.astype(_np_dtype(col.data))
            else:
                vals_np = np.asarray(vals)
                dt = _np_dtype(col.data)
                if dt.kind == "i" and dt.itemsize < 8 and vals_np.size:
                    info = np.iinfo(dt)
                    v64 = vals_np.astype(np.int64)
                    if int(v64.max()) >= info.max or \
                            int(v64.min()) <= info.min:
                        # narrowed storage cannot hold the appended values:
                        # widen the column back
                        col.data = col.data.to(torch.int64)
                        if col.host is not None:
                            col.host = col.host.astype(np.int64)
                host_new = vals_np.astype(_np_dtype(col.data))
        with PROF.span("db.dml.device"):
            if col.host is not None:
                col.host = np.concatenate([col.host, host_new])
            if regrown:
                col.data = _block_from_host(col.host, _np_dtype(col.data),
                                            new_count, capacity, offset, dev)
            else:
                data = col.data
                if grow:
                    data = torch.cat([data, data[-1:].expand(
                        capacity - table.capacity)])
                else:
                    data = data.clone()
                # the new rows that fall in this block
                lo = max(first, offset)
                hi = min(new_count, offset + capacity)
                if lo < hi:
                    data[lo - offset:hi - offset] = torch.as_tensor(
                        host_new[lo - first:hi - first], device=dev)
                col.data = data
            # the per-column NULL mask, extended and refreshed
            new_nulls = None if nulls is None else nulls.get(name)
            if new_nulls is not None and new_nulls.any() or \
                    col.nulls is not None:
                old_h = (col.nulls_host if col.nulls_host is not None
                         else np.zeros(first, bool))
                nh = np.zeros(new_count, bool)
                nh[:first] = old_h[:first]
                if new_nulls is not None:
                    nh[first:new_count] = new_nulls
                col.set_nulls(nh, capacity, offset)
            col.is_sorted = False
        # index deltas (not for remapped dictionary columns, whose bins live
        # in the old code space: rebuilt below)
        idx = table.indexes.get(name)
        if idx is not None and name not in remapped_dict_cols:
            with PROF.span("db.dml.cubit"):
                for i in range(n_new):
                    idx.insert(first + i, host_new[i])
    table.num_rows = new_count
    if regrown:
        deleted = np.zeros(new_global, bool)
        if old_deleted is not None:
            deleted[:len(old_deleted)] = old_deleted
        table.deleted = None if old_deleted is None else torch.as_tensor(
            deleted[offset:offset + capacity], device=dev)
        table.capacity, table.row_offset = capacity, offset
        table.sharded = sharded
        table.blocks = table.mesh.size if sharded else 1
    elif table.deleted is not None and grow:
        table.deleted = torch.cat([table.deleted, torch.zeros(
            capacity - table.capacity, dtype=torch.bool, device=dev)])
    with PROF.span("db.dml.cubit"):
        if grow:
            # a new capacity changes the bitmap word counts: rebuild
            table.capacity = capacity
            for name, idx in list(table.indexes.items()):
                host = _host(table.columns[name], new_count)
                table.indexes[name] = _index_over_host(
                    table, name, host if idx.bin_edges is not None
                    else host.astype(np.int32), idx.n_bins, idx.bin_edges)
        else:
            for idx in table.indexes.values():
                if idx.pending_updates:
                    idx.merge()
        # a dictionary remap moves the code-space bitmap bins: rebuild
        for name in remapped_dict_cols:
            if name in table.indexes:
                col = table.columns[name]
                table.indexes[name] = _index_over_host(
                    table, name, col.host.astype(np.int32),
                    len(col.dictionary), None)
    # PK indexes are rebuilt (a cheap host build), dropping the value luts
    # cached on the old index
    with PROF.span("db.dml.pk"):
        for cname in list(table.pk_indexes):
            pk = DirectPKIndex.build(cname, _host(table.columns[cname],
                                                  new_count),
                                     new_count, device=dev)
            if pk is None:
                raise DmlError(f"append broke PK uniqueness on {cname}")
            table.pk_indexes[cname] = pk
    with PROF.span("db.dml.stats"):
        _refresh_stats(table)
    table.version += 1
    return first


def _refresh_stats(table: Table, columns=None):
    """Recompute zone maps and small-int domains from the host mirrors after
    a mutation: stale statistics would make the optimizer's always-false
    pruning and the dense-aggregate domain decision wrong."""
    names = columns if columns is not None else list(table.columns)
    for name in names:
        col = table.columns[name]
        if col.zone_map is None and col.domain is None and \
                col.dtype.id == TypeId.DOUBLE:
            continue
        host = _host(col, table.num_rows)
        if col.nulls_host is not None:
            host = host[~col.nulls_host[:table.num_rows]]
        if table.num_rows == 0 or len(host) == 0:
            col.zone_map = None
            col.domain = None
            continue
        if col.dtype.id in (TypeId.INT32, TypeId.INT64, TypeId.DECIMAL,
                            TypeId.DATE, TypeId.VARCHAR, TypeId.CHAR1):
            col.zone_map = _build_zone_map(host, len(host))
        if col.dtype.id == TypeId.CHAR1:
            col.domain = np.unique(host)
        elif col.domain is not None or col.zone_map is not None:
            col.domain = _int_domain(col.zone_map, col.dtype)


def delete_rows(table: Table, row_ids: np.ndarray):
    """Mark rows deleted; each CUBIT index drops their bits (one merge per
    index)."""
    _ensure_deleted_mask(table)
    row_ids = np.asarray(row_ids, dtype=np.int64)
    PROF.count("rows_written", len(row_ids))
    local, _ = _local_rows(table, row_ids)
    deleted = table.deleted.clone()
    deleted[local] = True
    table.deleted = deleted
    for name, idx in table.indexes.items():
        idx.delete_many(row_ids, _host_at(table.columns[name], row_ids))
        idx.merge()
    table.version += 1


def update_column(table: Table, column: str, row_ids: np.ndarray,
                  new_values: np.ndarray, new_nulls: np.ndarray | None = None):
    """Point updates of one column (CUBIT's update-conscious path).
    `new_nulls` marks the rows set to NULL."""
    col = table.columns[column]
    if col.dictionary is not None:
        raise DmlError("VARCHAR update requires re-encoding (not in round 1)")
    row_ids = np.asarray(row_ids, dtype=np.int64)
    PROF.count("rows_written", len(row_ids))
    old = _host_at(col, row_ids)
    new_values = np.asarray(new_values)
    idx = table.indexes.get(column)
    if idx is not None and len(row_ids):
        # checked before anything changes (the reference fails in the
        # merge, after the column was written)
        bins = idx.bins_of(new_values)
        if bins.min() < 0 or bins.max() >= idx.n_bins:
            raise DmlError(f"UPDATE moves {column} outside the bins of its "
                           f"index")
    dt = old.dtype
    if dt.kind == "i" and dt.itemsize < 8 and len(new_values):
        info = np.iinfo(dt)
        v64 = new_values.astype(np.int64)
        if int(v64.max()) >= info.max or int(v64.min()) <= info.min:
            # narrowed storage cannot hold the new values: widen it back
            col.data = col.data.to(torch.int64)
            if col.host is not None:
                col.host = col.host.astype(np.int64)
            dt = np.dtype(np.int64)
    new_host = new_values.astype(dt)
    local, keep = _local_rows(table, row_ids)
    data = col.data.clone()
    data[local] = torch.as_tensor(new_host[keep], device=table.device)
    col.data = data
    if col.host is not None:
        # copy-on-write so catalog snapshots (transactions) stay consistent
        col.host = col.host.copy()
        col.host[row_ids] = new_host
    if (new_nulls is not None and new_nulls.any()) or col.nulls is not None:
        nh = (col.nulls_host[:table.num_rows].copy()
              if col.nulls_host is not None
              else np.zeros(table.num_rows, bool))
        nh[row_ids] = False if new_nulls is None else new_nulls
        col.set_nulls(nh, table.capacity, table.row_offset)
    # the new values need not keep the column sorted
    col.is_sorted = False
    if idx is not None:
        idx.update_many(row_ids, old, new_values)
        idx.merge()
    for pk_col, pk in list(table.pk_indexes.items()):
        if pk_col == column:
            # the key itself moved: a fresh lut (or none, if the keys no
            # longer suit a direct index)
            fresh = DirectPKIndex.build(pk_col, _host(col, table.num_rows),
                                        table.num_rows, device=table.device)
            if fresh is None:
                del table.pk_indexes[pk_col]
            else:
                table.pk_indexes[pk_col] = fresh
        elif pk.has_value_lut(column):
            table.pk_indexes[pk_col] = pk.without_value_lut(column)
    _refresh_stats(table, [column])
    table.version += 1
