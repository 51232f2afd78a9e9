"""Durability: checkpoint + write-ahead log.

Counterpart of `duckdb_cubit_tpu/storage/persist.py`, with its on-disk
format, so each package opens the other's directory.  The durable unit is
the host mirror of each column (the device tensors are a cache of the
checkpoint):

 - `checkpoint(conn, path)` writes every table's unpadded live rows,
   dictionaries, NULL masks and index / PK / FK metadata into
   `<path>/checkpoint.npz` and `<path>/manifest.json`, then removes the
   write-ahead log;
 - DDL / DML statements append their SQL text to `<path>/wal.sql` (fsync'd)
   before the statement returns (logical logging: the statement text is the
   redo record);
 - `open_database(path, device=...)` loads the checkpoint onto the device,
   rebuilds the indexes, then replays the log through the ordinary SQL path.

On a mesh every rank runs `checkpoint` and rank 0 alone writes the files,
in the single-device format.  The host mirrors, NULL masks and index, PK
and unique-key definitions are global on every rank; the deleted masks,
which only the row blocks hold, are gathered first.  A mesh reopens a
directory as `Connection(open_database(path, device="cpu").catalog,
device=..., mesh=mesh)`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..types import DataType, TypeId
from .dml import _host, global_deleted
from .table import Catalog, from_numpy

_MAGIC = "duckdb_cubit_tpu-v1"


def _ingestible(arr: np.ndarray) -> np.ndarray:
    """Integer storage narrowed below int32 (int8 / int16), widened to
    int32: `from_numpy` of either package takes int32 and int64 only (the
    reference writes and then fails to read its own narrowed columns)."""
    if arr.dtype.kind == "i" and arr.dtype.itemsize < 4:
        return arr.astype(np.int32)
    return arr


def checkpoint(conn, path: str) -> None:
    """Serialize the connection's catalog; truncates the write-ahead log.
    Deleted rows are dropped from the image (row ids shift; relations are
    unordered and the PK luts are rebuilt on open).  On a mesh every rank
    gathers the deleted masks, rank 0 writes, and the ranks meet after it:
    none returns before the files are complete, and all raise if rank 0's
    write failed."""
    cat = conn.catalog
    # collectives first, on every rank
    deleted = {tname: global_deleted(t) for tname, t in cat.tables.items()}
    error = None
    if conn.writes_files:
        try:
            _write_checkpoint(cat, deleted, path)
        except Exception as e:
            error = e
    mesh = conn.mesh
    if mesh is not None:
        from ..parallel.shard import all_ok

        ok = all_ok(torch.tensor([error is None], device=mesh.device), mesh)
        if error is None and not bool(ok[0]):
            raise RuntimeError(f"the checkpoint of {path} failed on rank 0")
    if error is not None:
        raise error


def _write_checkpoint(cat, deleted: dict, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    blobs: dict[str, np.ndarray] = {}
    manifest: dict = {"magic": _MAGIC, "tables": {},
                      "foreign_keys": cat.foreign_keys}
    for tname, t in cat.tables.items():
        cols = {}
        live = None
        num_rows = t.num_rows
        if deleted[tname] is not None:
            live = ~deleted[tname][:t.num_rows]
            num_rows = int(live.sum())
        for cname, c in t.columns.items():
            key = f"{tname}.{cname}"
            arr = _ingestible(_host(c, t.num_rows))
            blobs[key] = arr[live] if live is not None else arr
            if c.dictionary is not None:
                blobs[key + ".dict"] = np.asarray(c.dictionary)
            has_nulls = c.nulls_host is not None
            if has_nulls:
                nh = np.asarray(c.nulls_host[:t.num_rows])
                blobs[key + ".nulls"] = nh[live] if live is not None else nh
            cols[cname] = {"type": c.dtype.id.value,
                           "scale": c.dtype.scale,
                           "dict": c.dictionary is not None,
                           "nulls": has_nulls}
        manifest["tables"][tname] = {
            "num_rows": num_rows,
            "columns": cols,
            "indexes": {c: {"n_bins": ix.n_bins,
                            "edges": None if ix.bin_edges is None
                            else np.asarray(ix.bin_edges).tolist()}
                        for c, ix in t.indexes.items()},
            "pk_indexes": list(t.pk_indexes.keys()),
            "unique_keys": [sorted(us) for us in t.unique_keys],
            "deleted": t.deleted is not None,
        }
    tmp = os.path.join(path, "checkpoint.tmp.npz")
    np.savez_compressed(tmp, **blobs)
    os.replace(tmp, os.path.join(path, "checkpoint.npz"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # the checkpoint is complete: the log's tail is redundant
    wal = os.path.join(path, "wal.sql")
    if os.path.exists(wal):
        os.remove(wal)


def wal_append(path: str, sql: str) -> None:
    """Append one durable statement to the log, fsync'd: the statement is
    on disk before the caller acknowledges it."""
    with open(os.path.join(path, "wal.sql"), "a") as f:
        f.write(sql.strip().replace("\n", " ") + ";\n")
        f.flush()
        os.fsync(f.fileno())


def _load_table(tname: str, tm: dict, blobs, device):
    from ..index.cubit import CubitIndex
    from ..index.pk import DirectPKIndex

    data, schema = {}, {}
    for cname, cm in tm["columns"].items():
        arr = _ingestible(blobs[f"{tname}.{cname}"])
        if cm["dict"]:
            # decoded through the dictionary, so from_numpy re-encodes
            data[cname] = blobs[f"{tname}.{cname}.dict"][arr]
        else:
            data[cname] = arr
            schema[cname] = DataType(TypeId(cm["type"]), cm["scale"])
    t = from_numpy(tname, data, schema or None, device=device)
    for cname, cm in tm["columns"].items():
        if cm.get("nulls"):
            t.columns[cname].set_nulls(
                blobs[f"{tname}.{cname}.nulls"].astype(bool), t.capacity)
    t.unique_keys = [frozenset(us) for us in tm["unique_keys"]]
    for cname in tm["pk_indexes"]:
        pk = DirectPKIndex.build(cname, t.columns[cname].host, t.num_rows,
                                 device=device)
        if pk is not None:
            t.pk_indexes[cname] = pk
    for cname, im in tm["indexes"].items():
        edges = None if im["edges"] is None else np.asarray(im["edges"])
        t.indexes[cname] = CubitIndex.build(
            cname, t.columns[cname].host, t.capacity, t.num_rows,
            im["n_bins"], edges, device=device)
    return t


def open_database(path: str, *, device="cuda"):
    """-> a Connection on `device` (the card unless the caller asks for
    "cpu") over the checkpoint, with the write-ahead log replayed."""
    from ..api import Connection

    device = torch.device(device)
    cat = Catalog()
    manifest_path = os.path.join(path, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("magic") != _MAGIC:
            raise ValueError(f"{path}: unrecognized database directory")
        blobs = np.load(os.path.join(path, "checkpoint.npz"),
                        allow_pickle=False)
        for tname, tm in manifest["tables"].items():
            cat.register(_load_table(tname, tm, blobs, device))
        for fk, (pt, pc) in manifest["foreign_keys"].items():
            cat.register_foreign_key(fk, pt, pc)
    conn = Connection(cat, device=device)
    wal = os.path.join(path, "wal.sql")
    if os.path.exists(wal):
        with open(wal) as f:
            tail = f.read()
        conn._wal_replaying = True
        try:
            for stmt in tail.split(";\n"):
                if stmt.strip():
                    conn.sql(stmt)
        finally:
            conn._wal_replaying = False
    conn.db_path = path
    return conn
