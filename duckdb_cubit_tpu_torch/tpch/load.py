"""TPC-H ingest: generate, upload, index.

Counterpart of `duckdb_cubit_tpu/tpch/load.py`: generates the tables with
the native columnar generator, uploads them as device Tables on the given
device, and builds the default CUBIT and primary-key indexes.  The port
keeps its own git-ignored disk cache (`_data_cache/` inside the package).

`from_reference_catalog` carries a catalog built by the JAX package across
to this one, array by array, without importing jax: the two engines can
then be held against each other on the very same state.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..index.cubit import CubitIndex
from ..index.pk import DirectPKIndex
from ..storage.table import (Catalog, Column, Table, ZoneMap, encode_strings,
                             from_encoded)
from ..types import DataType, TypeId
from . import dbgen
from .schema import (DEFAULT_INDEXES, FOREIGN_KEYS, PK_COLUMNS, SCHEMA,
                     UNIQUE_KEYS)

_CACHE: dict[tuple[float, str], Catalog] = {}
DISK_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_data_cache")


def _disk_cache_path(sf: float) -> str:
    return os.path.join(DISK_CACHE_DIR, f"tpch_sf{sf}.npz")


def _encode_tables(tables: dict) -> dict:
    """Dictionary-encode every string column once: {table: {col: parts}}
    in `from_encoded`'s format."""
    out: dict[str, dict] = {}
    for tname, cols in tables.items():
        enc = out.setdefault(tname, {})
        for cname, arr in cols.items():
            if arr.dtype.kind == "S":
                codes, dictionary = encode_strings(arr)
                enc[cname] = {"codes": codes, "dict": dictionary}
            else:
                enc[cname] = {"raw": arr}
    return out


def _save_disk_cache(sf: float, encoded: dict):
    os.makedirs(DISK_CACHE_DIR, exist_ok=True)
    blobs = {f"{t}/{c}/{kind}": arr
             for t, cols in encoded.items()
             for c, parts in cols.items()
             for kind, arr in parts.items()}
    tmp = _disk_cache_path(sf) + ".tmp.npz"
    np.savez(tmp, **blobs)
    os.replace(tmp, _disk_cache_path(sf))


def _load_disk_cache(sf: float):
    path = _disk_cache_path(sf)
    if not os.path.exists(path):
        return None
    z = np.load(path)
    tables: dict[str, dict] = {}
    for key in z.files:
        tname, cname, kind = key.split("/")
        tables.setdefault(tname, {}).setdefault(cname, {})[kind] = z[key]
    return tables


def build_indexes(table: Table, spec: dict):
    for col_name, (kind, arg) in spec.items():
        col = table.columns[col_name]
        host_vals = col.host[: table.num_rows]
        common = dict(capacity=table.capacity, num_rows=table.num_rows,
                      device=table.device)
        if kind == "identity":
            idx = CubitIndex.build(col_name, host_vals.astype(np.int32),
                                   n_bins=int(arg), **common)
        elif kind == "edges":
            edges = np.asarray(arg, dtype=np.int64)
            idx = CubitIndex.build(col_name, host_vals.astype(np.int64),
                                   n_bins=len(edges), bin_edges=edges,
                                   **common)
        elif kind == "dict":
            assert col.dictionary is not None, f"{col_name} is not VARCHAR"
            idx = CubitIndex.build(col_name, host_vals.astype(np.int32),
                                   n_bins=col.dict_size, **common)
        elif kind == "values":
            values = np.unique(host_vals).astype(np.int64)
            idx = CubitIndex.build(col_name, host_vals.astype(np.int64),
                                   n_bins=len(values), bin_edges=values,
                                   **common)
        else:
            raise ValueError(kind)
        table.indexes[col_name] = idx


def build_pk_index(table: Table):
    col_name = PK_COLUMNS.get(table.name)
    if col_name is None:
        return
    col = table.columns[col_name]
    pk = DirectPKIndex.build(col_name, col.host[: table.num_rows],
                             table.num_rows, device=table.device)
    if pk is not None:
        table.pk_indexes[col_name] = pk


def _register_schema(catalog: Catalog):
    for fk_col, (pk_table, pk_col) in FOREIGN_KEYS.items():
        catalog.register_foreign_key(fk_col, pk_table, pk_col)
    for tname, keys in UNIQUE_KEYS.items():
        catalog.table(tname).unique_keys = list(keys)


def load_catalog(sf: float = 0.01, *, device="cuda",
                 with_indexes: bool = True, cache: bool = True,
                 disk_cache: bool = True) -> Catalog:
    """The TPC-H catalog at scale factor `sf`, every tensor on `device` (the
    card unless the caller asks for "cpu").

    Strings are dictionary-encoded once on the host (the reference encodes
    them in `from_numpy`, or in its disk-cache writer and then again; the
    codes and dictionaries are the same)."""
    device = torch.device(device)
    key = (sf, str(device))
    if cache and key in _CACHE:
        return _CACHE[key]
    encoded = _load_disk_cache(sf) if disk_cache else None
    if encoded is None:
        encoded = _encode_tables(dbgen.gen_all(sf))
        if disk_cache and sf >= 0.1:
            _save_disk_cache(sf, encoded)
    catalog = Catalog()
    for name, cols in encoded.items():
        t = from_encoded(name, cols, SCHEMA.get(name, {}), device=device)
        if with_indexes:
            if name in DEFAULT_INDEXES:
                build_indexes(t, DEFAULT_INDEXES[name])
            build_pk_index(t)
        catalog.register(t)
    _register_schema(catalog)
    if cache:
        _CACHE[key] = catalog
    return catalog


# ------------------------------------------------ state from the reference

def _tensor(a, device) -> torch.Tensor | None:
    return None if a is None else torch.as_tensor(np.array(a), device=device)


def _words_tensor(a, device) -> torch.Tensor | None:
    """Reference uint32 words -> the port's int32 bit patterns."""
    if a is None:
        return None
    return torch.as_tensor(np.array(a, dtype=np.uint32).view(np.int32),
                           device=device)


def _carry_dtype(dt) -> DataType:
    """The reference's DataType as the port's (same enum values)."""
    return DataType(TypeId(dt.id.value), dt.scale)


def _carry_index(ix, device) -> CubitIndex:
    out = CubitIndex(ix.name, ix.capacity, ix.n_bins, ix.bin_edges,
                     ix.range_encode, device=device)
    out.epoch = ix.epoch
    out.words = _words_tensor(ix.words, device)
    out.cum_words = _words_tensor(ix.cum_words, device)
    out.bin_counts = None if ix.bin_counts is None else ix.bin_counts.copy()
    out._pending = list(ix._pending)
    return out


def from_reference_catalog(ref_catalog, *, device) -> Catalog:
    """Build the port's catalog from a `duckdb_cubit_tpu` catalog.

    Every array is read with `np.asarray` (jax arrays implement the array
    protocol), so this never imports jax.  Columns keep their narrowed
    storage types, dictionaries, domains, zone maps, NULL masks and
    sortedness; indexes keep their words, cumulative words, bin counts,
    epochs and pending updates; primary-key indexes their luts.
    """
    device = torch.device(device)
    catalog = Catalog()
    for name, rt in ref_catalog.tables.items():
        if getattr(rt, "deleted", None) is not None:
            raise NotImplementedError(
                f"table {name}: deleted-row masks are not ported yet")
        columns = {}
        for cname, rc in rt.columns.items():
            zm = None if rc.zone_map is None else ZoneMap(
                rc.zone_map.mins.copy(), rc.zone_map.maxs.copy())
            columns[cname] = Column(
                name=rc.name, dtype=_carry_dtype(rc.dtype),
                data=_tensor(rc.data, device),
                dictionary=rc.dictionary, zone_map=zm, domain=rc.domain,
                host=None if rc.host is None else np.array(rc.host),
                nulls=_tensor(rc.nulls, device),
                nulls_host=None if rc.nulls_host is None
                else np.array(rc.nulls_host),
                is_sorted=rc.is_sorted)
        t = Table(name=rt.name, columns=columns, num_rows=rt.num_rows,
                  capacity=rt.capacity, unique_keys=list(rt.unique_keys),
                  version=rt.version, device=device)
        t.indexes = {c: _carry_index(ix, device)
                     for c, ix in rt.indexes.items()}
        t.pk_indexes = {c: DirectPKIndex(pk.column, _tensor(pk.lut, device),
                                         pk.max_key)
                        for c, pk in rt.pk_indexes.items()}
        catalog.register(t)
    catalog.foreign_keys = dict(ref_catalog.foreign_keys)
    catalog.placement = ref_catalog.placement
    return catalog
