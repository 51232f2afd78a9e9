"""Columnar device tables.

Counterpart of `duckdb_cubit_tpu/storage/table.py`: one padded, fixed-shape
torch tensor per column on the table's device, plus host-side metadata
(sorted string dictionaries, per-block zone maps, small value domains, an
unpadded host mirror).  The narrowing codec (`_narrow_int`,
`_narrow_decimal`) is the reference's, bit for bit: the stored int8/int16/
int32 widths are part of the state both packages hold.  Consumers widen to
int64 before arithmetic or comparison (torch keeps a narrow tensor's type
against a Python scalar, so widening is explicit everywhere).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools

import numpy as np
import torch

from ..types import (BOOL, CHAR1, DOUBLE, INT32, INT64, VARCHAR, DataType,
                     TypeId)

# rows per zone-map block (power of two; host-side statistics granularity)
ZONE_BLOCK = 1 << 16
# device arrays are padded to a multiple of this so shape buckets stay few
ROW_PAD = 1 << 13


def pad_count(n: int, pad: int = ROW_PAD) -> int:
    return max(pad, (n + pad - 1) // pad * pad)


@dataclasses.dataclass
class ZoneMap:
    mins: np.ndarray  # (n_blocks,)
    maxs: np.ndarray


@dataclasses.dataclass
class Column:
    name: str
    dtype: DataType
    data: torch.Tensor  # padded device tensor
    dictionary: np.ndarray | None = None  # sorted |S bytes, host (VARCHAR)
    zone_map: ZoneMap | None = None
    domain: np.ndarray | None = None  # sorted distinct values (CHAR1)
    # unpadded host mirror of `data` (codes for VARCHAR); index builds read
    # this instead of copying the device tensor back
    host: np.ndarray | None = None
    # per-row NULL mask (None = no NULLs in this column)
    nulls: torch.Tensor | None = None
    nulls_host: np.ndarray | None = None
    # non-decreasing over the stored row order (ingest-time host check on
    # integer key columns)
    is_sorted: bool = False

    @property
    def dict_size(self) -> int:
        return 0 if self.dictionary is None else len(self.dictionary)

    def decode_strings(self, codes: np.ndarray) -> np.ndarray:
        assert self.dictionary is not None
        return self.dictionary[codes]


def _build_zone_map(values: np.ndarray, num_rows: int) -> ZoneMap:
    n_blocks = max(1, (num_rows + ZONE_BLOCK - 1) // ZONE_BLOCK)
    mins = np.empty(n_blocks, dtype=values.dtype)
    maxs = np.empty(n_blocks, dtype=values.dtype)
    for b in range(n_blocks):
        part = values[b * ZONE_BLOCK : min((b + 1) * ZONE_BLOCK, num_rows)]
        mins[b] = part.min()
        maxs[b] = part.max()
    return ZoneMap(mins, maxs)


# small integer/date columns expose a contiguous value domain (from the
# zone map's global bounds) — drives the dense perfect-hash aggregate path
INT_DOMAIN_LIMIT = 8192


def _int_domain(zone_map, dtype) -> np.ndarray | None:
    if zone_map is None or dtype.id not in (TypeId.INT32, TypeId.INT64,
                                            TypeId.DATE, TypeId.DECIMAL):
        return None
    lo = int(zone_map.mins.min())
    hi = int(zone_map.maxs.max())
    if 0 < hi - lo + 1 <= INT_DOMAIN_LIMIT:
        return np.arange(lo, hi + 1, dtype=np.int64)
    return None


def encode_strings(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-dictionary encode a |S numpy array -> (int32 codes, dictionary)."""
    dictionary, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int32), dictionary


@dataclasses.dataclass
class Table:
    name: str
    columns: dict[str, Column]
    num_rows: int
    capacity: int
    indexes: dict = dataclasses.field(default_factory=dict)  # col -> CubitIndex
    pk_indexes: dict = dataclasses.field(default_factory=dict)  # col -> DirectPKIndex
    # composite uniqueness constraints (schema metadata): each entry is a
    # set of columns whose combination is unique
    unique_keys: list = dataclasses.field(default_factory=list)
    # bumped by every mutation / index merge
    version: int = 0
    # process-unique id: distinguishes same-named tables of different catalogs
    uid: int = dataclasses.field(default_factory=lambda: next(Table._UIDS))
    # the device every column tensor lives on (required, never defaulted)
    device: torch.device = dataclasses.field(kw_only=True)

    _UIDS = itertools.count()

    def column(self, name: str) -> Column:
        return self.columns[name]

    @property
    def column_names(self) -> list[str]:
        return list(self.columns.keys())

    def row_mask(self) -> torch.Tensor:
        """Validity of the padded tail."""
        return torch.arange(self.capacity, device=self.device) < self.num_rows


def _ingest_column(name: str, dev_np: np.ndarray, dtype: DataType,
                   dictionary, num_rows: int, capacity: int,
                   build_zone_maps: bool, device) -> Column:
    """Narrow, pad, gather statistics and upload one column (the shared
    tail of the reference's `from_numpy` and `from_encoded`)."""
    dev_np = _narrow_decimal(dev_np, dtype, num_rows)
    dev_np = _narrow_int(dev_np, dtype, num_rows)
    padded = np.empty(capacity, dtype=dev_np.dtype)
    padded[:num_rows] = dev_np
    # pad with the LAST value: masked everywhere, keeps zone maps tight and
    # sorted columns monotone through the tail
    padded[num_rows:] = dev_np[num_rows - 1] if num_rows else 0
    zone_map = None
    if build_zone_maps and num_rows and dtype.id in (
        TypeId.INT32, TypeId.INT64, TypeId.DECIMAL, TypeId.DATE,
        TypeId.VARCHAR, TypeId.CHAR1,
    ):
        zone_map = _build_zone_map(dev_np, num_rows)
    domain = None
    if dtype.id == TypeId.CHAR1 and num_rows:
        domain = np.unique(dev_np[:num_rows])
    elif num_rows:
        domain = _int_domain(zone_map, dtype)
    return Column(
        name=name,
        dtype=dtype,
        data=torch.as_tensor(padded, device=device),
        dictionary=dictionary,
        zone_map=zone_map,
        domain=domain,
        host=np.asarray(dev_np),
        is_sorted=_ingest_sorted(dev_np, dtype, num_rows),
    )


def from_numpy(
    name: str,
    data: dict[str, np.ndarray],
    schema: dict[str, DataType] | None = None,
    build_zone_maps: bool = True,
    *,
    device,
) -> Table:
    """Ingest host numpy columns into a device Table.

    |S bytes columns become sorted-dictionary VARCHAR (or CHAR1 when the
    producer already emits uint8 flags); numeric dtypes pass through.
    """
    num_rows = len(next(iter(data.values())))
    capacity = pad_count(num_rows)
    columns: dict[str, Column] = {}
    for col_name, values in data.items():
        assert len(values) == num_rows, f"ragged column {col_name}"
        dictionary = None
        if values.dtype.kind in ("S", "U") or values.dtype == object:
            if values.dtype.kind != "S":
                values = np.asarray(values, dtype="S")
            codes, dictionary = encode_strings(values)
            dev_np, dtype = codes, VARCHAR
        elif values.dtype == np.uint8:
            dev_np, dtype = values, CHAR1
        elif values.dtype == np.int32:
            dev_np = values
            dtype = (schema or {}).get(col_name, INT32)
        elif values.dtype == np.int64:
            dev_np = values
            dtype = (schema or {}).get(col_name, INT64)
        elif values.dtype == np.float64:
            dev_np, dtype = values, DOUBLE
        elif values.dtype == np.bool_:
            dev_np, dtype = values, BOOL
        else:
            raise TypeError(f"unsupported ingest dtype {values.dtype}")
        if schema and col_name in schema:
            dtype = schema[col_name]
        columns[col_name] = _ingest_column(col_name, dev_np, dtype, dictionary,
                                           num_rows, capacity,
                                           build_zone_maps, device)
    return Table(name=name, columns=columns, num_rows=num_rows,
                 capacity=capacity, device=torch.device(device))


def _ingest_sorted(dev_np: np.ndarray, dtype: DataType,
                   num_rows: int) -> bool:
    """Ingest-time sortedness check on integer key-ish columns."""
    if num_rows < 2 or dtype.id not in (TypeId.INT32, TypeId.INT64,
                                        TypeId.DATE):
        return False
    a = dev_np[:num_rows]
    return bool(np.all(a[1:] >= a[:-1]))


def _narrow_int(dev_np: np.ndarray, dtype: DataType,
                num_rows: int) -> np.ndarray:
    """Store integer-backed columns at the narrowest signed width that
    holds their value range (int8/int16/int32).

    The LOGICAL type is unchanged; consumers widen to int64 on use.
    Value-preserving only — no offset/delta encoding — so every kernel sees
    true values.  Identical to the reference's codec."""
    if dtype.id not in (TypeId.INT64, TypeId.INT32, TypeId.DATE,
                        TypeId.DECIMAL, TypeId.VARCHAR) or not num_rows:
        return dev_np
    if dev_np.dtype.kind != "i":
        return dev_np
    lo = int(dev_np[:num_rows].min())
    hi = int(dev_np[:num_rows].max())
    for cand in (np.int8, np.int16, np.int32):
        info = np.iinfo(cand)
        # strict bounds: leave one headroom value so sentinels like
        # min/max identities in aggregate kernels can never collide
        if info.min < lo and hi < info.max and \
                np.dtype(cand).itemsize < dev_np.dtype.itemsize:
            return dev_np.astype(cand)
    return dev_np


def _narrow_decimal(dev_np: np.ndarray, dtype: DataType,
                    num_rows: int) -> np.ndarray:
    """Store DECIMAL columns as int32 on device when the value range fits
    (the logical type keeps its scale; arithmetic widens to int64)."""
    if dtype.id != TypeId.DECIMAL or dev_np.dtype != np.int64 or not num_rows:
        return dev_np
    lo, hi = dev_np[:num_rows].min(), dev_np[:num_rows].max()
    if -(2**31) < lo and hi < 2**31 - 1:
        return dev_np.astype(np.int32)
    return dev_np


def from_encoded(name: str, cols: dict[str, dict],
                 schema: dict[str, DataType] | None = None,
                 build_zone_maps: bool = True, *, device) -> Table:
    """Ingest columns that may carry pre-built dictionary encodings.

    `cols[c]` is {"raw": arr} for plain columns or {"codes": int32,
    "dict": |S array} for pre-encoded VARCHAR.
    """
    first = next(iter(cols.values()))
    num_rows = len(first.get("raw", first.get("codes")))
    capacity = pad_count(num_rows)
    columns: dict[str, Column] = {}
    for col_name, parts in cols.items():
        dictionary = None
        if "codes" in parts:
            dev_np, dictionary, dtype = parts["codes"], parts["dict"], VARCHAR
        else:
            raw = parts["raw"]
            if raw.dtype == np.uint8:
                dev_np, dtype = raw, CHAR1
            elif raw.dtype == np.int32:
                dev_np, dtype = raw, (schema or {}).get(col_name, INT32)
            elif raw.dtype == np.int64:
                dev_np, dtype = raw, (schema or {}).get(col_name, INT64)
            elif raw.dtype == np.float64:
                dev_np, dtype = raw, DOUBLE
            else:
                raise TypeError(f"unsupported dtype {raw.dtype}")
        if schema and col_name in schema:
            dtype = schema[col_name]
        columns[col_name] = _ingest_column(col_name, dev_np, dtype, dictionary,
                                           num_rows, capacity,
                                           build_zone_maps, device)
    return Table(name=name, columns=columns, num_rows=num_rows,
                 capacity=capacity, device=torch.device(device))


class Catalog:
    """Name -> Table registry."""

    def __init__(self):
        self.tables: dict[str, Table] = {}
        # foreign-key registry: fk column name -> (pk table, pk column)
        self.foreign_keys: dict[str, tuple[str, str]] = {}
        # device placement tag, kept for parity with the reference (the
        # port has no mesh placement yet)
        self.placement = "default"

    def register(self, table: Table):
        self.tables[table.name] = table

    def register_foreign_key(self, fk_column: str, pk_table: str,
                             pk_column: str):
        self.foreign_keys[fk_column] = (pk_table, pk_column)

    def table(self, name: str) -> Table:
        if name not in self.tables:
            raise KeyError(f"unknown table {name}")
        return self.tables[name]

    def drop(self, name: str):
        self.tables.pop(name, None)

    # ------------------------------------------------------- transactions
    # Column tensors are never written in place and host state is
    # copy-on-write, so a snapshot is a shallow structural copy.
    def snapshot(self):
        snap_tables = {}
        for name, t in self.tables.items():
            t2 = copy.copy(t)
            t2.columns = {n: copy.copy(c) for n, c in t.columns.items()}
            t2.indexes = {n: ix.clone() if hasattr(ix, "clone")
                          else copy.copy(ix) for n, ix in t.indexes.items()}
            t2.pk_indexes = dict(t.pk_indexes)
            snap_tables[name] = t2
        return (snap_tables, dict(self.foreign_keys))

    def restore(self, snap):
        self.tables = dict(snap[0])
        self.foreign_keys = dict(snap[1])
