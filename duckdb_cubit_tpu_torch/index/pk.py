"""Direct-address primary-key index.

Counterpart of `duckdb_cubit_tpu/index/pk.py`: key -> row resolves through
one int32 lookup tensor built once at ingest.  The table covers the keys
from the smallest, `base`, to the largest, `max_key`: slot `key - base`
holds the row (the JAX package's table starts at key 0, so a sparse key
with a large base, such as a `yyyymmdd` date, needs no table from 0).
PK-FK joins probe it (`HashJoin._pk_probe`) and fetch build values through
per-column value luts in the same slot space (`device_value_lut`), both
through the monotone gather kernel when the probe keys are sorted.
"""

from __future__ import annotations

import numpy as np
import torch

# A table of at most this many slots (256 KB of int32) is built whatever
# its density: it costs less than one column of a table that large.
SMALL_SLOTS = 1 << 16


class DirectPKIndex:
    def __init__(self, column: str, lut: torch.Tensor, max_key: int,
                 base: int = 0):
        self.column = column
        self.lut = lut          # (max_key-base+1,) int32 row id, -1 = absent
        self.max_key = max_key
        self.base = base        # the key of slot 0
        # per-column VALUE luts in slot space: vlut[slot] = column[lut[slot]]
        # (0 where absent; callers mask by `found`).  Built once and cached
        # here, so an entry holds the column's values as they
        # were when it was built: every mutation of the table replaces the
        # index (an append rebuilds it, an UPDATE of a column swaps in
        # `without_value_lut`), and an index object is never changed after
        # a transaction snapshot may hold it.
        self._value_luts: dict[str, torch.Tensor] = {}
        self._lut_host: np.ndarray | None = None

    @property
    def span(self) -> int:
        """Slots of the table: the keys from `base` to `max_key`."""
        return self.max_key - self.base + 1

    def clamped(self, keys: torch.Tensor) -> torch.Tensor:
        """Each key's slot as int64, clamped into the table."""
        s = torch.clamp(keys.to(torch.int64), self.base, self.max_key)
        return s - self.base if self.base else s

    def slots(self, keys: torch.Tensor):
        """-> (`clamped(keys)`, whether each key lies in [base,
        max_key])."""
        k = keys.to(torch.int64)
        return self.clamped(k), (k >= self.base) & (k <= self.max_key)

    def has_value_lut(self, name: str) -> bool:
        return name in self._value_luts

    def without_value_lut(self, name: str) -> "DirectPKIndex":
        """A copy sharing the row lut and every other value lut, without the
        value lut of `name` (whose column has changed)."""
        out = DirectPKIndex(self.column, self.lut, self.max_key, self.base)
        out._value_luts = {n: v for n, v in self._value_luts.items()
                           if n != name}
        out._lut_host = self._lut_host
        return out

    def device_value_lut(self, name: str,
                         column: np.ndarray | torch.Tensor) -> torch.Tensor:
        """int32 value lut of a base column, on the index's device: built
        there from the whole column on that device (a gather over the
        slots), or on the host from its host mirror (a table on a mesh,
        whose device holds a row block)."""
        v = self._value_luts.get(name)
        if v is None:
            if isinstance(column, torch.Tensor):
                v = torch.where(self.lut >= 0, column[self.lut.clamp(min=0)]
                                .to(torch.int32), 0)
            else:
                if self._lut_host is None:
                    self._lut_host = self.lut.cpu().numpy()
                lh = self._lut_host
                vals = np.asarray(column)[np.maximum(lh, 0)].astype(np.int32)
                vals[lh < 0] = 0
                v = torch.as_tensor(vals, device=self.lut.device)
            self._value_luts[name] = v
        return v

    @classmethod
    def build(cls, column: str, keys: np.ndarray, num_rows: int,
              density_limit: float = 8.0, *,
              device) -> "DirectPKIndex | None":
        """Build from host key values; returns None if keys are unsuitable:
        duplicates, or a table both sparse (more than `density_limit` slots
        a row) and larger than `SMALL_SLOTS`."""
        keys = np.asarray(keys[:num_rows], dtype=np.int64)
        if num_rows == 0:
            return None
        base, max_key = int(keys.min()), int(keys.max())
        span = max_key - base + 1
        if span > max(density_limit * num_rows, SMALL_SLOTS):
            return None
        lut = np.full(span, -1, np.int32)
        lut[keys - base] = np.arange(num_rows, dtype=np.int32)
        if (lut[keys - base] != np.arange(num_rows)).any():
            return None  # duplicate keys
        return cls(column, torch.as_tensor(lut, device=device), max_key,
                   base)

    def probe(self, probe_keys: torch.Tensor, probe_valid: torch.Tensor,
              build_mask: torch.Tensor):
        """-> (build row per probe row, found mask)."""
        slot, in_range = self.slots(probe_keys)
        row = self.lut[slot]
        present = row >= 0
        alive = build_mask[torch.clamp(row, min=0)]
        found = in_range & probe_valid & present & alive
        return torch.where(found, row, torch.full_like(row, -1)), found
