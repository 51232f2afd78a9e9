"""Direct-address primary-key index.

Counterpart of `duckdb_cubit_tpu/index/pk.py`: TPC-H keys are dense (or
near-dense), so key -> row resolves through one int32 lookup tensor built
once at ingest.  The loader builds these and `GroupAggregate.prepare` reads
them; the join probe that uses them comes with the join slice.
"""

from __future__ import annotations

import numpy as np
import torch


class DirectPKIndex:
    def __init__(self, column: str, lut: torch.Tensor, max_key: int):
        self.column = column
        self.lut = lut          # (max_key+1,) int32 row id, -1 = absent
        self.max_key = max_key

    @classmethod
    def build(cls, column: str, keys: np.ndarray, num_rows: int,
              density_limit: float = 8.0, *,
              device) -> "DirectPKIndex | None":
        """Build from host key values; returns None if keys are unsuitable
        (duplicates, negatives, or too sparse to justify the array)."""
        keys = np.asarray(keys[:num_rows], dtype=np.int64)
        if num_rows == 0:
            return None
        max_key = int(keys.max())
        if keys.min() < 0 or max_key + 1 > density_limit * num_rows:
            return None
        lut = np.full(max_key + 1, -1, np.int32)
        lut[keys] = np.arange(num_rows, dtype=np.int32)
        if (lut[keys] != np.arange(num_rows)).any():
            return None  # duplicate keys
        return cls(column, torch.as_tensor(lut, device=device), max_key)
