"""The plain reference's tables: the benchmark's own arrays, refreshed.

`Database` holds the base population from `datagen` and applies RF1's new
rows and RF2's deleted keys to orders and lineitem; every other table never
changes.  `table(name)` returns the live rows, column by column, built on
first use after each change.  Nothing here imports the engine under test.
"""

from __future__ import annotations

import numpy as np

REFRESHED = ("orders", "lineitem")
KEY = {"orders": "o_orderkey", "lineitem": "l_orderkey"}


class _Live:
    """One refreshed table's live columns, materialised on demand."""

    def __init__(self, parts: list[dict], keep: list[np.ndarray | None]):
        self._parts = parts
        self._keep = keep
        self._cols: dict[str, np.ndarray] = {}

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self._cols:
            pieces = [p[name] if k is None else np.asarray(p[name])[k]
                      for p, k in zip(self._parts, self._keep)]
            self._cols[name] = (np.asarray(pieces[0]) if len(pieces) == 1
                                else np.concatenate(pieces))
        return self._cols[name]


class Database:
    def __init__(self, base: dict):
        self.base = base
        self.inserted: list[tuple[dict, dict]] = []
        self.deleted = np.zeros(0, dtype=np.int64)
        self._live: dict[str, _Live] = {}

    def copy(self) -> "Database":
        db = Database(self.base)
        db.inserted = list(self.inserted)
        db.deleted = self.deleted
        return db

    def insert(self, orders: dict, lineitem: dict):
        self.inserted.append((orders, lineitem))
        self._live.clear()

    def delete(self, keys: np.ndarray) -> tuple[int, int]:
        """Delete the orders with these keys and their lineitems; returns
        the rows deleted from (lineitem, orders)."""
        keys = np.asarray(keys, dtype=np.int64)
        counts = []
        for name in ("lineitem", "orders"):
            counts.append(int(np.isin(self.table(name)[KEY[name]],
                                      keys).sum()))
        self.deleted = np.union1d(self.deleted, keys)
        self._live.clear()
        return counts[0], counts[1]

    def table(self, name: str):
        if name not in REFRESHED:
            return self.base[name]
        if name not in self._live:
            i = REFRESHED.index(name)
            parts = [self.base[name]] + [s[i] for s in self.inserted]
            keep = []
            for p in parts:
                if len(self.deleted) == 0:
                    keep.append(None)
                else:
                    keep.append(~np.isin(np.asarray(p[KEY[name]]),
                                         self.deleted))
            self._live[name] = _Live(parts, keep)
        return self._live[name]
