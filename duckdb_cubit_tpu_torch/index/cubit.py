"""CUBIT: a concurrently-updatable segmented bitmap index.

Counterpart of `duckdb_cubit_tpu/index/cubit.py`: per-value (or binned)
bitvectors, range encoding (cum[b] = OR of bins <= b, so a bin range reads
two rows), exact host-side per-bin counts, and buffered updates published by
one XOR pass (`merge`).  The build stays host-side numpy and uploads the
finished words; on the device the words are int32 bit patterns
(`ops/bitmap.py`), bit-identical to the reference's uint32 words.

Binning:
 - dictionary/low-cardinality columns: bin == value code (exact);
 - numeric/date columns: explicit sorted bin edges; a range predicate whose
   endpoints land on edges is answered exactly, otherwise the two boundary
   bins are refined against the base column (`refine` path).

On a mesh (`parallel/shard.shard_index`) an index holds its table's row
block: `words` / `cum_words` keep the block's word columns, `n_words` and
`capacity` are the block's and `row_offset` is the global row of its first
bit, so every `query_*` returns the block's bits.  The host bin counts stay
global: `count_eq`, `count_isin` and `count_range`, which plans read, give
the whole table's counts on every rank, never a count of the local words.
Buffered deltas name global rows; `merge` flips the bits of the block's
rows alone and counts every row's delta, so every rank, given the same
deltas, keeps the same counts.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..exec import profiler as PROF
from ..ops import bitmap as bm

# merges that published buffered deltas (`CubitIndex.merge`)
PROF.declare("cubit_merges")
# an index of at most this many bins packs a mask a bin at build
PACK_BINS = 64

@dataclasses.dataclass
class RangeQueryResult:
    words: torch.Tensor  # candidate bitvector (exact if refine_bins empty)
    exact: bool
    refine_bins: list  # [(bin_lo, bin_hi)] boundary bins needing base compare


class CubitIndex:
    """Bitmap index over one column of a Table."""

    def __init__(self, name: str, capacity: int, n_bins: int,
                 bin_edges: np.ndarray | None = None,
                 range_encode: bool = True, *, device):
        self.name = name
        self.capacity = capacity
        self.n_words = bm.num_words(capacity)
        # the global row of bit 0 (a row block's on a mesh)
        self.row_offset = 0
        self.n_bins = n_bins
        # For edge-binned indexes, bin b covers values in [edges[b], edges[b+1]),
        # and the last bin every value from its edge up
        self.bin_edges = bin_edges
        # the largest value an edge-binned index has held (deletes do not
        # lower it), the last bin's upper end; None where unknown
        self.top: int | None = None
        self.device = torch.device(device)
        self.epoch = 0
        self.words: torch.Tensor | None = None  # (n_bins, n_words) int32
        self.range_encode = range_encode
        self.cum_words: torch.Tensor | None = None
        # host-side per-bin popcounts: bins are disjoint, so the cardinality
        # of any bin-range query is an exact host-side sum
        self.bin_counts: np.ndarray | None = None
        self._pending: list[tuple[int, int, int]] = []  # (row, old_bin, new_bin)
        self._query_cache: dict = {}  # (epoch, op, args) -> device words

    # ------------------------------------------------------------- building
    def bin_of(self, values: np.ndarray) -> np.ndarray:
        if self.bin_edges is None:
            return values
        edges = self.bin_edges
        values = np.asarray(values)
        if (values.dtype.kind in "iu" and edges.dtype.kind in "iu"
                and len(edges) > 1
                and edges[-1] - edges[0] == len(edges) - 1):
            # one bin a value of a run of integers: an offset, no search
            return np.clip(values.astype(np.int64) - int(edges[0]), -1,
                           len(edges) - 1)
        return np.searchsorted(edges, values, side="right") - 1

    def _upload(self, words_u32: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(words_u32).view(np.int32), device=self.device)

    @classmethod
    def build(cls, name: str, values_or_codes, capacity: int, num_rows: int,
              n_bins: int, bin_edges: np.ndarray | None = None, *,
              device) -> "CubitIndex":
        """Build host-side (exact bincount bit-packing), upload finished words.

        Each row contributes one distinct power-of-two weight to one
        (bin, word) slot, so a float64 bincount (exact below 2**53) equals
        the bitwise OR.
        """
        idx = cls(name, capacity, n_bins, bin_edges, device=device)
        codes = np.asarray(values_or_codes)[:num_rows]
        if bin_edges is not None:
            idx._raise_top(codes)
            codes = idx.bin_of(codes)
        if n_bins <= PACK_BINS:
            # one packed mask a bin: a few cheap passes over narrow codes
            # beat one scattered bincount
            codes = codes.astype(np.int8)
            packed = np.zeros((n_bins, idx.n_words * 4), dtype=np.uint8)
            for b in range(n_bins):
                p = np.packbits(codes == b, bitorder="little")
                packed[b, :len(p)] = p
            words = packed.view("<u4")
        else:
            codes = codes.astype(np.int64)
            rows = np.arange(num_rows, dtype=np.int64)
            word = rows >> 5
            bit = (1 << (rows & 31)).astype(np.float64)
            flat = codes * idx.n_words + word
            words = np.bincount(flat, weights=bit,
                                minlength=n_bins * idx.n_words)
            words = words.astype(np.int64).astype(np.uint32).reshape(
                n_bins, idx.n_words)
        idx.words = idx._upload(words)
        idx.bin_counts = np.bincount(
            np.clip(codes, 0, n_bins - 1), minlength=n_bins).astype(np.int64)
        if idx.range_encode:
            # disjoint bins: the cumulative OR is the cumulative sum
            idx.cum_words = idx._upload(np.bitwise_or.accumulate(words,
                                                                 axis=0))
        else:
            idx.cum_words = None
        return idx

    def _rebuild_cum(self):
        if self.range_encode:
            # disjoint bins: cumulative OR == cumulative sum (no carries);
            # int64 cumsum wrapped at 2**32
            self.cum_words = bm.wrap_int32(
                torch.cumsum(self.words.to(torch.int64), dim=0))
        else:
            self.cum_words = None

    # -------------------------------------------------------------- queries
    def query_eq(self, value) -> torch.Tensor:
        key = (self.epoch, "eq", value)
        if key not in self._query_cache:
            b = int(self.bin_of(np.asarray([value]))[0]) \
                if self.bin_edges is not None else int(value)
            self._query_cache[key] = self.words[b]
        return self._query_cache[key]

    def query_isin(self, bins: list[int]) -> torch.Tensor:
        key = (self.epoch, "isin", tuple(sorted(bins)))
        if key not in self._query_cache:
            # disjoint bins: OR == sum
            sel = self.words[torch.as_tensor(sorted(bins), dtype=torch.int64,
                                             device=self.device)]
            self._query_cache[key] = bm.wrap_int32(
                sel.to(torch.int64).sum(dim=0))
        return self._query_cache[key]

    def range_bins(self, lo=None, hi=None, lo_inclusive=True,
                   hi_inclusive=True):
        """Host-only bin resolution: -> (blo, bhi, refine list).

        Empty refine list means the bin range answers the predicate exactly.
        """
        if self.bin_edges is None:
            blo = 0 if lo is None else int(lo) + (0 if lo_inclusive else 1)
            bhi = self.n_bins - 1 if hi is None else int(hi) - (0 if hi_inclusive else 1)
            return max(blo, 0), min(bhi, self.n_bins - 1), []
        edges = self.bin_edges
        refine = []
        if lo is None:
            blo = 0
        else:
            lo_eff = lo if lo_inclusive else lo + 1
            blo = int(np.searchsorted(edges, lo_eff, side="right") - 1)
            blo = max(blo, 0)
            if edges[blo] != lo_eff:
                refine.append(("lo", blo))
        if hi is None:
            bhi = self.n_bins - 1
        else:
            hi_eff = hi if hi_inclusive else hi - 1
            bhi = int(np.searchsorted(edges, hi_eff, side="right") - 1)
            bhi = min(bhi, self.n_bins - 1)
            # the last bin has no upper edge: it ends at the largest value
            # it has held
            if (edges[bhi + 1] != hi_eff + 1 if bhi + 1 < len(edges)
                    else bhi >= 0 and (self.top is None
                                       or hi_eff < self.top)):
                refine.append(("hi", bhi))
        return blo, bhi, refine

    def query_range(self, lo=None, hi=None, lo_inclusive=True,
                    hi_inclusive=True) -> RangeQueryResult:
        """Candidate bitvector for value in [lo, hi] (None = unbounded)."""
        blo, bhi, refine = self.range_bins(lo, hi, lo_inclusive, hi_inclusive)
        key = (self.epoch, "range", blo, bhi)
        if key in self._query_cache:
            return RangeQueryResult(self._query_cache[key], not refine, refine)
        out = self._range_words(blo, bhi)
        self._query_cache[key] = out
        return RangeQueryResult(out, not refine, refine)

    def _range_words(self, blo, bhi):
        if bhi < blo:
            return torch.zeros(self.n_words, dtype=torch.int32,
                               device=self.device)
        if self.cum_words is not None:
            hi_row = self.cum_words[bhi]
            if blo == 0:
                return hi_row
            # cum[lo-1] bits are a subset of cum[hi] bits -> XOR = range
            return torch.bitwise_xor(hi_row, self.cum_words[blo - 1])
        return bm.or_range(self.words, blo, bhi)

    def count(self, words: torch.Tensor) -> int:
        return int(bm.popcount(words))

    # ------------------------------------------- host-side cardinalities
    def count_eq(self, value) -> int | None:
        if self.bin_counts is None:
            return None
        b = int(self.bin_of(np.asarray([value]))[0]) \
            if self.bin_edges is not None else int(value)
        if not 0 <= b < self.n_bins:
            return 0
        return int(self.bin_counts[b])

    def count_isin(self, bins) -> int | None:
        if self.bin_counts is None:
            return None
        return int(sum(self.bin_counts[b] for b in bins
                       if 0 <= b < self.n_bins))

    def count_range(self, lo=None, hi=None, lo_inclusive=True,
                    hi_inclusive=True) -> int | None:
        """Exact result cardinality of a bin-exact range query (upper bound
        when boundary bins need refinement)."""
        if self.bin_counts is None:
            return None
        blo, bhi, _ = self.range_bins(lo, hi, lo_inclusive, hi_inclusive)
        if bhi < blo:
            return 0
        return int(self.bin_counts[blo : bhi + 1].sum())

    def clone(self) -> "CubitIndex":
        """Shallow snapshot copy (shares device tensors; private host state
        is duplicated so merges on the live index leave the clone intact)."""
        c = copy.copy(self)
        c._pending = list(self._pending)
        c._query_cache = dict(self._query_cache)
        return c

    # -------------------------------------------------------------- updates
    def _bin(self, value) -> int:
        return int(self.bin_of(np.asarray([value]))[0]) \
            if self.bin_edges is not None else int(value)

    def bins_of(self, values) -> np.ndarray:
        """`_bin` of many values at once (int64 bins)."""
        values = np.asarray(values)
        return (self.bin_of(values) if self.bin_edges is not None
                else values).astype(np.int64)

    def _raise_top(self, values):
        values = np.asarray(values)
        if self.bin_edges is not None and values.size:
            v = int(values.max())
            self.top = v if self.top is None else max(self.top, v)

    def update_many(self, rows, old_values, new_values):
        """`update` of many rows: one buffered delta a row."""
        self._raise_top(new_values)
        self._pending.extend(zip(np.asarray(rows, np.int64).tolist(),
                                 self.bins_of(old_values).tolist(),
                                 self.bins_of(new_values).tolist()))

    def delete_many(self, rows, old_values):
        """`delete` of many rows: one buffered delta a row."""
        rows = np.asarray(rows, np.int64)
        self._pending.extend(zip(rows.tolist(),
                                 self.bins_of(old_values).tolist(),
                                 [-1] * len(rows)))

    def update(self, row: int, old_value, new_value):
        """Buffer a value change for `row` (CUBIT UpdateConscious delta)."""
        self._raise_top([new_value])
        self._pending.append((row, self._bin(old_value), self._bin(new_value)))

    def delete(self, row: int, old_value):
        self._pending.append((row, self._bin(old_value), -1))

    def insert(self, row: int, new_value):
        self._raise_top([new_value])
        self._pending.append((row, -1, self._bin(new_value)))

    @property
    def pending_updates(self) -> int:
        return len(self._pending)

    def merge(self):
        """Publish a new epoch with all buffered deltas applied.

        One XOR pass: clearing the old bin's bit and setting the new bin's
        bit are both XOR-with-bit because the bit is known set/unset.  A new
        words tensor is built, so readers of the previous epoch keep theirs.
        """
        if not self._pending:
            return self.epoch
        PROF.count("cubit_merges")
        rows = np.array([p[0] for p in self._pending], dtype=np.int64)
        olds = np.array([p[1] for p in self._pending], dtype=np.int64)
        news = np.array([p[2] for p in self._pending], dtype=np.int64)
        bit = (np.uint32(1) << (rows & 31).astype(np.uint32))
        # the bits of this index's rows alone (all of them but on a mesh)
        local = rows - self.row_offset
        inside = (local >= 0) & (local < self.capacity)
        word = local >> 5
        flat_dim = self.n_bins * self.n_words
        # accumulate the flip-set host-side, apply with one device XOR pass
        delta_np = np.zeros(flat_dim, np.uint32)
        for bins in (olds, news):
            live = (bins >= 0) & inside
            if live.any():
                np.bitwise_xor.at(
                    delta_np, bins[live] * self.n_words + word[live], bit[live])
        self.words = torch.bitwise_xor(
            self.words.reshape(-1), self._upload(delta_np)
        ).reshape(self.n_bins, self.n_words)
        if self.bin_counts is not None:
            # copy-on-write: snapshots taken before this merge keep their
            # own counts (transaction rollback safety)
            self.bin_counts = self.bin_counts.copy()
            np.subtract.at(self.bin_counts, olds[olds >= 0], 1)
            np.add.at(self.bin_counts, news[news >= 0], 1)
        self._rebuild_cum()
        self._pending.clear()
        self._query_cache.clear()
        self.epoch += 1
        return self.epoch
