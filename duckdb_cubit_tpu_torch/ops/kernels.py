"""Low-level tensor primitives shared by the operator library.

Counterpart of `duckdb_cubit_tpu/ops/kernels.py`: hashing, order-preserving
int64 keys, exact split (hi, lo) sums, grouped and sorted-segment
reductions, the multi-key sort, and selection-vector compaction.

Exactness note: every int64 sum is computed as a split (hi, lo) pair — lo
sums the low 32 bits, hi the arithmetically-shifted high 32 bits — and
recombined as (hi << 32) + lo, so no part can overflow for any realistic
row count.
"""

from __future__ import annotations

import torch

from . import compact

# ----------------------------------------------------------------- hashing
#
# torch has no uint64 arithmetic, so the reference's uint64 hash runs on
# int64 bit patterns: adds and multiplies wrap modulo 2**64 on the CPU and
# the card alike, and a logical right shift is the arithmetic shift with
# the sign-extended top bits masked off.  Results are the reference's
# uint64 values viewed as int64.


def _signed(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_GOLDEN64 = _signed(0x9E3779B97F4A7C15)
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def hash64(keys: torch.Tensor) -> torch.Tensor:
    """64-bit avalanche hash (splitmix64 finalizer) of an int key column,
    as int64 bit patterns."""
    x = keys.to(torch.int64) + _GOLDEN64
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


def hash_combine(h: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Combine hashes of multiple key columns."""
    h = h.to(torch.int64)
    return hash64(h ^ (other.to(torch.int64) + _GOLDEN64 + (h << 6)
                       + _shr(h, 2)))


# ----------------------------------------------- order-preserving keys

_SIGN_LOW = 0x7FFFFFFFFFFFFFFF


def monotone_i64(array: torch.Tensor) -> torch.Tensor:
    """Order- and equality-preserving int64 key for any numeric column.

    Floats bitcast to int64 with the low 63 bits flipped for negatives (the
    IEEE-754 total-order trick); -0.0 is normalized to +0.0 first.  The
    transform is an involution on the bit pattern, so `monotone_i64_inverse`
    recovers exact float values.
    """
    if array.is_floating_point():
        a = array.to(torch.float64)
        a = torch.where(a == 0, torch.zeros_like(a), a)
        bits = a.view(torch.int64)
        return bits ^ ((bits >> 63) & _SIGN_LOW)
    return array.to(torch.int64)


def monotone_i64_inverse(keys: torch.Tensor, floating: bool) -> torch.Tensor:
    """Invert monotone_i64 (float64 out when `floating`)."""
    if floating:
        bits = keys ^ ((keys >> 63) & _SIGN_LOW)
        return bits.view(torch.float64)
    return keys


# ------------------------------------------------------------- exact sums


def _split_hi_lo(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    lo = values & 0xFFFFFFFF  # [0, 2**32)
    hi = values >> 32  # arithmetic shift keeps sign
    return hi, lo


def masked_sum_exact(values: torch.Tensor, mask: torch.Tensor):
    """Exact masked int64 sum -> (hi, lo) 0-d device tensors."""
    hi, lo = _split_hi_lo(torch.where(mask, values, torch.zeros_like(values)))
    return hi.sum(), lo.sum()


def combine_hi_lo(hi, lo) -> int:
    """Host-side exact recombination of a split sum."""
    return (int(hi) << 32) + int(lo)


# below this group count, grouped reductions unroll into per-group masked
# reduces instead of a scatter
SMALL_GROUP_LIMIT = 32


def group_sum_exact(codes: torch.Tensor, values: torch.Tensor,
                    mask: torch.Tensor, num_groups: int,
                    small_limit: int = SMALL_GROUP_LIMIT):
    """Exact grouped int64 sum -> (hi, lo) tensors of `num_groups`.

    Integer adds are order-independent, so both strategies (unrolled masked
    reduces for small domains, index_add otherwise) are deterministic.
    `codes` must be in [0, num_groups); masked-out rows are dropped."""
    hi, lo = _split_hi_lo(torch.where(mask, values, torch.zeros_like(values)))
    if num_groups <= small_limit:
        zero = torch.zeros_like(hi)
        ghi = torch.stack([torch.where(codes == g, hi, zero).sum()
                           for g in range(num_groups)])
        glo = torch.stack([torch.where(codes == g, lo, zero).sum()
                           for g in range(num_groups)])
        return ghi, glo
    safe = torch.where(mask, codes, torch.zeros_like(codes)).to(torch.int64)
    ghi = torch.zeros(num_groups, dtype=torch.int64,
                      device=values.device).index_add_(0, safe, hi)
    glo = torch.zeros(num_groups, dtype=torch.int64,
                      device=values.device).index_add_(0, safe, lo)
    return ghi, glo


def group_count(codes: torch.Tensor, mask: torch.Tensor, num_groups: int,
                small_limit: int = SMALL_GROUP_LIMIT):
    ones = mask.to(torch.int64)
    if num_groups <= small_limit:
        zero = torch.zeros_like(ones)
        return torch.stack([torch.where(codes == g, ones, zero).sum()
                            for g in range(num_groups)])
    safe = torch.where(mask, codes, torch.zeros_like(codes)).to(torch.int64)
    return torch.zeros(num_groups, dtype=torch.int64,
                       device=mask.device).index_add_(0, safe, ones)


def _group_extreme(codes, values, mask, num_groups, sentinel, small_limit,
                   want_max: bool):
    fill = torch.full_like(values, sentinel)
    vals = torch.where(mask, values, fill)
    if num_groups <= small_limit:
        pick = torch.amax if want_max else torch.amin
        return torch.stack([pick(torch.where(codes == g, vals, fill))
                            for g in range(num_groups)])
    safe = torch.where(mask, codes, torch.zeros_like(codes)).to(torch.int64)
    out = torch.full((num_groups,), sentinel, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, safe, vals,
                               reduce="amax" if want_max else "amin")


def group_min(codes, values, mask, num_groups, sentinel,
              small_limit: int = SMALL_GROUP_LIMIT):
    return _group_extreme(codes, values, mask, num_groups, sentinel,
                          small_limit, want_max=False)


def group_max(codes, values, mask, num_groups, sentinel,
              small_limit: int = SMALL_GROUP_LIMIT):
    return _group_extreme(codes, values, mask, num_groups, sentinel,
                          small_limit, want_max=True)


# ----------------------------------------------------- sorted segment ops
#
# Grouped reductions over large group domains run in group-sorted order: sort
# rows by group id once, then every aggregate is a cumsum and two boundary
# gathers (the reference's choice, because scatter with duplicate indices
# serializes on a TPU).


def lexsort(keys) -> torch.Tensor:
    """Row permutation ordering by keys[0], then keys[1], ...; ties keep row
    order.  torch has no multi-key sort, so this is a chain of stable sorts
    from the last key to the first (least significant first)."""
    perm = None
    for k in reversed(list(keys)):
        if perm is None:
            _, perm = torch.sort(k, stable=True)
        else:
            _, idx = torch.sort(k[perm], stable=True)
            perm = perm[idx]
    return perm


def sort_by_group(gids: torch.Tensor, valid: torch.Tensor):
    """Sort row ids by group id; invalid rows sort last.

    Returns (gid_sorted, srows): gid_sorted is non-decreasing and invalid
    rows carry gid = 2**31 - 1 (past any real group)."""
    key = torch.where(valid, gids.to(torch.int32),
                      torch.full_like(gids, 2**31 - 1, dtype=torch.int32))
    return torch.sort(key, stable=True)


def segment_bounds(gid_sorted: torch.Tensor, num_groups: int):
    """(start, end) row ranges per group id in [0, num_groups)."""
    probes = torch.arange(num_groups + 1, dtype=gid_sorted.dtype,
                          device=gid_sorted.device)
    edges = torch.searchsorted(gid_sorted.contiguous(), probes, side="left")
    return edges[:-1], edges[1:]


def _segment_sum_from_cumsum(csum, start, end):
    """Per-group sums from an inclusive cumsum (boundary difference)."""
    has = end > start
    zero = torch.zeros((), dtype=csum.dtype, device=csum.device)
    top = torch.where(has, csum[torch.clamp(end - 1, min=0)], zero)
    base = torch.where(start > 0, csum[torch.clamp(start - 1, min=0)], zero)
    return torch.where(has, top - base, zero)


def segment_sum_exact(v_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                      start: torch.Tensor, end: torch.Tensor):
    """Exact grouped int64 sum over group-sorted rows -> (hi, lo), with the
    split-sum contract of group_sum_exact (each cumsum stays < 2**63)."""
    hi, lo = _split_hi_lo(torch.where(valid_sorted, v_sorted,
                                      torch.zeros_like(v_sorted)))
    return (_segment_sum_from_cumsum(torch.cumsum(hi, 0), start, end),
            _segment_sum_from_cumsum(torch.cumsum(lo, 0), start, end))


def segment_count(valid_sorted: torch.Tensor, start, end):
    c = torch.cumsum(valid_sorted.to(torch.int64), 0)
    return _segment_sum_from_cumsum(c, start, end)


def segment_minmax(gids, values, valid, num_groups: int, sentinel,
                   want_max: bool):
    """Grouped min/max via a (gid, value) sort + boundary gather."""
    key = torch.where(valid, gids.to(torch.int64),
                      torch.full_like(gids, num_groups, dtype=torch.int64))
    v = values.to(torch.int64)
    vkey = torch.where(valid, -v if want_max else v,
                       torch.full_like(v, 2**62))
    perm = lexsort((key, vkey))
    gk, vk = key[perm], vkey[perm]
    start, end = segment_bounds(gk, num_groups)
    has = end > start
    best = vk[torch.clamp(start, max=vk.shape[0] - 1)]
    if want_max:
        best = -best
    return torch.where(has, best, torch.full_like(best, sentinel))


# ------------------------------------------------------------- compaction


# selection vectors: K7 on a card, the plain sort on the CPU (`compact.py`)
mask_to_indices = compact.mask_to_indices


def gather_columns(arrays: dict, indices: torch.Tensor) -> dict:
    """Probe columns through a selection vector (clipped; caller keeps count)."""
    return {name: arr[torch.clamp(indices, max=arr.shape[0] - 1)]
            for name, arr in arrays.items()}
