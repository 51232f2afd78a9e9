"""Low-level tensor primitives shared by the operator library.

Counterpart of the subset of `duckdb_cubit_tpu/ops/kernels.py` that the
single-table scan/aggregate path runs: order-preserving int64 keys, exact
split (hi, lo) sums, and selection-vector compaction.  Hashing, grouped and
segment reductions come with the grouped-aggregation and join slices.

Exactness note: every int64 sum is computed as a split (hi, lo) pair — lo
sums the low 32 bits, hi the arithmetically-shifted high 32 bits — and
recombined as (hi << 32) + lo, so no part can overflow for any realistic
row count.
"""

from __future__ import annotations

import torch

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


# ------------------------------------------------------------- compaction


def mask_to_indices(mask: torch.Tensor,
                    capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Selection-vector materialization: row ids of set mask bits.

    Returns (indices[capacity] int64, count 0-d int64 tensor); selected rows
    come first in row order (a stable sort on the inverted mask), and
    padding slots hold len(mask), an out-of-range sentinel.  The count stays
    on the device: no host sync.
    """
    n = mask.shape[0]
    inv = (~mask).to(torch.int32)
    _, perm = torch.sort(inv, stable=True)
    count = mask.to(torch.int64).sum()
    if capacity > n:
        perm = torch.cat([perm, torch.full((capacity - n,), n,
                                           dtype=perm.dtype,
                                           device=mask.device)])
    take = perm[:capacity].to(torch.int64)
    slots = torch.arange(capacity, device=mask.device)
    return torch.where(slots < count, take, torch.full_like(take, n)), count


def gather_columns(arrays: dict, indices: torch.Tensor) -> dict:
    """Probe columns through a selection vector (clipped; caller keeps count)."""
    return {name: arr[torch.clamp(indices, max=arr.shape[0] - 1)]
            for name, arr in arrays.items()}
