"""Bitvector word kernels: the device compute core of the CUBIT index.

Counterpart of `duckdb_cubit_tpu/ops/bitmap.py`.  Bitmaps are
`[n_bins, n_words]` tensors of 32-bit words; bit (r & 31) of word (r >> 5)
covers row r, the reference's word order exactly.  Words are held as
**int32 bit patterns** (the reference's uint32 values viewed as int32):
torch's CPU build has no uint32 shifts or sums.  Right shifts of int32 are
arithmetic, so single bits are always masked with `& 1` after the shift, and
sums of disjoint bit sets are taken in int64 and wrapped back to 32 bits.
"""

from __future__ import annotations

import torch

WORD_BITS = 32


def num_words(capacity: int) -> int:
    return (capacity + WORD_BITS - 1) // WORD_BITS


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken modulo 2**32 -> the int32 with the same low 32
    bits (what a uint32 sum gives, as a bit pattern)."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)


def or_range(bitmaps: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """OR of bins [lo, hi] — disjointness makes this an integer sum."""
    if hi < lo:
        return torch.zeros(bitmaps.shape[1], dtype=torch.int32,
                           device=bitmaps.device)
    return wrap_int32(bitmaps[lo : hi + 1].to(torch.int64).sum(dim=0))


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits over all words -> int64 0-d tensor (SWAR on the unsigned
    value widened to int64, so no arithmetic shift brings in sign bits)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101) & 0xFFFFFFFF
    return (x >> 24).sum()


def expand(words: torch.Tensor, capacity: int) -> torch.Tensor:
    """Bitvector -> bool row mask of length `capacity`."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:capacity].to(torch.bool)


def pack_mask(mask: torch.Tensor, n_words: int) -> torch.Tensor:
    """bool row mask -> int32 bitvector words (inverse of `expand`)."""
    n = mask.shape[0]
    padded = torch.zeros(n_words * WORD_BITS, dtype=torch.int64,
                         device=mask.device)
    padded[:n] = mask.to(torch.int64)
    lanes = padded.reshape(n_words, WORD_BITS)
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=mask.device) \
        << torch.arange(WORD_BITS, dtype=torch.int64, device=mask.device)
    return wrap_int32((lanes * weights[None, :]).sum(dim=1))
