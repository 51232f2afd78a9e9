"""Stream compaction of a bool mask into a selection vector: K7.

`mask_to_indices(mask, capacity) -> (idx, count)` returns `idx[capacity]`
int64, the ids of the mask's set rows in ascending order (the first
`capacity` of them), and `count`, a 0-d int64 device tensor holding the
number of set rows, even when it exceeds `capacity`; the slots from
`min(count, capacity)` to `capacity` hold `len(mask)`, an out-of-range
sentinel.  Nothing waits for the device.  It has two bodies, chosen only by
the tensor's device:

  - CUDA tensors launch the hand-written kernel in `csrc/stream_compact.cu`
    (built by `cuda_build` at first use): one read of the mask, prefix sums
    with decoupled look-back, or raise;
  - CPU tensors run `mask_to_indices_reference`, the plain torch version:
    a stable sort of the inverted mask, as the JAX package computes it
    (`duckdb_cubit_tpu/ops/kernels.py`, `mask_to_indices`).

The mask must be a contiguous 1-d bool tensor of fewer than 2**31 rows.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, sm_count

# mask bytes of one tile of the kernel (`kTileBytes` in the source)
TILE_BYTES = 16384
MAX_ROWS = 2**31 - 1

KERNEL = CudaKernel(
    "stream_compact.cu", "stream_compact_launch",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p])

# launches of the CUDA kernel (never counts the plain body)
launch_count = 0


def _check(mask: torch.Tensor):
    if mask.dtype != torch.bool:
        raise TypeError(f"a bool mask expected, got {mask.dtype}")
    if mask.ndim != 1 or not mask.is_contiguous():
        raise ValueError("a contiguous 1-d mask expected")
    if mask.shape[0] > MAX_ROWS:
        raise ValueError(f"a mask of {mask.shape[0]} rows; the kernel takes "
                         f"fewer than 2**31")


def mask_to_indices_reference(mask: torch.Tensor, capacity: int):
    """Plain torch version: selected rows first in row order by a stable
    sort on the inverted mask. -> (indices[capacity] int64, count 0-d
    int64)."""
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


def status_words(mask: torch.Tensor) -> int:
    """int64 words of the kernel's scratch for `mask`: one status word a
    tile, tiles counted from the 16-B boundary at or below the mask's
    start, and the tile counter."""
    span = (mask.data_ptr() & 15) + mask.shape[0]
    return -(-span // TILE_BYTES) + 1


def mask_to_indices(mask: torch.Tensor, capacity: int):
    """Row ids of the set rows of a bool mask. -> (indices[capacity] int64,
    count 0-d int64); see the module's docstring."""
    global launch_count
    _check(mask)
    if mask.device.type == "cpu":
        return mask_to_indices_reference(mask, capacity)
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    n = mask.shape[0]
    out = torch.empty(capacity, dtype=torch.int64, device=mask.device)
    count = torch.empty((), dtype=torch.int64, device=mask.device)
    if n == 0:
        return out.fill_(0), count.zero_()
    status = torch.empty(status_words(mask), dtype=torch.int64,
                         device=mask.device)
    KERNEL.launch(mask.device, mask.data_ptr(), n, capacity, out.data_ptr(),
                  status.data_ptr(), status.shape[0], count.data_ptr(),
                  sm_count(mask.device))
    launch_count += 1
    return out, count


def compact_bytes(n: int, capacity: int) -> int:
    """Bytes K7 must move (the bound's numerator): the mask read once and
    every slot of the selection vector written once."""
    return n + 8 * capacity
