"""Gathers from a small on-chip table: kernels K5a and K5b.

Counterpart of the four Pallas bodies of `benchmarks/pallas_gather_probe.py`
(`try_kernel`), which tried which dynamic-gather forms Mosaic supports:

  - `table_gather(tab, idx)`: out = tab.flat[idx], for `kA` (1-D table and
    indices), `kA2` ((T/128, 128) table, (N/128, 128) indices) and `kC`
    (the same shapes through a one-hot compare / select / sum).  The three
    compute one function; on the card they are one kernel, since a
    contiguous (N/128, 128) tensor is the same memory as its flat view.  The
    table is at most `MAX_TABLE` int32 (48 KB of shared memory).
  - `lane_gather(tab2, lane_idx)`: out[r, c] = tab2[r % rows, lane_idx[r, c]]
    for a (rows, 128) table, for `kB` (`take_along_axis` along the lanes of
    the tiled table).

Both return `(out, bad)`: `bad` is an int32 0-d tensor counting indices
outside the table (`[0, T)`, or `[0, 128)` for lanes), whose output is 0;
the kernels never read out of bounds, and a caller checks `bad == 0` as it
checks K2's overflow.  Each wrapper has two bodies, chosen only by the
tensors' device: CUDA tensors launch the hand-written kernel
(`csrc/table_gather.cu`, `csrc/lane_gather.cu`) or raise; CPU tensors run
the plain torch body (`*_reference`).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, sm_count

# int32 entries of the largest table: 48 KB, static shared memory
MAX_TABLE = 48 * 1024 // 4
LANES = 128

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p]
TABLE_KERNEL = CudaKernel("table_gather.cu", "table_gather_launch",
                          _ARGTYPES)
LANE_KERNEL = CudaKernel("lane_gather.cu", "lane_gather_launch", _ARGTYPES)

# launches of each CUDA kernel (never counts the plain bodies)
table_launch_count = 0
lane_launch_count = 0


def _check_int32(name: str, t: torch.Tensor, device):
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: int32 expected, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: a contiguous tensor expected")
    if t.device != device:
        raise ValueError("table and indices must share one device")


def _check_table(tab, idx):
    _check_int32("tab", tab, idx.device)
    _check_int32("idx", idx, idx.device)
    if not 0 < tab.numel() <= MAX_TABLE:
        raise ValueError(f"table of {tab.numel()} entries: 1 to {MAX_TABLE} "
                         f"int32 fit in shared memory")


def _check_lanes(tab2, lane_idx):
    _check_int32("tab2", tab2, lane_idx.device)
    _check_int32("lane_idx", lane_idx, lane_idx.device)
    for name, t in (("tab2", tab2), ("lane_idx", lane_idx)):
        if t.ndim != 2 or t.shape[1] != LANES:
            raise ValueError(f"{name}: (rows, {LANES}) expected, got "
                             f"{tuple(t.shape)}")
    if tab2.shape[0] == 0:
        raise ValueError("empty table")


def table_gather_reference(tab, idx):
    """Plain torch body of K5a: -> (out shaped like idx, bad)."""
    flat = tab.reshape(-1)
    j = idx.to(torch.int64)
    bad = (j < 0) | (j >= flat.shape[0])
    out = torch.where(bad, torch.zeros_like(idx),
                      flat[j.clamp(0, flat.shape[0] - 1)])
    return out, bad.sum().to(torch.int32)


def lane_gather_reference(tab2, lane_idx):
    """Plain torch body of K5b: -> (out (R, 128), bad)."""
    j = lane_idx.to(torch.int64)
    bad = (j < 0) | (j >= LANES)
    rows = torch.arange(lane_idx.shape[0], device=lane_idx.device) \
        % tab2.shape[0]
    out = torch.where(bad, torch.zeros_like(lane_idx),
                      tab2[rows[:, None], j.clamp(0, LANES - 1)])
    return out, bad.sum().to(torch.int32)


def _device_body(kernel, table, table_size, idx, n):
    """Launch `kernel` on the card: -> (out shaped like idx, bad)."""
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    out = torch.empty_like(idx)
    bad = torch.zeros((), dtype=torch.int32, device=idx.device)
    if n:
        kernel.launch(idx.device, table.data_ptr(), table_size,
                      idx.data_ptr(), n, out.data_ptr(), bad.data_ptr(),
                      sm_count(idx.device))
    return out, bad


def table_gather(tab, idx):
    """K5a: out = tab.flat[idx] (any shapes, contiguous int32); -> (out
    shaped like idx, bad = count of indices outside [0, tab.numel()))."""
    global table_launch_count
    _check_table(tab, idx)
    if idx.device.type == "cpu":
        return table_gather_reference(tab, idx)
    result = _device_body(TABLE_KERNEL, tab, tab.numel(), idx, idx.numel())
    if idx.numel():
        table_launch_count += 1
    return result


def lane_gather(tab2, lane_idx):
    """K5b: out[r, c] = tab2[r % rows, lane_idx[r, c]] for (rows, 128) and
    (R, 128) int32; -> (out, bad = count of lane indices outside
    [0, 128))."""
    global lane_launch_count
    _check_lanes(tab2, lane_idx)
    if lane_idx.device.type == "cpu":
        return lane_gather_reference(tab2, lane_idx)
    result = _device_body(LANE_KERNEL, tab2, tab2.shape[0], lane_idx,
                          lane_idx.shape[0])
    if lane_idx.shape[0]:
        lane_launch_count += 1
    return result
