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
the plain torch body (`*_reference`).  On the card nothing is filled
before a launch: `out` and `bad` come from `torch.empty` and the kernel
writes both, counting its blocks in the stream's self-resetting scratch
(`cuda_build.stream_scratch`).  The kernels load and store 16 B at a time,
so `out` is allocated at the same offset from a 16-B boundary as the
indices (`out_like`): a view such as `idx[1:]` takes the int4 path after
its first 1-3 indices.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, sm_count, stream_scratch

# int32 entries of the largest table: 48 KB, the shared memory a block
# gets without opting in to more
MAX_TABLE = 48 * 1024 // 4
LANES = 128

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
TABLE_KERNEL = CudaKernel("k5a", "table_gather.cu", "table_gather_launch",
                          _ARGTYPES)
LANE_KERNEL = CudaKernel("k5b", "lane_gather.cu", "lane_gather_launch",
                         _ARGTYPES)


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


def out_like(idx: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor shaped like `idx` that starts at the same
    offset from a 16-B boundary as `idx` (a view into a buffer up to 3
    entries longer), so the kernels' int4 loads and stores line up."""
    shift = idx.data_ptr() % 16 // idx.element_size()
    buf = torch.empty(idx.numel() + shift, dtype=idx.dtype, device=idx.device)
    return buf[shift:].view(idx.shape)


def _device_body(kernel, table, table_size, idx, n):
    """Launch `kernel` on the card: -> (out shaped like idx, bad)."""
    device = idx.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = out_like(idx)
    if not n:
        return out, torch.zeros((), dtype=torch.int32, device=device)
    bad = torch.empty((), dtype=torch.int32, device=device)
    kernel.launch(device, table.data_ptr(), table_size, idx.data_ptr(), n,
                  out.data_ptr(), stream_scratch(device).data_ptr(),
                  bad.data_ptr(), sm_count(device))
    return out, bad


def table_gather(tab, idx):
    """K5a: out = tab.flat[idx] (any shapes, contiguous int32); -> (out
    shaped like idx, bad = count of indices outside [0, tab.numel()))."""
    _check_table(tab, idx)
    if idx.device.type == "cpu":
        return table_gather_reference(tab, idx)
    return _device_body(TABLE_KERNEL, tab, tab.numel(), idx, idx.numel())


def lane_gather(tab2, lane_idx):
    """K5b: out[r, c] = tab2[r % rows, lane_idx[r, c]] for (rows, 128) and
    (R, 128) int32; -> (out, bad = count of lane indices outside
    [0, 128))."""
    _check_lanes(tab2, lane_idx)
    if lane_idx.device.type == "cpu":
        return lane_gather_reference(tab2, lane_idx)
    return _device_body(LANE_KERNEL, tab2, tab2.shape[0], lane_idx,
                        lane_idx.shape[0])
