"""Fused CUBIT bitmap scan + exact SUM: the Q6 hot loop.

Counterpart of `duckdb_cubit_tpu/ops/pallas_kernels.py`.  The wrapper
`fused_scan_sum(words, payloads, packed)` returns the exact int64 sum, over
the rows whose bit is set in `words`, of one int32 payload, of the product of
two, or of `(p & 0xFFFFFF) * ((p >> 24) & 0xFF)` for one column packed by
`pack_columns`.  It has two bodies, chosen only by the tensors' device:

  - CUDA tensors launch the hand-written kernel in `csrc/fused_scan_sum.cu`
    (built by `cuda_build` with nvcc for sm_90a at first use, bound
    through ctypes), or raise;
  - CPU tensors run `fused_scan_sum_reference`, the plain torch version.

The TPU kernel's bit-plane word layout, hi/lo split sums and split search
(`plane_pack`, `plan_fused_scan`) exist only for Mosaic's limits (no int64,
no cross-lane shuffles); this kernel reads words in `ops/bitmap.py` order and
accumulates in int64.  Callers keep the reference's gate (non-negative
payloads, product bound below 2**31), so the same queries take this path.
"""

from __future__ import annotations

import ctypes

import torch

from . import bitmap as bm
from .cuda_build import CudaKernel

MODE_SINGLE, MODE_PAIR, MODE_PACKED = 0, 1, 2

KERNEL = CudaKernel(
    "fused_scan_sum.cu", "fused_scan_sum_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])

# launches of the CUDA kernel (never counts the plain body)
launch_count = 0


def pack_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pack two non-negative int columns (a < 2^24, b < 2^8) into one int32
    (`a` low, `b` in the top byte): the scan then streams 4 B/row instead
    of 8."""
    return bm.wrap_int32(a.to(torch.int64) | (b.to(torch.int64) << 24))


def _check(words: torch.Tensor, payloads, packed: bool) -> int:
    """Validate the inputs; -> the launch mode."""
    if packed:
        if len(payloads) != 1:
            raise ValueError("packed mode takes exactly one payload column")
        mode = MODE_PACKED
    elif len(payloads) == 1:
        mode = MODE_SINGLE
    elif len(payloads) == 2:
        mode = MODE_PAIR
    else:
        raise ValueError(f"one or two payload columns, got {len(payloads)}")
    tensors = [words, *payloads]
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"int32 tensors expected, got {t.dtype}")
        if t.ndim != 1 or not t.is_contiguous():
            raise ValueError("contiguous 1-d tensors expected")
        if t.device != words.device:
            raise ValueError("words and payloads must share one device")
    n = payloads[0].shape[0]
    if any(p.shape[0] != n for p in payloads):
        raise ValueError("payload columns differ in length")
    if words.shape[0] < bm.num_words(n):
        raise ValueError(f"{words.shape[0]} words cannot cover {n} rows")
    return mode


def fused_scan_sum_reference(words: torch.Tensor, payloads: list,
                             packed: bool) -> torch.Tensor:
    """Plain torch version: expand the words, form the int64 value, sum."""
    n = payloads[0].shape[0]
    mask = bm.expand(words, n)
    if packed:
        p = payloads[0].to(torch.int64)
        val = (p & 0xFFFFFF) * ((p >> 24) & 0xFF)
    else:
        val = payloads[0].to(torch.int64)
        for q in payloads[1:]:
            val = val * q.to(torch.int64)
    return torch.where(mask, val, torch.zeros_like(val)).sum()


def fused_scan_sum(words: torch.Tensor, payloads: list,
                   packed: bool) -> torch.Tensor:
    """-> exact int64 0-d tensor: sum over set rows of the payload value.

    words: int32 (>= ceil(n/32),) bitvector; payloads: one or two int32
    (n,) columns, or one packed column when `packed`."""
    global launch_count
    mode = _check(words, payloads, packed)
    if words.device.type == "cpu":
        return fused_scan_sum_reference(words, payloads, packed)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    launch = KERNEL.function()
    n = payloads[0].shape[0]
    out = torch.zeros((), dtype=torch.int64, device=words.device)
    a = payloads[0]
    b = payloads[1] if mode == MODE_PAIR else payloads[0]
    sms = torch.cuda.get_device_properties(words.device).multi_processor_count
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(words.data_ptr(), a.data_ptr(), b.data_ptr(), n, mode,
                    out.data_ptr(), sms, stream)
    if rc != 0:
        raise RuntimeError(f"fused_scan_sum launch failed: CUDA error {rc}")
    launch_count += 1
    return out
