"""Monotone direct-address gather: the PK-FK join probe.

Counterpart of `duckdb_cubit_tpu/ops/pallas_probe.py`.  The wrapper
`monotone_gather(lut, keys) -> (out, overflow)` computes `out[i] =
lut[keys[i]]` for int32 keys that should be non-decreasing and lie in
`[0, len(lut))`, with `-1` in the lut marking an absent slot.  `overflow` is
an int32 0-d tensor counting the keys that break that precondition (out of
range, or smaller than their predecessor); such keys get `out = -1`.  A
caller records `overflow == 0` as a deferred check, and the executor
retries the query on the plain lut path when it fails, as the reference
does.  The wrapper has two bodies, chosen only by the tensors' device:

  - CUDA tensors launch the hand-written kernel in `csrc/monotone_gather.cu`
    (built by `cuda_build` at first use), or raise;
  - CPU tensors run `monotone_gather_reference`, the plain torch version,
    which computes the same `out` and `overflow` bit for bit.

The TPU kernel's 131072-key blocks, lut windows and candidate-row picks
exist only because Mosaic has no per-element gather, and its overflow meant
"keys too sparse for the window".  On the card every in-range sorted key is
gathered exactly, so sparse keys never overflow here.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel

# the reference's minimum probe size: 131072-key blocks, a quarter full
MIN_KEYS = 32768

KERNEL = CudaKernel(
    "monotone_gather.cu", "monotone_gather_launch",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])

# launches of the CUDA kernel (never counts the plain body)
launch_count = 0


def plan_monotone_gather(n_keys: int, lut_size: int) -> bool:
    """Host gate of the kernel path, the reference's: enough keys to be
    worth a kernel pass, and a non-empty lut."""
    return n_keys >= MIN_KEYS and lut_size > 0


def _check(lut: torch.Tensor, keys: torch.Tensor):
    for name, t in (("lut", lut), ("keys", keys)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: int32 expected, got {t.dtype}")
        if t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: a contiguous 1-d tensor expected")
    if lut.device != keys.device:
        raise ValueError("lut and keys must share one device")
    if lut.shape[0] == 0:
        raise ValueError("empty lut")


def monotone_gather_reference(lut: torch.Tensor, keys: torch.Tensor):
    """Plain torch version: -> (out int32, overflow int32 0-d)."""
    k = keys.to(torch.int64)
    bad = (k < 0) | (k >= lut.shape[0])
    bad[1:] |= k[1:] < k[:-1]
    out = torch.where(bad, torch.full_like(keys, -1),
                      lut[k.clamp(0, lut.shape[0] - 1)])
    return out, bad.sum().to(torch.int32)


def monotone_gather(lut: torch.Tensor, keys: torch.Tensor):
    """out[i] = lut[keys[i]] for non-decreasing int32 keys in
    [0, len(lut)); -> (out int32, overflow int32 0-d)."""
    global launch_count
    _check(lut, keys)
    if keys.device.type == "cpu":
        return monotone_gather_reference(lut, keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    out = torch.empty_like(keys)
    overflow = torch.zeros((), dtype=torch.int32, device=keys.device)
    n = keys.shape[0]
    if n == 0:
        return out, overflow
    KERNEL.launch(keys.device, lut.data_ptr(), lut.shape[0], keys.data_ptr(),
                  n, out.data_ptr(), overflow.data_ptr())
    launch_count += 1
    return out, overflow


def gather_via_sort(lut: torch.Tensor, keys: torch.Tensor):
    """out[i] = lut[clip(keys[i])] for arbitrary int32 keys: a stable sort
    of (key, position), the monotone gather, and a scatter back.
    -> (out, overflow)."""
    kc = keys.to(torch.int64).clamp(0, lut.shape[0] - 1).to(torch.int32)
    ks, pos = torch.sort(kc, stable=True)
    vals, overflow = monotone_gather(lut, ks)
    out = torch.empty_like(vals)
    out[pos] = vals
    return out, overflow
