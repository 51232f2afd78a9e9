"""Monotone direct-address gather: the PK-FK join probe.

Counterpart of `duckdb_cubit_tpu/ops/pallas_probe.py`.  The wrapper
`monotone_gather_many(luts, keys) -> (outs, overflow)` computes `outs[j, i]
= luts[j][keys[i]]` for any number of luts of one length and int32 keys
that should be non-decreasing and lie in `[0, len(lut))`, with `-1` in
the row lut marking an absent slot.  `overflow` is an int32 0-d tensor
counting the keys that break that precondition (out of range, or smaller
than their predecessor), once however many luts there are; such keys get
`-1` in every output.  `monotone_gather(lut, keys) -> (out, overflow)` is
the one-lut case.  A caller records `overflow == 0` as a deferred check, and
the executor retries the query on the plain lut path when it fails, as the
reference does.  The wrappers have two bodies, chosen only by the tensors'
device:

  - CUDA tensors launch the hand-written kernel in `csrc/monotone_gather.cu`
    (built by `cuda_build` at first use), one launch per `MAX_LUTS` luts, or
    raise;
  - CPU tensors run `monotone_gather_many_reference`, the plain torch
    version, which computes the same `outs` and `overflow` bit for bit.

The TPU kernel's 131072-key blocks, lut windows and candidate-row picks
exist only because Mosaic has no per-element gather, and its overflow meant
"keys too sparse for the window".  On the card every in-range sorted key is
gathered exactly, so sparse keys never overflow here.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, sm_count

# the reference's minimum probe size: 131072-key blocks, a quarter full
MIN_KEYS = 32768
# luts one launch gathers from (the kernel's pointer struct)
MAX_LUTS = 8

KERNEL = CudaKernel(
    "k2", "monotone_gather.cu", "monotone_gather_many_launch",
    [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def plan_monotone_gather(n_keys: int, lut_size: int) -> bool:
    """Host gate of the kernel path, the reference's: enough keys to be
    worth a kernel pass, and a non-empty lut."""
    return n_keys >= MIN_KEYS and lut_size > 0


def _name(j: int) -> str:
    return "keys" if j == 0 else f"lut {j - 1}"


def _check(luts, keys: torch.Tensor):
    if not luts:
        raise ValueError("at least one lut expected")
    for j, t in enumerate([keys, *luts]):
        if t.dtype != torch.int32:
            raise TypeError(f"{_name(j)}: int32 expected, got {t.dtype}")
        if t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{_name(j)}: a contiguous 1-d tensor expected")
        if t.device != keys.device:
            raise ValueError("luts and keys must share one device")
    if luts[0].shape[0] == 0:
        raise ValueError("empty lut")
    if any(t.shape[0] != luts[0].shape[0] for t in luts):
        raise ValueError("luts differ in length")


def monotone_gather_many_reference(luts, keys: torch.Tensor):
    """Plain torch version: -> (outs int32 (len(luts), n), overflow int32
    0-d)."""
    size = luts[0].shape[0]
    k = keys.to(torch.int64)
    bad = (k < 0) | (k >= size)
    bad[1:] |= k[1:] < k[:-1]
    kc = k.clamp(0, size - 1)
    outs = torch.stack([torch.where(bad, torch.full_like(keys, -1), lut[kc])
                        for lut in luts])
    return outs, bad.sum().to(torch.int32)


def monotone_gather_reference(lut: torch.Tensor, keys: torch.Tensor):
    """Plain torch version of the one-lut case: -> (out int32, overflow
    int32 0-d)."""
    outs, overflow = monotone_gather_many_reference([lut], keys)
    return outs[0], overflow


def _launch(luts, keys, outs, overflow, n: int):
    """One kernel launch over at most MAX_LUTS luts into rows of `outs`."""
    ptrs = (ctypes.c_void_p * MAX_LUTS)(*[t.data_ptr() for t in luts])
    KERNEL.launch(keys.device, ptrs, len(luts), luts[0].shape[0],
                  keys.data_ptr(), n, outs.data_ptr(), outs.stride(0),
                  overflow.data_ptr(), sm_count(keys.device))


def monotone_gather_many(luts, keys: torch.Tensor):
    """outs[j, i] = luts[j][keys[i]] for non-decreasing int32 keys in
    [0, len(lut)), luts of one length; -> (outs int32 (len(luts), n), each
    row contiguous; overflow int32 0-d, the number of bad keys)."""
    luts = list(luts)
    _check(luts, keys)
    if keys.device.type == "cpu":
        return monotone_gather_many_reference(luts, keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    n = keys.shape[0]
    # rows padded to a multiple of 4 and shifted so that each row has the
    # keys' address modulo 16: the kernel's whole quads are 16-B aligned in
    # both (a view such as keys[1:] starts 4 B past a boundary)
    shift = (keys.data_ptr() >> 2) & 3
    stride = (shift + n + 3) // 4 * 4
    buf = torch.empty((len(luts), stride), dtype=torch.int32,
                      device=keys.device)
    outs = buf[:, shift:shift + n]
    overflow = torch.empty((), dtype=torch.int32, device=keys.device)
    if n == 0:
        return outs, overflow.zero_()
    _launch(luts[:MAX_LUTS], keys, outs, overflow, n)
    for lo in range(MAX_LUTS, len(luts), MAX_LUTS):
        # every launch checks the same keys: one overflow count is kept
        _launch(luts[lo:lo + MAX_LUTS], keys, outs[lo:], torch.empty_like(
            overflow), n)
    return outs, overflow


def monotone_gather(lut: torch.Tensor, keys: torch.Tensor):
    """out[i] = lut[keys[i]] for non-decreasing int32 keys in
    [0, len(lut)); -> (out int32, overflow int32 0-d)."""
    outs, overflow = monotone_gather_many([lut], keys)
    return outs[0], overflow


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


def gather_bytes(keys: torch.Tensor, n_luts: int) -> int:
    """Bytes the gather must move (the bound's numerator): each key read
    once (4 B), each output written once (4 B a key and lut), and one 32-B
    lut sector per 8 distinct keys and lut (PK luts of TPC-H order keys:
    8 of every 32 slots filled)."""
    n = keys.shape[0]
    distinct = int(torch.unique(keys).numel())
    return 4 * n + 4 * n * n_luts + 32 * n_luts * (distinct >> 3)
