"""Q6 scan-sums with int32 hi/lo partials: kernels K3 and K4.

Counterpart of the two Pallas kernels of `benchmarks/q6bench.py`: the words
form (`q6_kernel` behind `pallas_q6`) and the byte-mask form
(`pallas_m8_kernel` behind `pallas_m8`).  Over rows r in [0, n):

  prod = int32(a[r] * m[r] * b[r])    (wraps modulo 2**32)
  -> (2,) int32 [sum(prod >> 16), sum(prod & 0xFFFF)], each sum modulo 2**32

where m[r] is bit (r & 31) of `words[r >> 5]` for `q6_words_i32` (the
engine's bitvector order, int32 bit patterns) and the int8 `mask[r]`, any
byte, for `q6_mask8_i32`.  That pair is the TPU kernel's `out_ref`; a
caller forms `hi * 65536 + lo` in int64 as the script's driver does.  The
TPU kernels accumulate both halves in int32 across the whole grid, so `lo`
wraps at SF1 (about 3M selected rows of up to 65535 each) and the combined
value is then not the Q6 sum: the port computes the kernels' function,
wraps included, and `benchmarks/q6bench.py` of the port checks it modulo
2**32.

Each wrapper has two bodies, chosen only by the tensors' device: CUDA
tensors launch the hand-written kernel (`csrc/q6_words_i32.cu`,
`csrc/q6_mask8_i32.cu`) or raise; CPU tensors run the plain torch body
(`*_reference`), which computes in int64 and wraps explicitly.  The
kernels load 16 B at a time, so the payloads (and K4's mask) must start on
a 16-B boundary: `words[k:]` with `a[32 k:]`, or `mask[16 k:]` with
`a[16 k:]`, is taken, `a[1:]` is refused with a ValueError on either
device.
"""

from __future__ import annotations

import ctypes

import torch

from . import bitmap as bm
from .cuda_build import CudaKernel, sm_count, stream_scratch

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p]
WORDS_KERNEL = CudaKernel("k3", "q6_words_i32.cu", "q6_words_i32_launch",
                          _ARGTYPES)
MASK8_KERNEL = CudaKernel("k4", "q6_mask8_i32.cu", "q6_mask8_i32_launch",
                          _ARGTYPES)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 values modulo 2**32, as signed int32 values held in int64."""
    return bm.wrap_int32(x).to(torch.int64)


def _hi_lo(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """The plain body shared by both forms: m is the per-row multiplier."""
    prod = _wrap(_wrap(a.to(torch.int64) * m.to(torch.int64))
                 * b.to(torch.int64))
    return bm.wrap_int32(torch.stack([(prod >> 16).sum(),
                                      (prod & 0xFFFF).sum()]))


def _check_payloads(a: torch.Tensor, b: torch.Tensor, n: int, device):
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: int32 expected, got {t.dtype}")
        if t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: a contiguous 1-d tensor expected")
        if t.shape[0] != n:
            raise ValueError(f"{name}: {n} rows expected, got {t.shape[0]}")
        if t.device != device:
            raise ValueError("all tensors must share one device")


def _check_aligned(**tensors):
    """The kernels' 16-B loads: each tensor must start on a 16-B boundary
    (the same check on the CPU, so CPU tests cover it)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must start on a 16-B boundary, starts "
                             f"{t.data_ptr() % 16} B past one")


def _check_words(words, a, b):
    if words.dtype != torch.int32:
        raise TypeError(f"words: int32 bit patterns expected, got "
                        f"{words.dtype}")
    if words.ndim != 1 or not words.is_contiguous():
        raise ValueError("words: a contiguous 1-d tensor expected")
    _check_payloads(a, b, 32 * words.shape[0], words.device)
    _check_aligned(a=a, b=b)


def _check_mask8(mask, a, b):
    if mask.dtype != torch.int8:
        raise TypeError(f"mask: int8 expected, got {mask.dtype}")
    if mask.ndim != 1 or not mask.is_contiguous():
        raise ValueError("mask: a contiguous 1-d tensor expected")
    _check_payloads(a, b, mask.shape[0], mask.device)
    _check_aligned(mask=mask, a=a, b=b)


def q6_words_i32_reference(words, a, b) -> torch.Tensor:
    """Plain torch body of K3: -> (2,) int32 [hi, lo]."""
    return _hi_lo(bm.expand(words, a.shape[0]), a, b)


def q6_mask8_i32_reference(mask, a, b) -> torch.Tensor:
    """Plain torch body of K4: -> (2,) int32 [hi, lo]."""
    return _hi_lo(mask, a, b)


def _device_body(kernel, selector, a, b, n) -> torch.Tensor:
    """Launch `kernel` over n words or rows on the card (the kernel writes
    every byte of the output): -> (2,) int32 [hi, lo]."""
    device = selector.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not n:
        return torch.zeros(2, dtype=torch.int32, device=device)
    out = torch.empty(2, dtype=torch.int32, device=device)
    kernel.launch(device, selector.data_ptr(), a.data_ptr(), b.data_ptr(), n,
                  stream_scratch(device).data_ptr(), out.data_ptr(),
                  sm_count(device))
    return out


def q6_words_i32(words, a, b) -> torch.Tensor:
    """K3: -> (2,) int32 [sum(prod >> 16), sum(prod & 0xFFFF)] modulo 2**32,
    prod = int32(a * bit * b).  words: int32 (n/32,) bit patterns; a, b:
    int32 (n,) with n = 32 * len(words), each starting 16-B aligned."""
    _check_words(words, a, b)
    if words.device.type == "cpu":
        return q6_words_i32_reference(words, a, b)
    return _device_body(WORDS_KERNEL, words, a, b, words.shape[0])


def q6_mask8_i32(mask, a, b) -> torch.Tensor:
    """K4: the same pair with prod = int32(a * int32(mask) * b).  mask:
    int8 (n,), any byte; a, b: int32 (n,); all three 16-B aligned."""
    _check_mask8(mask, a, b)
    if mask.device.type == "cpu":
        return q6_mask8_i32_reference(mask, a, b)
    return _device_body(MASK8_KERNEL, mask, a, b, mask.shape[0])


def combine(hi_lo: torch.Tensor) -> torch.Tensor:
    """The script's driver step: hi * 65536 + lo in int64 (0-d, or one per
    row of a (k, 2) stack)."""
    x = hi_lo.to(torch.int64)
    return x[..., 0] * 65536 + x[..., 1]
