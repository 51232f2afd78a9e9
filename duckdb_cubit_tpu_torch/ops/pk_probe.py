"""Key-to-row probe for unsorted keys: K8.

`pk_probe(lut, base, keys, mask, vluts, dtypes=None) -> (row, found,
values)` probes a key-to-row table whose slot 0 holds key `base`:
for each row i it computes `in = mask[i] and base <= keys[i] < base +
len(lut)`, `row[i] = lut[keys[i] - base]` where `in`, else -1, `found[i] =
row[i] >= 0`, and for each value lut j `values[j][i] = vluts[j][keys[i] -
base]` where `found[i]`, else 0, as `dtypes[j]` (int8, int16 or int32: the
build column's own; int32 where `dtypes` is None).  The lut holds -1 at an
absent slot and at a build row that is not live, so `found` is the join's
match flag.  A key outside the table is not found; nothing is counted or
checked.  The wrapper has two bodies, chosen only by
the tensors' device:

  - CUDA tensors launch the hand-written kernel in `csrc/pk_probe.cu`
    (built by `cuda_build` at first use) over `entries(lut, vluts)`, the
    row and values of a slot side by side, one launch per `MAX_VALS` value
    luts, or raise;
  - CPU tensors run `pk_probe_reference`, the plain torch version, which
    computes the same outputs bit for bit: `DirectPKIndex.probe` and the
    row gather of each build column.

Keys, luts and value luts are contiguous 1-d int32 tensors, the mask a
contiguous bool tensor of the keys' length, and the lut has fewer than
2**31 slots.  A value lut holds values of its dtype, widened.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, sm_count

# values one launch fetches: an entry holds the row and at most 7 values
# (8 int32 words, one 32-B sector)
MAX_VALS = 7
MAX_SLOTS = 2**31 - 1

KERNEL = CudaKernel(
    "k8", "pk_probe.cu", "pk_probe_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
     ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])
# output dtypes of the values, by element size
WIDTHS = {torch.int8: 1, torch.int16: 2, torch.int32: 4}


def _check(lut, keys, mask, vluts, dtypes):
    for name, t in [("keys", keys), ("lut", lut),
                    *[(f"value lut {j}", v) for j, v in enumerate(vluts)]]:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: int32 expected, got {t.dtype}")
        if t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: a contiguous 1-d tensor expected")
        if t.device != keys.device:
            raise ValueError("luts and keys must share one device")
    if mask.dtype != torch.bool or mask.shape != keys.shape or \
            not mask.is_contiguous() or mask.device != keys.device:
        raise ValueError("a contiguous bool mask of the keys' length and "
                         "device expected")
    if not 0 < lut.shape[0] <= MAX_SLOTS:
        raise ValueError(f"a lut of {lut.shape[0]} slots; the kernel takes "
                         f"1 to 2**31 - 1")
    if any(v.shape[0] != lut.shape[0] for v in vluts):
        raise ValueError("value luts differ in length from the lut")
    if len(dtypes) != len(vluts) or any(d not in WIDTHS for d in dtypes):
        raise TypeError(f"one dtype of {list(WIDTHS)} a value lut expected, "
                        f"got {dtypes}")


def live_lut(lut, build_mask):
    """The key-to-row table with every row that `build_mask` marks dead
    taken out (-1): the row lut a join probes, so that `found` is its match
    flag, as `DirectPKIndex.probe` reads the mask at the probed row."""
    return torch.where(build_mask[lut.clamp(min=0)], lut, -1)


def pk_probe_reference(lut, base: int, keys, mask, vluts=(), dtypes=None):
    """Plain torch version: -> (row int32, found bool, [values of each
    lut])."""
    s = keys.to(torch.int64) - base
    hit = mask & (s >= 0) & (s < lut.shape[0])
    s = torch.where(hit, s, 0)
    row = torch.where(hit, lut[s], -1)
    found = row >= 0
    dtypes = dtypes or [torch.int32] * len(vluts)
    values = [torch.where(found, v[s], 0).to(d)
              for v, d in zip(vluts, dtypes)]
    return row, found, values


def entries(lut, vluts) -> torch.Tensor:
    """The kernel's table: (len(lut), W) int32, a slot's row then its
    values (at most MAX_VALS), W the least of 1, 2, 4 and 8 that holds them,
    padded with the row."""
    cols = [lut, *vluts]
    width = next(w for w in (1, 2, 4, 8) if w >= len(cols))
    return torch.stack(cols + [lut] * (width - len(cols)), dim=1)


def _aligned(n: int, shift: int, dtype, device):
    """n elements whose element `shift` starts 4 elements past a 16-B
    boundary."""
    return torch.empty(shift + n + 3, dtype=dtype, device=device)[
        shift:shift + n]


def pk_probe(lut, base: int, keys, mask, vluts=(), dtypes=None):
    """The probe and value fetches of a key-to-row table for any int32 keys;
    -> (row int32, found bool, [values of each lut, as its dtype]); see the
    module's docstring."""
    vluts = list(vluts)
    dtypes = list(dtypes) if dtypes is not None else \
        [torch.int32] * len(vluts)
    _check(lut, keys, mask, vluts, dtypes)
    if keys.device.type == "cpu":
        return pk_probe_reference(lut, base, keys, mask, vluts, dtypes)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    n, dev = keys.shape[0], keys.device
    # every output starts where the keys do modulo 4 elements, so that the
    # kernel's whole quads are aligned in each
    shift = (keys.data_ptr() >> 2) & 3
    found = _aligned(n, shift, torch.bool, dev)
    row = _aligned(n, shift, torch.int32, dev)
    values = [_aligned(n, shift, d, dev) for d in dtypes]
    if n == 0:
        return row, found, values
    for lo in range(0, max(len(vluts), 1), MAX_VALS):
        part = range(lo, min(lo + MAX_VALS, len(vluts)))
        table = entries(lut, [vluts[j] for j in part])
        outs = (ctypes.c_void_p * MAX_VALS)(*[values[j].data_ptr()
                                             for j in part])
        widths = (ctypes.c_int * MAX_VALS)(*[WIDTHS[dtypes[j]]
                                            for j in part])
        # a launch past the first writes the same flags and rows again
        KERNEL.launch(dev, table.data_ptr(), table.shape[1], lut.shape[0],
                      base, len(part), keys.data_ptr(), mask.data_ptr(), n,
                      found.data_ptr(), row.data_ptr(), outs, widths,
                      sm_count(dev))
    return row, found, values


def probe_bytes(keys, mask, widths) -> int:
    """Bytes K8 must move (the bound's numerator): each key (4 B) and mask
    byte read once, each flag (1 B), row (4 B) and value
    (`widths`: bytes of each value) written once, and, as
    `probe.gather_bytes` counts them, one 32-B lut sector per 8 distinct
    probed keys and lut (the row lut and each value lut: the table's
    bytes, however they are laid out)."""
    n = keys.shape[0]
    distinct = int(torch.unique(keys[mask]).numel())
    return (n * (4 + 1 + 1 + 4 + sum(widths))
            + 32 * (1 + len(widths)) * (distinct >> 3))
