"""LIKE over a string dictionary's bytes: K6, the dictionary matcher.

`like_table(entries, pattern)` returns the bool truth table of SQL LIKE
over every entry of a dictionary held as an (n, w) uint8 tensor (a sorted
numpy `|S<w>` array viewed as bytes; `dictionary_bytes` makes it).  The
rows of a column then gather the table by their codes.  It has two bodies,
chosen only by the tensor's device:

  - CUDA tensors launch the hand-written kernel in `csrc/dict_like.cu`
    (built by `cuda_build` with nvcc for sm_90a at first use, bound through
    ctypes), or raise;
  - CPU tensors run `like_table_reference`, the plain torch version of the
    same segment algorithm.

Semantics are SQL LIKE on bytes: `%` matches any run of bytes, `_` any one
byte, every other byte (backslash included) itself, as
`expressions.like_to_regex` has it.  The pattern is split at `%` into
segments of fixed length; the first is anchored at the entry's start and
the last at its end unless the pattern starts or ends with `%`, and each
middle segment takes its leftmost match after the one before.  An entry's
length is its last nonzero byte + 1 (numpy strips trailing NULs).

The device copy of a dictionary is made at its first LIKE on a card and
held for as long as the numpy array lives (`dictionary_bytes`): a weak
reference, checked by identity, ties the copy to the array, so a dictionary
that is replaced (an INSERT that merges new strings) is copied anew and the
old copy goes with the old array.  No truth table and no pattern is kept.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from .cuda_build import CudaKernel

KERNEL = CudaKernel(
    "dict_like.cu", "dict_like_launch",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p])

# the kernel's limits on a pattern (`csrc/dict_like.cu`)
MAX_SEGMENTS = 64
MAX_PATTERN_BYTES = 1024
# rows of the plain version's (rows, positions, segment) comparisons at once
REFERENCE_CHUNK = 1 << 16

# launches of the CUDA kernel (never counts the plain body)
launch_count = 0


@dataclasses.dataclass(frozen=True)
class LikePattern:
    """A LIKE pattern split at `%`: each segment's bytes and its `_`
    positions (`wild`, 1 per wildcard byte), and whether the first segment
    starts the entry and the last one ends it.  A pattern without `%` is one
    segment anchored at both ends."""
    segments: tuple[bytes, ...]
    wild: tuple[bytes, ...]
    anchor_start: bool
    anchor_end: bool

    @property
    def flags(self) -> int:
        return int(self.anchor_start) | (int(self.anchor_end) << 1)


def compile_pattern(pattern: str) -> LikePattern:
    """Split `pattern` (encoded as UTF-8, as the regex path matches) into
    its segments."""
    parts = pattern.encode().split(b"%")
    if len(parts) == 1:
        segs, start, end = parts, True, True
    else:
        segs = [p for p in parts if p]
        start, end = parts[0] != b"", parts[-1] != b""
    return LikePattern(
        tuple(s.replace(b"_", b"\0") for s in segs),
        tuple(bytes(int(c == ord("_")) for c in s) for s in segs),
        start, end)


def _as_bytes(dictionary: np.ndarray) -> np.ndarray:
    """A `|S<w>` array as an (n, w) uint8 array over the same bytes."""
    d = np.ascontiguousarray(dictionary)
    if d.dtype.kind != "S":
        raise TypeError(f"a |S dictionary expected, got {d.dtype}")
    view = d.view(np.uint8).reshape(len(d), d.dtype.itemsize)
    return view if view.flags.writeable else view.copy()


# (id(dictionary), device) -> (weak reference to the dictionary, its bytes
# on that device); an entry leaves with its array
_COPIES: dict[tuple[int, torch.device], tuple[weakref.ref, torch.Tensor]] = {}


def _forget(key, ref):
    held = _COPIES.get(key)
    if held is not None and held[0] is ref:
        del _COPIES[key]


def dictionary_bytes(dictionary: np.ndarray, device) -> torch.Tensor:
    """The dictionary's bytes as an (n, w) uint8 tensor on `device`.  On
    the CPU a view of the array; on a card one copy, made at the first call
    for that array and device and held until the array dies."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(_as_bytes(dictionary))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (id(dictionary), device)
    held = _COPIES.get(key)
    if held is not None and held[0]() is dictionary:
        return held[1]
    copy = torch.from_numpy(_as_bytes(dictionary)).to(device)
    ref = weakref.ref(dictionary, lambda r, key=key: _forget(key, r))
    _COPIES[key] = (ref, copy)
    return copy


def _check(entries: torch.Tensor):
    if entries.dtype != torch.uint8:
        raise TypeError(f"uint8 entries expected, got {entries.dtype}")
    if entries.ndim != 2 or not entries.is_contiguous():
        raise ValueError("a contiguous (n, w) tensor of entries expected")


def _segment_hits(rows: torch.Tensor, seg: bytes,
                  wild: bytes) -> torch.Tensor:
    """(m, w - L + 1) bool: where segment `seg` (length L >= 1) matches
    each row; (m, 0) when it is wider than the rows."""
    m, w = rows.shape
    if len(seg) > w:
        return torch.zeros((m, 0), dtype=torch.bool, device=rows.device)
    lit = torch.tensor(list(seg), dtype=torch.uint8, device=rows.device)
    any_byte = torch.tensor(list(wild), dtype=torch.bool, device=rows.device)
    windows = rows.unfold(1, len(seg), 1)
    return ((windows == lit) | any_byte).all(-1)


def _at(hits: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """hits[i, pos[i]], False where pos lies outside the hits' columns."""
    if hits.shape[1] == 0:
        return torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    inside = (pos >= 0) & (pos < hits.shape[1])
    got = hits.gather(1, pos.clamp(0, hits.shape[1] - 1)[:, None])[:, 0]
    return got & inside


def _match_rows(rows: torch.Tensor, pat: LikePattern) -> torch.Tensor:
    m, w = rows.shape
    dev = rows.device
    length = ((rows != 0) * torch.arange(1, w + 1, device=dev)).amax(1) \
        if w else torch.zeros(m, dtype=torch.int64, device=dev)
    segs, wild = pat.segments, pat.wild
    if pat.anchor_start and pat.anchor_end and len(segs) == 1:
        if not segs[0]:
            return length == 0
        return (length == len(segs[0])) & _at(
            _segment_hits(rows, segs[0], wild[0]), torch.zeros_like(length))
    ok = torch.ones(m, dtype=torch.bool, device=dev)
    lo, hi = torch.zeros_like(length), length
    first, last = 0, len(segs)
    if pat.anchor_start:
        size = len(segs[0])
        ok &= (hi >= size) & _at(_segment_hits(rows, segs[0], wild[0]), lo)
        lo = torch.full_like(length, size)
        first = 1
    if pat.anchor_end:
        size = len(segs[-1])
        pos = hi - size
        ok &= (pos >= lo) & _at(_segment_hits(rows, segs[-1], wild[-1]), pos)
        hi = pos
        last -= 1
    for seg, wc in zip(segs[first:last], wild[first:last]):
        size = len(seg)
        hits = _segment_hits(rows, seg, wc)
        if hits.shape[1] == 0:
            return torch.zeros(m, dtype=torch.bool, device=dev)
        at = torch.arange(hits.shape[1], device=dev)
        inside = hits & (at >= lo[:, None]) & (at + size <= hi[:, None])
        found = inside.any(1)
        ok &= found
        lo = torch.where(found, inside.to(torch.uint8).argmax(1) + size, lo)
    return ok


def like_table_reference(entries: torch.Tensor,
                         pat: LikePattern) -> torch.Tensor:
    """Plain torch version: per segment, `unfold` windows of the (n, w)
    bytes compared with the segment, then the anchors and the leftmost
    match of each middle segment; rows in chunks of `REFERENCE_CHUNK`.
    The wrapper runs it for CPU tensors; it runs on any device."""
    n = entries.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=entries.device)
    for lo in range(0, n, REFERENCE_CHUNK):
        out[lo:lo + REFERENCE_CHUNK] = _match_rows(
            entries[lo:lo + REFERENCE_CHUNK], pat)
    return out


def _launch_args(pat: LikePattern) -> tuple:
    """The pattern as the launcher takes it: segment bytes, wildcard flags
    and int32 lengths, in host buffers."""
    total = sum(len(s) for s in pat.segments)
    if len(pat.segments) > MAX_SEGMENTS or total > MAX_PATTERN_BYTES:
        raise ValueError(
            f"LIKE pattern of {len(pat.segments)} segments and {total} bytes "
            f"exceeds the kernel's {MAX_SEGMENTS} segments and "
            f"{MAX_PATTERN_BYTES} bytes")
    seg_bytes = np.frombuffer(b"".join(pat.segments) or b"\0", np.uint8)
    seg_wild = np.frombuffer(b"".join(pat.wild) or b"\0", np.uint8)
    seg_len = np.array([len(s) for s in pat.segments] or [0], np.int32)
    return seg_bytes, seg_wild, seg_len


def like_table(entries: torch.Tensor, pattern: str) -> torch.Tensor:
    """-> (n,) bool: entry i of `entries` ((n, w) uint8) matches `pattern`
    under SQL LIKE."""
    global launch_count
    _check(entries)
    pat = compile_pattern(pattern)
    if entries.device.type == "cpu":
        return like_table_reference(entries, pat)
    if entries.device.type != "cuda":
        raise ValueError(f"unsupported device {entries.device}")
    n, w = entries.shape
    out = torch.empty(n, dtype=torch.bool, device=entries.device)
    if n == 0:
        return out
    seg_bytes, seg_wild, seg_len = _launch_args(pat)
    KERNEL.launch(entries.device, entries.data_ptr(), n, w,
                  seg_bytes.ctypes.data, seg_wild.ctypes.data,
                  seg_len.ctypes.data, len(pat.segments), pat.flags,
                  out.data_ptr())
    launch_count += 1
    return out


def like_bytes(n: int, w: int) -> int:
    """Bytes K6 must move over n entries of w bytes (the bound's
    numerator): each entry read once, one truth byte written."""
    return n * w + n
