"""Window function primitives.

Counterpart of `duckdb_cubit_tpu/ops/window.py`: ONE multi-key sort by
(validity, partition keys, order keys) shared by every function over the
same window, then every frame primitive is a segmented prefix operation over
the sorted runs, finally scattered back to input row order.  Running frames
are global cumsums minus the value just before the segment start; the
default RANGE frame (current row and its peers) is the rows prefix read at
the row's LAST PEER position.

Sliding frames (ROWS / RANGE BETWEEN m PRECEDING AND n FOLLOWING) are
prefix-sum differences at the frame bounds for sum / count / avg, and a
log-doubling sparse table for min / max (two overlapping power-of-two
windows cover any [a, b] because min and max are idempotent); RANGE bounds
come from a vectorized binary search inside the segment over the sorted
order key.  A frame is a legacy string ("rows_upto" | "range_upto" |
"partition") or a tuple (mode, lo, hi) with mode in {"rows", "range"} and
lo / hi int offsets (None = UNBOUNDED): ("rows", -2, 3) is ROWS BETWEEN 2
PRECEDING AND 3 FOLLOWING.

Where the reference takes running maxima and minima of positions
(`lax.cummax` / `lax.cummin`), the port fills forward or backward by rank
and gather (`ops/join._forward_fill`, `_backward_fill` here): the positions
increase, so the fill equals the running max / min bit for bit, and a 1-D
`torch.cummax` runs as one serial scan on the card.  Every index the
reference leaves to JAX's clamping gather is clamped here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .join import _forward_fill
from .kernels import lexsort, monotone_i64


def _backward_fill(values: torch.Tensor, marked: torch.Tensor,
                   fill: int) -> torch.Tensor:
    """values[j] at the first marked j >= i, for every position i (`fill`
    after the last mark): the reversed running min of increasing positions,
    by rank and gather."""
    n = values.shape[0]
    m = marked.to(torch.int64)
    before = torch.cumsum(m, 0) - m          # marks strictly before i
    at = torch.where(marked, before, torch.full_like(before, n))
    by_rank = torch.full((n + 1,), fill, dtype=values.dtype,
                         device=values.device)
    by_rank[at] = torch.where(marked, values, torch.full_like(values, fill))
    return by_rank[before]


def _sort_by(partition_keys, order_keys, valid):
    """Sort rows by (validity, partition keys, order keys), stable.

    A leading validity key pushes masked rows to the end without a key-value
    sentinel (a sentinel would collide with monotone-encoded float keys).
    -> (sorted partition keys, sorted order keys, perm)."""
    lead = (~valid).to(torch.int64)
    keys = tuple(monotone_i64(k) for k in (*partition_keys, *order_keys))
    perm = lexsort((lead,) + keys)
    sorted_keys = [k[perm] for k in keys]
    np_ = len(partition_keys)
    return sorted_keys[:np_], sorted_keys[np_:], perm


def _change_flags(sorted_keys, n: int, device) -> torch.Tensor:
    """True at positions whose key tuple differs from the previous row."""
    change = torch.zeros(n, dtype=torch.bool, device=device)
    change[0] = True
    for k in sorted_keys:
        change[1:] |= k[1:] != k[:-1]
    return change


@dataclasses.dataclass
class WindowCtx:
    """Shared per-(partition, order) sort analysis.

    perm      : input row index at each sorted position
    starts    : partition-start flags (sorted order)
    change    : peer-group-start flags (partition OR order key changed)
    seg_start : position of this row's partition start
    seg_end   : position of this row's partition end (inclusive)
    last_peer : position of the last row of this row's peer group
    seg_id    : dense partition id per sorted position
    """
    n: int
    perm: torch.Tensor
    starts: torch.Tensor
    change: torch.Tensor
    seg_start: torch.Tensor
    seg_end: torch.Tensor
    last_peer: torch.Tensor
    seg_id: torch.Tensor
    valid_sorted: torch.Tensor

    def scatter_back(self, values_sorted: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(values_sorted)
        out[self.perm] = values_sorted
        return out

    def take(self, column_array: torch.Tensor) -> torch.Tensor:
        return column_array[self.perm]


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def analyze(partition_keys, order_keys, valid) -> WindowCtx:
    """Sort + boundary analysis shared by all functions of one window."""
    n = valid.shape[0]
    dev = valid.device
    spart, sorder, perm = _sort_by(partition_keys, order_keys, valid)
    valid_sorted = valid[perm]
    # the invalid tail forms its own partition even when its partition-key
    # values continue the last valid partition (masked rows must never
    # extend a live partition's seg_end / last_peer)
    vchange = torch.zeros(n, dtype=torch.bool, device=dev)
    vchange[1:] = valid_sorted[1:] != valid_sorted[:-1]
    if partition_keys:
        starts = _change_flags(spart, n, dev) | vchange
    else:
        starts = vchange.clone()
        starts[0] = True
    # no ORDER BY: all partition rows are peers
    change = (starts | _change_flags(sorder, n, dev)) if sorder else starts
    pos = _positions(n, dev)
    seg_start = _forward_fill(pos, starts, 0)

    # last position of a run: the next run start minus one
    def last_of_run(flags):
        boundary = torch.ones(n, dtype=torch.bool, device=dev)
        boundary[:-1] = flags[1:]
        return _backward_fill(pos, boundary, n)

    seg_end = last_of_run(starts)
    last_peer = last_of_run(change)
    seg_id = torch.cumsum(starts.to(torch.int64), 0) - 1
    return WindowCtx(n, perm, starts, change, seg_start, seg_end,
                     last_peer, seg_id, valid_sorted)


def _seg_running_sum(ctx: WindowCtx, values: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive running sum: the global cumsum minus its value
    just before the segment start."""
    c = torch.cumsum(values, 0)
    base = c[torch.clamp(ctx.seg_start - 1, min=0)]
    return c - torch.where(ctx.seg_start > 0, base, torch.zeros_like(base))


def _seg_running_idem(ctx: WindowCtx, values, op, ident):
    """Segmented inclusive scan for idempotent ops (min / max): Hillis-Steele
    doubling with a segment-boundary guard, log2(n) elementwise passes."""
    n = values.shape[0]
    pos = _positions(n, values.device)
    v = values
    shift = 1
    while shift < n:
        prev = torch.cat([torch.full((shift,), ident, dtype=v.dtype,
                                     device=v.device), v[:-shift]])
        ok = (pos - shift) >= ctx.seg_start
        v = op(v, torch.where(ok, prev, torch.full_like(prev, ident)))
        shift <<= 1
    return v


# ------------------------------------------------------- sliding frames
def _seg_lower_bound(sorted_keys, lo_idx, hi_idx, targets):
    """Vectorized lower_bound: first position p in [lo_idx, hi_idx) with
    sorted_keys[p] >= targets (per element); hi_idx when there is none."""
    n = sorted_keys.shape[0]
    lo = lo_idx.to(torch.int64)
    hi = hi_idx.to(torch.int64)
    steps = max(1, int(np.ceil(np.log2(max(2, n)))) + 1)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = sorted_keys[torch.clamp(mid, 0, n - 1)]
        go_right = active & (v < targets)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def frame_bounds(ctx: WindowCtx, frame, order_enc=None):
    """-> (a, b) inclusive sorted-position bounds per row, or None for
    legacy string frames.  order_enc: the monotone-encoded single order key
    in SORTED order (required for ("range", lo, hi) frames)."""
    if not isinstance(frame, tuple):
        return None
    mode, flo, fhi = frame
    pos = _positions(ctx.n, ctx.perm.device)
    if mode == "rows":
        a = ctx.seg_start if flo is None else torch.maximum(
            pos + int(flo), ctx.seg_start)
        b = ctx.seg_end if fhi is None else torch.minimum(
            pos + int(fhi), ctx.seg_end)
        return a, b
    if mode == "range":
        assert order_enc is not None, "RANGE frame needs one ORDER BY key"
        k = order_enc
        if flo is None:
            a = ctx.seg_start
        else:
            a = _seg_lower_bound(k, ctx.seg_start, ctx.seg_end + 1,
                                 k + int(flo))
        if fhi is None:
            b = ctx.seg_end
        else:
            # last position with key <= k + hi == lower_bound(k + hi + 1) - 1
            b = _seg_lower_bound(k, ctx.seg_start, ctx.seg_end + 1,
                                 k + int(fhi) + 1) - 1
        return a, b
    raise ValueError(mode)


def _prefix_at(running: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The running inclusive prefix value at position idx, 0 before the
    start (idx past the end only occurs in an empty frame, whose value the
    caller masks)."""
    got = running[torch.clamp(idx, 0, running.shape[0] - 1)]
    return torch.where(idx >= 0, got, torch.zeros_like(got))


def _sliding_sum(ctx: WindowCtx, values, a, b):
    c = torch.cumsum(values, 0)
    d = _prefix_at(c, b) - _prefix_at(c, a - 1)
    return torch.where(b >= a, d, torch.zeros_like(d))


def _floor_log2(length: torch.Tensor, levels: int) -> torch.Tensor:
    """floor(log2(length)) for 1 <= length < 2**levels, exact on int64 (the
    reference's 63 - clz(length)): one compare a level."""
    k = torch.zeros_like(length)
    for j in range(1, levels):
        k += (length >= (1 << j)).to(torch.int64)
    return k


def _sliding_idem(values, a, b, op, ident):
    """min / max over [a, b] via a log-doubling sparse table: two
    overlapping power-of-two windows.  The (levels, n) table is built in
    place and freed on return."""
    n = values.shape[0]
    levels = 1
    while (1 << (levels - 1)) < n:
        levels += 1
    table = torch.empty((levels, n), dtype=values.dtype, device=values.device)
    table[0] = values
    span = 1
    for lv in range(1, levels):
        prev = table[lv - 1]
        nxt = table[lv]
        nxt.fill_(ident)
        nxt[: n - span] = prev[span:]
        op(prev, nxt, out=nxt)
        span <<= 1
    length = torch.clamp(b - a + 1, min=1)
    k = _floor_log2(length, levels)
    pw = torch.ones_like(k) << k
    flat = table.reshape(-1)
    left = flat[k * n + torch.clamp(a, 0, n - 1)]
    right = flat[k * n + torch.clamp(b - pw + 1, 0, n - 1)]
    out = op(left, right)
    del table, flat
    return torch.where(b >= a, out, torch.full_like(out, ident))


# --------------------------------------------------------------- rankings
def _ctx_of(ctx_or_parts, order_keys, valid) -> WindowCtx:
    if isinstance(ctx_or_parts, WindowCtx):
        return ctx_or_parts
    return analyze(tuple(ctx_or_parts), tuple(order_keys), valid)


def row_number(ctx_or_parts, order_keys=None, valid=None):
    ctx = _ctx_of(ctx_or_parts, order_keys, valid)
    pos = _positions(ctx.n, ctx.perm.device)
    return ctx.scatter_back(pos - ctx.seg_start + 1)


def rank(ctx_or_parts, order_keys=None, valid=None):
    ctx = _ctx_of(ctx_or_parts, order_keys, valid)
    pos = _positions(ctx.n, ctx.perm.device)
    first_peer = _forward_fill(pos, ctx.change, 0)
    return ctx.scatter_back(first_peer - ctx.seg_start + 1)


def dense_rank(ctx_or_parts, order_keys=None, valid=None):
    ctx = _ctx_of(ctx_or_parts, order_keys, valid)
    c = torch.cumsum(ctx.change.to(torch.int64), 0)
    return ctx.scatter_back(c - c[ctx.seg_start] + 1)


# ----------------------------------------------------------- value movers
def _valid_sorted(ctx: WindowCtx, valid):
    return ctx.valid_sorted if valid is None else \
        (ctx.valid_sorted & ctx.take(valid))


def shift(ctx: WindowCtx, values, valid, offset: int, default=None):
    """LEAD (offset > 0) / LAG (offset < 0): the value `offset` rows away
    within the partition, NULL (or `default`) outside.  -> (array, valid)."""
    pos = _positions(ctx.n, ctx.perm.device)
    v_sorted = ctx.take(values)
    val_sorted = _valid_sorted(ctx, valid)
    idx = torch.clamp(pos + offset, 0, ctx.n - 1)
    in_part = (pos + offset >= ctx.seg_start) & (pos + offset <= ctx.seg_end)
    out = v_sorted[idx]
    ok = in_part & val_sorted[idx]
    if default is not None:
        out = torch.where(ok, out, torch.full_like(out, default))
        ok = ok | ~in_part  # the default fills outside-partition slots
        return ctx.scatter_back(out), ctx.scatter_back(ok)
    out = torch.where(ok, out, torch.zeros_like(out))
    return ctx.scatter_back(out), ctx.scatter_back(ok)


def first_value(ctx: WindowCtx, values):
    return ctx.scatter_back(ctx.take(values)[ctx.seg_start])


def last_value(ctx: WindowCtx, values, whole_partition: bool = False,
               frame: str | None = None):
    """last_value over the frame: 'range_upto' (the default RANGE frame: the
    row's last PEER), 'partition' (the partition's final value), or
    'rows_upto' (an explicit ROWS ... CURRENT ROW frame: the current row
    itself, not the last peer)."""
    if frame is None:
        frame = "partition" if whole_partition else "range_upto"
    v_sorted = ctx.take(values)
    if frame == "rows_upto":
        at = _positions(ctx.n, ctx.perm.device)
    elif frame == "partition":
        at = ctx.seg_end
    else:
        at = ctx.last_peer
    return ctx.scatter_back(v_sorted[at])


# ------------------------------------------------------ running aggregates
def _frame_gather(ctx: WindowCtx, running, frame: str):
    """Map a rows-inclusive running scan to the requested frame."""
    if frame == "rows_upto":
        return running
    if frame == "range_upto":            # the default frame: include peers
        return running[ctx.last_peer]
    if frame == "partition":
        return running[ctx.seg_end]
    raise ValueError(frame)


def _idem(kind: str, dtype):
    """(op, identity) of MIN / MAX over `dtype`."""
    if dtype.is_floating_point:
        ident = float("inf") if kind == "min" else float("-inf")
    else:
        info = torch.iinfo(dtype)
        ident = info.max if kind == "min" else info.min
    return (torch.minimum if kind == "min" else torch.maximum), ident


def agg(ctx: WindowCtx, kind: str, values, valid, frame="range_upto",
        order_enc=None):
    """SUM / COUNT / AVG / MIN / MAX over the frame.  Exact int64
    accumulation for sums (decimal-safe).  -> (array, out_valid) in input
    row order.  `frame` is a legacy string or a sliding (mode, lo, hi)
    tuple (see frame_bounds)."""
    ab = frame_bounds(ctx, frame, order_enc)
    if ab is not None:
        return _agg_sliding(ctx, kind, values, valid, ab)
    if values is None:                    # count(*)
        cnt = _seg_running_sum(ctx, ctx.valid_sorted.to(torch.int64))
        return ctx.scatter_back(_frame_gather(ctx, cnt, frame)), None
    v_sorted = ctx.take(values)
    ok = _valid_sorted(ctx, valid)
    nonnull = _seg_running_sum(ctx, ok.to(torch.int64))
    nn = _frame_gather(ctx, nonnull, frame)
    if kind == "count":
        return ctx.scatter_back(nn), None
    if kind in ("sum", "avg", "sum_double"):
        s = _seg_running_sum(ctx, torch.where(ok, v_sorted,
                                              torch.zeros_like(v_sorted)))
        total = _frame_gather(ctx, s, frame)
        if kind == "avg":
            out = total.to(torch.float64) / torch.clamp(nn, min=1)
            return ctx.scatter_back(out), ctx.scatter_back(nn > 0)
        return ctx.scatter_back(total), ctx.scatter_back(nn > 0)
    if kind in ("min", "max"):
        op, ident = _idem(kind, v_sorted.dtype)
        m = _seg_running_idem(ctx, torch.where(
            ok, v_sorted, torch.full_like(v_sorted, ident)), op, ident)
        out = _frame_gather(ctx, m, frame)
        return ctx.scatter_back(out), ctx.scatter_back(nn > 0)
    raise ValueError(kind)


def _agg_sliding(ctx: WindowCtx, kind: str, values, valid, ab):
    a, b = ab
    if values is None:                    # count(*): the frame's row count
        cnt = _sliding_sum(ctx, ctx.valid_sorted.to(torch.int64), a, b)
        return ctx.scatter_back(cnt), None
    v_sorted = ctx.take(values)
    ok = _valid_sorted(ctx, valid)
    nn = _sliding_sum(ctx, ok.to(torch.int64), a, b)
    if kind == "count":
        return ctx.scatter_back(nn), None
    if kind in ("sum", "avg", "sum_double"):
        s = _sliding_sum(ctx, torch.where(ok, v_sorted,
                                          torch.zeros_like(v_sorted)), a, b)
        if kind == "avg":
            out = s.to(torch.float64) / torch.clamp(nn, min=1)
            return ctx.scatter_back(out), ctx.scatter_back(nn > 0)
        return ctx.scatter_back(s), ctx.scatter_back(nn > 0)
    if kind in ("min", "max"):
        op, ident = _idem(kind, v_sorted.dtype)
        m = _sliding_idem(torch.where(ok, v_sorted,
                                      torch.full_like(v_sorted, ident)),
                          a, b, op, ident)
        return ctx.scatter_back(m), ctx.scatter_back(nn > 0)
    raise ValueError(kind)


def first_last_sliding(ctx: WindowCtx, values, valid, ab, last: bool):
    """first_value / last_value over a sliding frame: the value at the
    frame's first / last position (NULLs included, as in the reference)."""
    a, b = ab
    at = torch.clamp(b if last else a, 0, ctx.n - 1)
    out = ctx.take(values)[at]
    ok = _valid_sorted(ctx, valid)[at] & (b >= a)
    return ctx.scatter_back(out), ctx.scatter_back(ok)


# ----------------------------------------------------- legacy entry points
def _legacy(partition_keys, order_keys, valid):
    return analyze(tuple(partition_keys), tuple(order_keys), valid)


def running_sum(partition_keys, order_keys, values, valid):
    """SUM(v) OVER (PARTITION BY ... ORDER BY ... ROWS UNBOUNDED
    PRECEDING)."""
    ctx = _legacy(partition_keys, order_keys, valid)
    out, _ = agg(ctx, "sum", values.to(torch.int64), None, frame="rows_upto")
    return out


def partition_total(partition_keys, values, valid):
    """SUM(v) OVER (PARTITION BY ...): the whole-partition frame."""
    ctx = _legacy(partition_keys, (), valid)
    out, _ = agg(ctx, "sum", values.to(torch.int64), None, frame="partition")
    return out
