"""General equi-join build and probe: sort-based build, sort-merge probe.

Counterpart of `duckdb_cubit_tpu/ops/join.py`.  The reference DuckDB builds
a hash table of chained row pointers with CAS inserts; here, as in the
JAX package, both sides are whole-column passes with no atomics:

 1. **build** sorts the build side by (validity, key): invalid rows sink
    past every valid one without a key sentinel.  Each run of equal keys
    becomes one entry of a CSR: the ascending unique keys, each run's
    `starts` offset and `counts` length into `sorted_rows` (the build row
    ids in key order).  Unused entries hold the key int64 max and count 0.
 2. **probe** is the merge phase of a sort-merge join: the unique build keys
    (tag 0) and the probe keys (tag 1) are sorted together by (key, tag), so
    every build entry precedes its equal probe keys.  Two forward fills
    carry the last valid build entry's key and index to each position (the
    reference's running maxima, as a cumsum rank and a gather), a probe
    slot hits where the carried key equals its own, and a scatter puts each
    probe slot's entry (-1 on a miss) back in probe order.
 3. `probe_single` resolves one build row per hit (unique build keys, the
    PK-FK case); `expand_matches` expands variable match counts into
    (probe row, build row) pairs at a static output capacity with prefix
    sums and forward fills, with LEFT OUTER rows on request; `semi_mask`
    gives SEMI / ANTI masks.

All shapes are static; "not found" is -1 and callers carry validity masks.
`HashJoin`'s general paths (`plan/physical.py`) run on this module.
"""

from __future__ import annotations

import dataclasses

import torch

from ..exec import profiler as PROF
from .kernels import lexsort

_I64_MAX = 2**63 - 1
_I64_MIN = -(2**63)
# probe rows the sort-merge probe took (`probe`)
PROF.declare("sort_probe_rows")


@dataclasses.dataclass
class BuildSide:
    """A finalized build side (the reference's `ht_keys` is `unique_keys`;
    its `size` and `ht_entry` were dead fields and are gone)."""
    unique_keys: torch.Tensor  # (cap,) int64 ascending, int64 max = unused
    starts: torch.Tensor       # (cap,) int32 offset into sorted_rows
    counts: torch.Tensor       # (cap,) int32 run length, 0 = unused
    sorted_rows: torch.Tensor  # (cap,) int32 build row ids grouped by key
    unique_capacity: int


def build(keys: torch.Tensor, valid: torch.Tensor) -> BuildSide:
    """Sort-based build over int keys with a validity mask."""
    n = keys.shape[0]
    dev = keys.device
    lead = (~valid).to(torch.int64)
    k64 = keys.to(torch.int64)
    perm = lexsort((lead, k64))
    svalid = lead[perm] == 0
    sk = k64[perm]
    srows = perm.to(torch.int32)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    first &= svalid
    # dense unique ids in ascending key order; invalid rows go to the last
    # slot, which no valid key reaches when any row is invalid
    uid = torch.cumsum(first.to(torch.int64), 0) - 1
    uid = torch.where(svalid, uid, torch.full_like(uid, n - 1))
    big = torch.full_like(sk, _I64_MAX)
    unique_keys = big.clone()
    unique_keys[uid] = torch.where(svalid, sk, big)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    starts = torch.full((n,), n, dtype=torch.int32, device=dev)
    starts = starts.scatter_reduce(
        0, uid, torch.where(svalid, pos, torch.full_like(pos, n)), "amin")
    counts = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, uid, svalid.to(torch.int32))
    return BuildSide(unique_keys, starts, counts, srows, n)


def probe(bs: BuildSide, probe_keys: torch.Tensor,
          probe_valid: torch.Tensor) -> torch.Tensor:
    """-> int32 unique-entry index per probe row, -1 on a miss."""
    n = probe_keys.shape[0]
    PROF.count("sort_probe_rows", n)
    with PROF.span("db.join.sort_probe") as sp:
        sp.set(rows=n)
        return _probe(bs, probe_keys, probe_valid)


def _probe(bs, probe_keys, probe_valid):
    m, n = bs.unique_keys.shape[0], probe_keys.shape[0]
    dev = probe_keys.device
    keys = torch.cat([bs.unique_keys, probe_keys.to(torch.int64)])
    tag = torch.cat([torch.zeros(m, dtype=torch.int8, device=dev),
                     torch.ones(n, dtype=torch.int8, device=dev)])
    idx = torch.cat([torch.arange(m, dtype=torch.int32, device=dev),
                     torch.arange(n, dtype=torch.int32, device=dev)])
    bval = torch.cat([bs.counts > 0,
                      torch.zeros(n, dtype=torch.bool, device=dev)])
    # build entries come first in `keys`, so a stable sort by key alone is
    # the (key, tag) order: each build entry precedes its equal probe keys
    perm = torch.sort(keys, stable=True).indices
    sk, st, si = keys[perm], tag[perm], idx[perm]
    is_build = (st == 0) & bval[perm]
    # valid build keys (and their entry indices) ascend along the sorted
    # order, so the last valid build entry at or before each position is
    # the reference's running max of them
    bkey_run = _forward_fill(sk, is_build, _I64_MIN)
    bidx_run = _forward_fill(si, is_build, -1)
    hit = (bkey_run == sk) & (st == 1)
    entry_sorted = torch.where(hit, bidx_run, torch.full_like(bidx_run, -1))
    # back to probe order; build slots all land in the spare last slot
    target = torch.where(st == 1, si, torch.full_like(si, n)).to(torch.int64)
    out = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    out[target] = entry_sorted
    out = out[:n]
    return torch.where(probe_valid, out, torch.full_like(out, -1))


def probe_single(bs: BuildSide, probe_keys, probe_valid):
    """PK-FK fast path: -> (build row id per probe row, found mask).
    Valid when build keys are unique (counts == 1)."""
    entry = probe(bs, probe_keys, probe_valid)
    found = entry >= 0
    start = bs.starts[entry.clamp(min=0).to(torch.int64)].to(torch.int64)
    row = bs.sorted_rows[start.clamp(max=bs.sorted_rows.shape[0] - 1)]
    return torch.where(found, row, torch.full_like(row, -1)), found


def _forward_fill(values: torch.Tensor, marked: torch.Tensor,
                  fill: int) -> torch.Tensor:
    """values[j] at the last marked j <= i, for every position i (`fill`
    before the first mark).  Where the marked values do not decrease this is
    the reference's running max (`lax.cummax`); torch runs a 1-D cummax on
    the card as one serial scan (23 ms for 7.5M int64 on an H100), so the
    fill ranks the marks with a cumsum instead and gathers each rank's
    value."""
    rank = torch.cumsum(marked.to(torch.int64), 0)
    at = torch.where(marked, rank, torch.zeros_like(rank))
    by_rank = torch.full((values.shape[0] + 1,), fill, dtype=values.dtype,
                         device=values.device)
    by_rank[at] = torch.where(marked, values, torch.full_like(values, fill))
    return by_rank[rank]


def _scatter_drop(size: int, at: torch.Tensor, values: torch.Tensor,
                  fill: int) -> torch.Tensor:
    """A (size,) int32 tensor of `fill` with values[i] written at at[i];
    indices outside [0, size) are dropped (JAX's mode="drop")."""
    at = torch.where((at >= 0) & (at < size), at, torch.full_like(at, size))
    out = torch.full((size + 1,), fill, dtype=torch.int32, device=at.device)
    out[at.to(torch.int64)] = values.to(torch.int32)
    return out[:size]


def expand_matches(starts, counts, sorted_rows, entry, probe_valid,
                   out_capacity: int, left: bool = False):
    """General join expansion with variable match counts.

    -> (probe_row_idx[out_capacity], build_row_idx[out_capacity], out_count)
    Rows beyond out_count are padding (probe_row_idx == -1).  With
    `left=True` every unmatched valid probe row still emits one output row
    with build_row_idx == -1 (LEFT OUTER; callers turn the -1 into NULL
    build columns)."""
    dev = entry.device
    found = (entry >= 0) & probe_valid
    safe = entry.clamp(min=0).to(torch.int64)
    zero = torch.zeros_like(entry)
    cnt = torch.where(found, counts[safe], zero)
    if left:
        cnt = torch.where(probe_valid & ~found, torch.ones_like(cnt), cnt)
    cnt = cnt.to(torch.int64)
    offs = torch.cumsum(cnt, 0) - cnt  # exclusive prefix
    total = cnt.sum()
    n = entry.shape[0]
    active = cnt > 0
    first_pos = torch.where(active, offs, torch.full_like(offs, out_capacity))
    probe_rows = torch.arange(n, dtype=torch.int32, device=dev)
    raw = _scatter_drop(out_capacity, first_pos,
                        torch.where(active, probe_rows, -1), -1)
    is_start = raw >= 0
    # fill runs forward: each output takes its run's probe row and start
    slots = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    valid_out = slots < total
    out_probe = torch.where(valid_out, _forward_fill(raw, is_start, -1),
                            torch.full_like(raw, -1))
    # each output's offset within its run
    within = (slots - _forward_fill(slots, is_start, 0)).to(torch.int64)
    row_entry = entry[out_probe.clamp(min=0).to(torch.int64)]
    bstart = starts[row_entry.clamp(min=0).to(torch.int64)].to(torch.int64)
    build_ok = valid_out if not left else (valid_out & (row_entry >= 0))
    build = sorted_rows[(bstart + within).clamp(
        max=sorted_rows.shape[0] - 1)]
    out_build = torch.where(build_ok, build, torch.full_like(build, -1))
    return out_probe, out_build, total


def semi_mask(bs: BuildSide, probe_keys, probe_valid, anti: bool = False):
    """SEMI (or ANTI) join mask over the probe rows."""
    found = probe(bs, probe_keys, probe_valid) >= 0
    return (~found if anti else found) & probe_valid
