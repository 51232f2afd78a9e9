"""Grouped aggregation keys.

Counterpart of `duckdb_cubit_tpu/ops/groupby.py`.  Two ways to turn GROUP BY
keys into dense group ids:

 - **dense path**: when every key lives in a small known domain (dictionary
   codes, CHAR1 bytes, small int domains), `mixed_radix_codes` combines the
   per-column codes into one code;
 - **sort path** (general GROUP BY): `group_by_sort` sorts rows by the key
   tuple, marks run boundaries and numbers the runs with a prefix sum.

torch has no multi-key sort like `lax.sort(..., num_keys=k)`, so the sort is
a chain of stable sorts (`kernels.lexsort`); ties keep row order, as the
reference's stable sort does.
"""

from __future__ import annotations

import dataclasses

import torch

from . import kernels


@dataclasses.dataclass
class GroupedKeys:
    """Result of generic key grouping."""
    group_ids: torch.Tensor     # (n,) int32 dense ids, invalid rows -> 0
    valid: torch.Tensor         # (n,) bool
    num_groups: torch.Tensor    # 0-d device tensor
    rep_rows: torch.Tensor      # (capacity,) int32 a representative row per group


def mixed_radix_codes(code_arrays: list, sizes: list[int]):
    """Combine small per-column codes into one dense group code."""
    total = 1
    code = None
    for arr, size in zip(code_arrays, sizes):
        c = arr.to(torch.int32)
        code = c if code is None else code * size + c
        total *= size
    return code, total


def group_by_sort(keys: tuple, valid: torch.Tensor,
                  capacity: int) -> GroupedKeys:
    """Dense group ids for an arbitrary int-key tuple via a multi-key sort.

    A leading validity key (not a key-value sentinel) pushes masked rows to
    the end: sentinels collide with monotone-encoded float keys."""
    n = keys[0].shape[0]
    device = valid.device
    lead = (~valid).to(torch.int64)
    skeys = (lead,) + tuple(k.to(torch.int64) for k in keys)
    srows = kernels.lexsort(skeys)
    changed = torch.zeros(n, dtype=torch.bool, device=device)
    changed[0] = True
    for k in skeys:
        sk = k[srows]
        changed[1:] |= sk[1:] != sk[:-1]
    svalid = lead[srows] == 0
    first = changed & svalid
    gid_sorted = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    num_groups = torch.where(
        svalid.any(),
        torch.where(svalid, gid_sorted, torch.full_like(gid_sorted, -1)).max()
        + 1, torch.zeros((), dtype=torch.int32, device=device))
    gid_sorted = torch.where(svalid, gid_sorted, torch.zeros_like(gid_sorted))
    # back to input row order
    gids = torch.zeros(n, dtype=torch.int32, device=device)
    gids[srows] = gid_sorted
    # one row per group; every other row writes the dropped slot `capacity`
    slot = torch.where(first, gid_sorted.to(torch.int64),
                       torch.full_like(srows, capacity))
    rep = torch.full((capacity + 1,), -1, dtype=torch.int32, device=device)
    rep[slot] = srows.to(torch.int32)
    return GroupedKeys(gids, valid, num_groups, rep[:capacity])
