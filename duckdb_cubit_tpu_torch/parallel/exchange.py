"""Distributed radix exchange: rows routed to the rank that owns their key.

Counterpart of `duckdb_cubit_tpu/parallel/exchange.py` (the analog of the
reference DuckDB's radix partitioning, `radix_partitioning.cpp`, and of the
join hash table's repartitioning, `join_hashtable.cpp:1370`): each rank packs
its rows into per-destination buckets of a fixed quota and one
`all_to_all_single` per column sends bucket d to rank d.  The returned
overflow count lets the host detect skew and run again with a larger quota.

Rank d's output is source-major, as the reference's: the bucket from rank 0,
then the one from rank 1, and so on, `size * quota` rows in all.  The
reference's jit caches (`_hist_fn`, `_MESHES`, `_EXCHANGE_CACHE`,
`_cached_exchange`) have no counterpart: nothing here is compiled.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.kernels import hash64
from .mesh import Mesh

_KEY_FILL = -(2**62)


def partition_ids(keys: torch.Tensor, n_dest: int) -> torch.Tensor:
    """Destination rank of each row: the reference's `uint64 hash64 % n`.
    `hash64` gives the uint64 bits as int64 and torch's `%` is a floor
    modulo of the signed value, so a negative pattern (u - 2**64) takes
    2**64 mod n back."""
    h = hash64(keys)
    r = h % n_dest
    r = torch.where(h < 0, (r + (1 << 64) % n_dest) % n_dest, r)
    return r.to(torch.int32)


def _pack_buckets(keys, payload_cols, valid, n_dest: int, quota: int):
    """Arrange local rows into (n_dest, quota) padded buckets:
    -> (keys, [payload], valid, overflow) with overflow a 0-d int64."""
    dest = partition_ids(keys, n_dest)
    dest = torch.where(valid, dest, torch.full_like(dest, n_dest))
    # slot within the destination bucket: the row's place in its run of the
    # stable sort by destination
    n = keys.shape[0]
    order = torch.sort(dest, stable=True).indices
    sorted_dest = dest[order]
    pos_in_run = (torch.arange(n, device=keys.device)
                  - torch.searchsorted(sorted_dest, sorted_dest, side="left"))
    slot = torch.empty(n, dtype=torch.int64, device=keys.device)
    slot[order] = pos_in_run
    overflow = ((slot >= quota) & valid).sum()
    ok = valid & (slot < quota)
    # rows that do not fit (and invalid rows) all go to one spare slot past
    # the buckets, which is dropped: the only index written more than once
    flat = torch.where(ok, dest * quota + slot,
                       torch.full_like(slot, n_dest * quota))

    def scatter(col, fill):
        buf = torch.full((n_dest * quota + 1,), fill, dtype=col.dtype,
                         device=col.device)
        buf[flat] = torch.where(ok, col, torch.full_like(col, fill))
        return buf[:-1].reshape(n_dest, quota)

    out_keys = scatter(keys, _KEY_FILL)
    out_payload = [scatter(c, 0) for c in payload_cols]
    out_valid = scatter(ok, False)
    return out_keys, out_payload, out_valid, overflow


def default_quota(rows_per_shard: int, n_dest: int, slack: float = 2.0) -> int:
    """Starting per-destination quota: slack * mean bucket fill, padded.

    The analog of the reference's initial radix-bit choice
    (join_hashtable.hpp:316 INITIAL_RADIX_BITS): sized for roughly uniform
    keys, grown by exchange_with_requota when the data is skewed.  The
    8-row rounding (not 128) keeps small-quota exchanges from inflating
    traffic quadratically with the rank count.
    """
    mean = max(1, -(-rows_per_shard // max(n_dest, 1)))
    q = int(mean * slack)
    return -(-q // 8) * 8


def histogram_quota(mesh: Mesh, keys, valid, n_dest: int,
                    headroom: float = 1.0) -> int:
    """Exact per-destination quota from a histogram: the largest bucket over
    every (rank, destination) pair, by one MAX all-reduce and one scalar
    read (the host's only sync), so exchange traffic is sized by the data
    rather than by a slack * mean guess (the analog of the reference sizing
    repartitions from measured partition sizes, join_hashtable.cpp:1370)."""
    dest = partition_ids(keys, n_dest)
    dest = torch.where(valid, dest, torch.full_like(dest, n_dest))
    hist = torch.bincount(dest, minlength=n_dest + 1)[:n_dest]
    mx = hist.max()
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.group)
    q = max(8, int(int(mx) * headroom))
    return -(-q // 8) * 8


# element types both gloo and NCCL reduce and move natively; any other
# (bool, int16) travels as its bytes
_WIRE_TYPES = (torch.int8, torch.uint8, torch.int32, torch.int64,
               torch.float32, torch.float64)


def wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous 1-D tensor as the collectives can move it: itself, or
    its bytes (rows stay whole per rank, as each row is a fixed number of
    bytes)."""
    x = x.contiguous()
    return x if x.dtype in _WIRE_TYPES else x.view(torch.uint8)


def unwire(buf: torch.Tensor, dtype) -> torch.Tensor:
    return buf if buf.dtype == dtype else buf.view(dtype)


def all_to_all(buckets: torch.Tensor, mesh: Mesh, async_op: bool = False):
    """Send row d of `buckets` to rank d and receive one row from each rank,
    as one flat buffer (source-major).  A bool or int16 tensor travels as
    its bytes.  -> the buffer, or (buffer, work, send buffer) with
    `async_op`: the send buffer must stay alive until `work.wait()`."""
    send = wire(buckets.reshape(-1))
    out = torch.empty_like(send)
    work = dist.all_to_all_single(out, send, group=mesh.group,
                                  async_op=async_op)
    out = unwire(out, buckets.dtype)
    return (out, work, send) if async_op else out


def exchange_with_requota(mesh: Mesh, keys, valid, payloads, *, quota=None,
                          slack: float = 2.0, max_rounds: int = 6):
    """Skew-aware radix exchange: double the quota until nothing overflows.

    The host reads one overflow scalar per round and runs the whole
    exchange again with a doubled per-destination quota, the analog of the
    reference detecting an over-full hash table and repartitioning with
    more radix bits (join_hashtable.cpp:1370-1400).  Geometric growth bounds
    the total work at under twice the final round.  `keys` is this rank's
    block, so the default quota is sized by its rows.

    Returns (keys', valid', payloads', quota_used, rounds).
    """
    if quota is None:
        quota = default_quota(keys.shape[0], mesh.size, slack)
    for rounds in range(1, max_rounds + 1):
        fn = make_radix_exchange(mesh, quota, len(payloads))
        out = fn(keys, valid, *payloads)
        k2, v2, overflow = out[0], out[1], out[2]
        if int(overflow) == 0:
            return k2, v2, list(out[3:]), quota, rounds
        quota *= 2
    raise RuntimeError(
        f"radix exchange still overflowing after {max_rounds} requota rounds "
        f"(final quota {quota}); key distribution is pathological")


def make_radix_exchange(mesh: Mesh, quota: int, n_payload: int):
    """-> fn(keys, valid, *payload) -> (keys', valid', overflow,
    *payload'): this rank's block of the rows whose key it owns
    (`size * quota` slots, source-major) and the overflow summed over the
    mesh (a 0-d int64, the same on every rank)."""

    def fn(keys, valid, *payload):
        if len(payload) != n_payload:
            raise ValueError(f"{len(payload)} payload columns, expected "
                             f"{n_payload}")
        k, p, v, overflow = _pack_buckets(keys, list(payload), valid,
                                          mesh.size, quota)
        k = all_to_all(k, mesh)
        p = [all_to_all(c, mesh) for c in p]
        v = all_to_all(v, mesh)
        dist.all_reduce(overflow, group=mesh.group)
        return (k, v, overflow, *p)

    return fn
