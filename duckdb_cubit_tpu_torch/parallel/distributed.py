"""Distributed query steps: sharded scan / filter / aggregate / join.

Counterpart of `duckdb_cubit_tpu/parallel/distributed.py`.  Base columns and
CUBIT words are row-partitioned across the mesh; filters and bitmap ANDs run
on each rank's block; aggregates compute split (hi, lo) partials per rank
and add them with one `all_reduce`; joins route both sides through the radix
exchange, so each rank owns its hash partitions (deterministic partition
ownership in place of the reference DuckDB's shared CAS hash table).

Each `make_*` returns a plain function that every rank of the mesh calls
with its own blocks; its results are replicated (the same on every rank).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import bitmap as bm
from ..ops import join as join_ops
from .exchange import _pack_buckets, all_to_all
from .mesh import Mesh

_LO32 = 0xFFFFFFFF


def _sum_over_mesh(parts: list, mesh: Mesh) -> torch.Tensor:
    """Stack int64 partials and add them over the mesh in one collective."""
    out = torch.stack([p.to(torch.int64) for p in parts])
    dist.all_reduce(out, group=mesh.group)
    return out


def make_q6_step(mesh: Mesh):
    """Bitmap scan + exact masked sum (the Q6 shape).

    fn(words_a, words_b, words_c, eprice, disc, valid) -> (hi, lo): the
    split sum of `eprice * disc` over the rows whose three predicate bits
    are set, over the whole mesh.  Words are int32 bit patterns, each
    rank's block covering its rows."""

    def fn(words_a, words_b, words_c, eprice, disc, valid):
        words = words_a & words_b & words_c
        mask = bm.expand(words, eprice.shape[0]) & valid
        val = (eprice * disc).to(torch.int64)
        zero = torch.zeros_like(val)
        lo = torch.where(mask, val & _LO32, zero).sum()
        hi = torch.where(mask, val >> 32, zero).sum()
        hi, lo = _sum_over_mesh([hi, lo], mesh)
        return hi, lo

    return fn


def make_grouped_agg_step(mesh: Mesh, num_groups: int):
    """Dense grouped aggregate (the Q1 shape): per-rank `index_add_`
    partials merged by one `all_reduce`, the analog of the reference
    DuckDB's thread-local hash tables merged in finalize
    (radix_partitioned_hashtable.cpp).

    fn(codes, values, valid) -> (hi, lo, count), each (num_groups,)."""

    def fn(codes, values, valid):
        safe = torch.where(valid, codes, torch.zeros_like(codes)).to(
            torch.int64)
        v = values.to(torch.int64)
        v = torch.where(valid, v, torch.zeros_like(v))

        def add(x):
            return torch.zeros(num_groups, dtype=torch.int64,
                               device=x.device).index_add_(0, safe, x)

        hi, lo, cnt = _sum_over_mesh(
            [add(v >> 32), add(v & _LO32), add(valid.to(torch.int64))], mesh)
        return hi, lo, cnt

    return fn


def _exchange_side(keys, vals, valid, mesh: Mesh, quota: int,
                   async_op: bool = False):
    """Pack one join side and start its three exchanges: -> (keys, vals,
    valid, overflow), each exchanged entry a buffer, or with `async_op` a
    (buffer, work, send buffer) triple."""
    k, p, v, overflow = _pack_buckets(keys, [vals], valid, mesh.size, quota)
    return (all_to_all(k, mesh, async_op), all_to_all(p[0], mesh, async_op),
            all_to_all(v, mesh, async_op), overflow)


def _probe_sum(bs, bval, keys, vals, valid) -> torch.Tensor:
    """Sum of probe value * build value over the probe rows that match: the
    first build row of the entry, `bval[sorted_rows[starts[entry]]]`."""
    row, found = join_ops.probe_single(bs, keys, valid)
    joined = bval[row.clamp(min=0).to(torch.int64)]
    prod = vals * joined
    return torch.where(found, prod, torch.zeros_like(prod)).sum()


def make_partitioned_join_step(mesh: Mesh, build_quota: int,
                               probe_quota: int):
    """Hash join: radix-exchange both sides, then a local join per rank on
    `ops/join`'s build and probe.

    fn(bkeys, bvals, bvalid, pkeys, pvals, pvalid) -> (total, overflow):
    the sum of probe value * build value over matches, and the rows that
    did not fit their bucket, both over the mesh."""

    def fn(bkeys, bvals, bvalid, pkeys, pvals, pvalid):
        bk, bval, bvld, bovf = _exchange_side(bkeys, bvals, bvalid, mesh,
                                              build_quota)
        pk, pval, pvld, povf = _exchange_side(pkeys, pvals, pvalid, mesh,
                                              probe_quota)
        bs = join_ops.build(bk, bvld)
        partial = _probe_sum(bs, bval, pk, pval, pvld)
        total, ovf = _sum_over_mesh([partial, bovf + povf], mesh)
        return total, ovf

    return fn


def make_pipelined_join_step(mesh: Mesh, build_quota: int, probe_quota: int,
                             n_chunks: int):
    """Hash join with a double-buffered probe exchange.

    The probe side is split into `n_chunks` equal chunks (its rows must
    divide evenly): chunk i+1's exchanges are issued, asynchronously,
    before chunk i is probed, so the transfer overlaps the probe (the
    analog of the reference DuckDB overlapping scan prefetch with compute,
    row_group.cpp:487-505).  The reference's trailing all-invalid chunk is
    not run: its overflow and partial are 0.  Same result as
    `make_partitioned_join_step`."""

    def fn(bkeys, bvals, bvalid, pkeys, pvals, pvalid):
        bk, bval, bvld, bovf = _exchange_side(bkeys, bvals, bvalid, mesh,
                                              build_quota)
        bs = join_ops.build(bk, bvld)
        chunks = list(zip(pkeys.reshape(n_chunks, -1),
                          pvals.reshape(n_chunks, -1),
                          pvalid.reshape(n_chunks, -1)))

        def issue(i):
            return _exchange_side(*chunks[i], mesh, probe_quota,
                                  async_op=True)

        total = torch.zeros((), dtype=torch.int64, device=bk.device)
        ovf = bovf
        pending = issue(0)
        for i in range(n_chunks):
            *sent, povf = pending
            for _, work, _ in sent:
                work.wait()
            if i + 1 < n_chunks:
                pending = issue(i + 1)  # in flight while chunk i is probed
            pk, pval, pvld = (buf for buf, _, _ in sent)
            total = total + _probe_sum(bs, bval, pk, pval, pvld)
            ovf = ovf + povf
        total, ovf = _sum_over_mesh([total, ovf], mesh)
        return total, ovf

    return fn
