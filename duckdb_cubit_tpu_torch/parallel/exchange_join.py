"""Explicit radix-exchange hash join: the engine's distributed join lowering.

Counterpart of `duckdb_cubit_tpu/parallel/exchange_join.py` (the analog of
the reference DuckDB's radix-partitioned hash join, HashJoinRepartitionTask
in physical_hash_join.cpp and the repartitioning of join_hashtable.cpp):
instead of one shared hash table, each rank OWNS the hash partitions
`hash(key) % n == rank` of both sides.  One `all_to_all_single` per column
of each side routes rows to their owners (`exchange._pack_buckets`), the
local join is `ops/join`'s sort-merge build and probe, and the joined output
stays a row block on each rank.  The build side is never replicated: a rank
holds `n * quota` build rows, not the whole side as a broadcast join does.
A replicated side joins through its blocks (`shard.block_of`).

Two forms.  A single-match join (unique build keys) keeps its probe side's
rows where they are: each probe row's key and row number go to the owner,
which finds the build row and sends its columns back to the row's source
rank, so the output stays aligned to the probe side, as the broadcast path's
is (`static_base_table` may rely on it).  Duplicate build keys fail the
`unique` check, and the retry takes the expanding form, the reference's:
each owner expands its matches into a capacity of its own, and the output
is the owners' blocks.

Capacities are host-chosen.  The per-destination quotas start at slack times
a block's mean bucket (`exchange.default_quota`), the reference's starting
quota wherever its staged plans run (its keys are traced there, so its
histogram branch does not run).  Bucket overflow and expansion overflow are
deferred checks (`exq`, `expansion`), which the executor reduces over the
mesh; it doubles both quotas, or the output capacity, and runs the stage
again: the skew-aware requota of SetRepartitionRadixBits, inside the
engine's recovery machinery.
"""

from __future__ import annotations

import torch

from ..ops import join as join_ops
from .exchange import _pack_buckets, all_to_all, default_quota


def _global_capacity(rel, mesh) -> int:
    return rel.capacity * mesh.size if rel.sharded else rel.capacity


def eligible(op, ctx, probe_rel, build_rel) -> bool:
    """Host decision: does this join lower to the radix exchange?  As the
    reference decides it, on the sides' global capacities: each divides
    into the mesh's blocks, and the build side is large enough."""
    cfg, mesh = ctx.config, ctx.mesh
    if mesh is None or cfg is None or not cfg.explicit_exchange:
        return False
    if op.join_type not in ("inner", "left"):
        return False
    if len(op.probe_keys) > 2:        # key packing must stay exact
        return False
    pcap = _global_capacity(probe_rel, mesh)
    bcap = _global_capacity(build_rel, mesh)
    if pcap % mesh.size or bcap % mesh.size:
        return False
    return bcap >= cfg.exchange_min_build_rows


def _flatten(rel, names):
    """The columns' arrays, each followed by its NULL mask where it has
    one, and which of them have one."""
    arrs, has_valid = [], []
    for nm in names:
        c = rel.columns[nm]
        arrs.append(c.array)
        has_valid.append(c.valid is not None)
        if c.valid is not None:
            arrs.append(c.valid)
    return arrs, has_valid


def _block(x, mesh):
    b = x.shape[0] // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def _exchange(keys, cols, valid, mesh, quota):
    """Route one side's rows to their owners: -> (keys, cols, valid,
    overflow), each column `n * quota` rows, source-major."""
    k, p, v, overflow = _pack_buckets(keys, cols, valid, mesh.size, quota)
    return (all_to_all(k, mesh), [all_to_all(c, mesh) for c in p],
            all_to_all(v, mesh), overflow)


def execute(ctx, op, probe_rel, build_rel, pkey, bkey):
    """Run the exchange join over this rank's blocks; -> its row block of
    the output.  pkey / bkey: combined int64 key columns (collision-free
    for at most two key columns, by exact packing)."""
    from ..plan.physical import RelColumn, Relation
    from ..storage.table import pad_count
    from ..types import BOOL
    from .shard import block_of

    mesh = ctx.mesh
    n = mesh.size
    cfg = ctx.config
    left = op.join_type == "left"
    if not probe_rel.sharded:
        probe_rel, pkey = block_of(probe_rel, mesh), _block(pkey, mesh)
    if not build_rel.sharded:
        build_rel, bkey = block_of(build_rel, mesh), _block(bkey, mesh)
    pcap, bcap = probe_rel.capacity, build_rel.capacity
    bq = getattr(op, "_exq_build", None) or default_quota(
        bcap, n, cfg.exchange_quota_slack)
    pq = getattr(op, "_exq_probe", None) or default_quota(
        pcap, n, cfg.exchange_quota_slack)
    # the quotas in use, which the retry doubles, and the traffic they
    # cause (bytes over every pair of ranks, a key, a flag and the columns)
    op._exq_build, op._exq_probe = bq, pq
    row_bytes_p = 9 + sum(c.array.element_size()
                          for c in probe_rel.columns.values())
    row_bytes_b = 9 + sum(c.array.element_size()
                          for c in build_rel.columns.values())
    op._exchange_bytes = n * n * (pq * row_bytes_p + bq * row_bytes_b)
    if op.single_match and not getattr(op, "_force_expand", False):
        return _single_match(ctx, op, probe_rel, build_rel, pkey, bkey, bq,
                             pq)
    cap = getattr(op, "_cap_override", None) or op.out_capacity
    if cap is None:
        cap = pad_count(int(pcap * n * cfg.join_expansion_factor))
    cap_local = max(8192, -(-cap // n))

    pnames = list(probe_rel.columns)
    bnames = [nm for nm in build_rel.columns
              if op.build_prefix + nm not in probe_rel.columns]
    parrs, pvalid_flags = _flatten(probe_rel, pnames)
    barrs, bvalid_flags = _flatten(build_rel, bnames)
    bk, bcols, bv, bovf = _exchange(bkey, barrs, build_rel.mask, mesh, bq)
    pk, pcols, pv, povf = _exchange(pkey, parrs, probe_rel.mask, mesh, pq)
    # the local sort-merge join over the partitions this rank owns
    bs = join_ops.build(bk, bv)
    entry = join_ops.probe(bs, pk, pv)
    out_probe, out_build, total = join_ops.expand_matches(
        bs.starts, bs.counts, bs.sorted_rows, entry, pv, cap_local,
        left=left)
    ctx.add_check(op, "exq", bovf + povf == 0)
    ctx.add_check(op, "expansion", total <= cap_local, cap_local * n)
    valid = torch.arange(cap_local, device=pk.device) < total
    matched = out_build >= 0
    safe_p = torch.clamp(out_probe, 0, pk.shape[0] - 1)
    safe_b = torch.clamp(out_build, 0, bk.shape[0] - 1)

    cols: dict = {}

    def emit(rel, names, flags, arrs, safe, prefix, null_unmatched):
        i = 0
        for nm, has_valid in zip(names, flags):
            c = rel.columns[nm]
            arr = arrs[i][safe]
            i += 1
            v = None
            if has_valid:
                v = arrs[i][safe]
                i += 1
            if null_unmatched:
                v = matched if v is None else (v & matched)
            cols[prefix + nm] = RelColumn(arr, c.dtype, c.dictionary,
                                          c.domain, v)

    emit(probe_rel, pnames, pvalid_flags, pcols, safe_p, "", False)
    emit(build_rel, bnames, bvalid_flags, bcols, safe_b, op.build_prefix,
         left)
    if left and op.found_column:
        # decorrelated EXISTS / COUNT rewrites filter on this flag, as the
        # broadcast path emits it
        cols[op.found_column] = RelColumn(matched & valid, BOOL, None)
    return Relation(cols, valid, cap_local, sharded=True)


def _single_match(ctx, op, probe_rel, build_rel, pkey, bkey, bq, pq):
    """The single-match form: the output keeps the probe block's rows (see
    the module docstring).  Each probe row travels with its row number; the
    owner's answer (found, the build columns) comes back in the same bucket
    layout and is scattered to those rows."""
    from ..plan.physical import RelColumn, Relation

    mesh = ctx.mesh
    dev = pkey.device
    barrs, bvalid_flags = _flatten(build_rel, list(build_rel.columns))
    bk, bcols, bv, bovf = _exchange(bkey, barrs, build_rel.mask, mesh, bq)
    rows = torch.arange(probe_rel.capacity, dtype=torch.int64, device=dev)
    pk, (prow,), pv, povf = _exchange(pkey, [rows], probe_rel.mask, mesh, pq)
    bs = join_ops.build(bk, bv)
    entry = join_ops.probe(bs, pk, pv)
    found = entry >= 0
    safe_e = entry.clamp(min=0).to(torch.int64)
    # the single-match contract, as the broadcast path checks it: the
    # matched build keys are unique, else the retry expands
    ctx.add_check(op, "unique", (~found | (bs.counts[safe_e] <= 1)).all())
    ctx.add_check(op, "exq", bovf + povf == 0)
    start = bs.starts[safe_e].to(torch.int64).clamp(
        max=bs.sorted_rows.shape[0] - 1)
    brow = bs.sorted_rows[start].to(torch.int64).clamp(0, bk.shape[0] - 1)
    # back to the sources: the received rows are source-major, so the
    # same layout returns each rank's bucket to it
    found = all_to_all(found, mesh)
    prow = all_to_all(prow, mesh)
    back = [all_to_all(c[brow], mesh) for c in bcols]
    cap = probe_rel.capacity
    at = torch.where(found, prow, torch.full_like(prow, cap))

    def scatter(x):
        out = torch.zeros(cap + 1, dtype=x.dtype, device=dev)
        out[at] = x
        return out[:cap]

    hit = scatter(found)
    # the build columns of each probe row's match, as a relation aligned
    # to the probe block: build row i is probe row i's
    cols, i = {}, 0
    for nm, has_valid in zip(build_rel.columns, bvalid_flags):
        c = build_rel.columns[nm]
        arr = scatter(back[i])
        i += 1
        v = None
        if has_valid:
            v = scatter(back[i])
            i += 1
        cols[nm] = RelColumn(arr, c.dtype, c.dictionary, c.domain, v)
    fetched = Relation(cols, hit, cap, sharded=True)
    build_row = torch.where(hit, rows, torch.full_like(rows, -1))
    return op._gather_single(probe_rel, fetched, build_row, hit, None, {})
