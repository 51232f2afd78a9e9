"""Physical operators.

Counterpart of `duckdb_cubit_tpu/plan/physical.py`.  Every operator consumes
and produces a `Relation` — named device tensors plus a validity mask — and
keeps its input's capacity wherever it can, narrowing the mask instead of
moving rows.  Ported so far: TableScan (CUBIT index words, the decode-vs-mask
decision, row-id decode), Filter, Project, GroupAggregate (ungrouped, with
the fused bitmap-scan + SUM kernel of `ops/fused_scan.py`; dense mixed-radix,
FK-dense and sort-based grouping), HashJoin (the direct-address PK path,
whose probe and build-value fetch go through the monotone gather kernel of
`ops/probe.py`; the reverse-PK semi join; and the general sort-merge paths
of `ops/join.py`: single match, expansion, LEFT / FULL OUTER, SEMI / ANTI,
multi-column keys), RangeJoin (non-equi joins and the cross product),
AsofJoin, Window (the primitives of `ops/window.py`), OrderBy and Limit; and
the operators the binder emits for subqueries and sources: MarkJoin (EXISTS
/ IN with a residual), BroadcastScalar (uncorrelated scalar subqueries),
SingleRow (no FROM), RangeSource (range() / generate_series()) and
Materialized.  A table's deleted rows (`Table.deleted`) drop out of every
scan through `Table.row_mask`.

On a catalog sharded over a mesh (`parallel/shard.py`, whose docstring sets
out the execution model) a relation is a row block (`Relation.sharded`) or
replicated.  TableScan, Filter, Project, BroadcastScalar and a HashJoin's
probe side keep a block where it is; the HashJoin gathers its build side
(a broadcast join) unless the radix exchange takes it
(`parallel/exchange_join.py`); GroupAggregate reduces per-block partials
where its group slots are the same on every rank; every other operator
gathers its inputs first (`PhysicalOperator._inputs`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..exec import profiler as PROF
from ..ops import bitmap as bm
from ..ops import fused_scan as fs
from ..ops import groupby as groupby_ops
from ..ops import join as join_ops
from ..ops import kernels
from ..ops import probe as PPK
from ..ops.expressions import (Arith, Col, ColMeta, EvalContext, Expr,
                               Typed, _as_double, _rescale, _wide, as_mask)
from ..parallel import exchange_join as XJ
from ..parallel import shard as SH
from ..storage.table import Table, pad_count
from ..types import BOOL, DOUBLE, INT64, DataType, TypeId

# probe rows that took a key-to-row table (`HashJoin._pk_probe`)
PROF.declare("pk_probe_rows")


@dataclasses.dataclass
class RelColumn:
    array: torch.Tensor
    dtype: DataType
    dictionary: np.ndarray | None = None
    domain: np.ndarray | None = None  # sorted distinct values (CHAR1/small int)
    # per-value NULL mask (None = all valid)
    valid: torch.Tensor | None = None
    # array values are non-decreasing over positions (host-tracked from
    # storage sortedness through order-preserving operators)
    monotone: bool = False


@dataclasses.dataclass
class Relation:
    """A batch of named columns + validity mask (the inter-operator format).
    `sharded`: this rank's row block of a relation over a mesh (the global
    relation is the blocks in rank order); otherwise the whole relation."""
    columns: dict[str, RelColumn]
    mask: torch.Tensor
    capacity: int
    sharded: bool = False

    def eval_ctx(self) -> EvalContext:
        arrays = {n: c.array for n, c in self.columns.items()}
        meta = {n: ColMeta(c.dtype, c.dictionary) for n, c in self.columns.items()}
        valids = {n: c.valid for n, c in self.columns.items()
                  if c.valid is not None}
        ctx = EvalContext(arrays, meta, valids)
        ctx.sharded = self.sharded
        return ctx

    def count(self) -> int:
        """Live rows (a device -> host sync; of a block, the block's)."""
        return int(self.mask.sum())

    def evaluate(self, expr: Expr) -> Typed:
        return expr.eval(self.eval_ctx())

    def with_mask(self, mask) -> "Relation":
        return Relation(self.columns, mask, self.capacity, self.sharded)

    def gather(self, indices: torch.Tensor, valid: torch.Tensor,
               capacity: int) -> "Relation":
        safe = torch.clamp(indices, 0, self.capacity - 1)
        cols = {
            n: RelColumn(c.array[safe], c.dtype, c.dictionary, c.domain,
                         None if c.valid is None else c.valid[safe])
            for n, c in self.columns.items()
        }
        return Relation(cols, valid, capacity, self.sharded)


class ExecContext:
    def __init__(self, catalog, config=None, profiler=None):
        self.catalog = catalog
        self.config = config
        # EXPLAIN ANALYZE: times and counts every operator (exec/profiler.py)
        self.profiler = profiler
        # verification leg 3: the direct-address and fused fast paths stay
        # off, so the generic operator paths confirm the result on their own
        self.verify_mode = False
        # an out-of-core pass: the fused scan-sum declines (its inputs are
        # whole-table shaped)
        self.no_fused = False
        # id(scan) -> (lo, hi, row_limit): the row range an out-of-core pass
        # hands its driving scan
        self.scan_chunks: dict[int, tuple[int, int, int]] = {}
        # deferred runtime assertions (name, 0-d bool tensor), read by the
        # executor after the run
        self.checks: list[tuple[str, object]] = []
        # id(op) -> the op's position in the operator list the executor
        # retries over (plan.walk(), or a stage's operators), so a failed
        # check names the operator the executor's retry flips
        self.check_tags: dict[int, int] = {}
        # id(op) -> its output, so a subtree shared by two parents runs once;
        # the staged executor puts each stage input here before the stage
        # runs
        self._cache: dict[int, Relation] = {}

    @property
    def mesh(self):
        """The mesh the catalog is sharded over, or None."""
        return getattr(self.catalog, "mesh", None)

    def replicated(self, rel: Relation) -> Relation:
        """`rel` whole on every rank: gathered when it is a row block."""
        return SH.gather_relation(rel, self.mesh) if rel.sharded else rel

    def add_check(self, op, kind: str, ok, cap: int = 0):
        """Attach a deferred runtime assertion, named `kind#tag` (or
        `kind#tag#cap` with a capacity).  Each kind is recoverable, and the
        executor runs the query again (exec/executor.py): "pkprobe" flips
        the join to the plain lut probe, "unique" from the single-match to
        the expansion join, and "expansion" doubles the join's output
        capacity."""
        tag = self.check_tags.get(id(op), -1)
        name = f"{kind}#{tag}" + (f"#{int(cap)}" if cap else "")
        self.checks.append((name, ok))


class PhysicalOperator:
    """Base physical operator; `children` gives the pipeline structure."""

    name = "physical_op"

    def __init__(self, children: Sequence["PhysicalOperator"] = ()):
        self.children = list(children)

    def execute(self, ctx: ExecContext) -> Relation:
        key = id(self)
        if key in ctx._cache:
            return ctx._cache[key]
        qp = ctx.profiler
        with PROF.operator(self, qp):
            out = self._execute(ctx)
            if qp is not None:
                # wait for the card, so that an operator's time holds its
                # own kernels (and its children's) and no one else's
                if out.mask.is_cuda:
                    torch.cuda.synchronize(out.mask.device)
                if qp.measure_cardinality:
                    qp.record_cardinality(self, out.count())
        ctx._cache[key] = out
        return out

    def _execute(self, ctx: ExecContext) -> Relation:
        raise NotImplementedError

    def _inputs(self, ctx: ExecContext) -> list[Relation]:
        """Every child's output whole on every rank: the operators whose
        rows depend on rows of other blocks gather their inputs first."""
        return [ctx.replicated(c.execute(ctx)) for c in self.children]

    # pipeline-breaker protocol (build sides finish before probes run)
    def is_pipeline_breaker(self) -> bool:
        return False

    def blocking_children(self) -> list["PhysicalOperator"]:
        return []

    def describe(self) -> str:
        return self.name

    def prepare(self, ctx: ExecContext):
        """Host-side decisions that depend on data (index words, decode
        capacities, PK eligibility, kernel inputs), before execution."""
        for c in self.children:
            c.prepare(ctx)

    def signature(self) -> str:
        """Structural signature: the prepare cache's key."""
        child_sigs = ",".join(c.signature() for c in self.children)
        return f"{self._self_signature()}({child_sigs})"

    def _self_signature(self) -> str:
        return self.name

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def static_base_table(op: PhysicalOperator) -> str | None:
    """Which base table's row space an operator's output stays aligned to.

    Mask-preserving operators (filters, projections, limits, semi/anti joins
    and the probe side of single-match joins) keep the base table's capacity
    and row order, which lets joins against them use direct-address PK
    indexes."""
    if isinstance(op, TableScan):
        return None if getattr(op, "_decode_cap", None) is not None \
            else op.table_name
    if isinstance(op, (Filter, Project, Limit)):
        return static_base_table(op.children[0])
    if isinstance(op, HashJoin):
        if op.join_type in ("semi", "anti") or (
                op.single_match and not getattr(op, "_force_expand", False)):
            return static_base_table(op.children[0])
    if isinstance(op, (MarkJoin, BroadcastScalar, Window)):
        # mask-preserving: output rows stay aligned to the probe/child rows
        return static_base_table(op.children[0])
    return None


def relation_from_table(table: Table) -> Relation:
    cols = {
        n: RelColumn(c.data, c.dtype, c.dictionary, c.domain)
        for n, c in table.columns.items()
    }
    return Relation(cols, table.row_mask(), table.capacity, table.sharded)


class TableScan(PhysicalOperator):
    """Sequential/bitmap/index scan with pushed-down filters.

    Pushed filters resolve against CUBIT indexes first (AND of range-encoded
    bin words); residual predicates evaluate as vectorized expressions ANDed
    into the mask.  When the index count is below the decode threshold the
    scan compacts to row ids and gathers only the projected columns;
    otherwise it stays mask-based.
    """

    name = "table_scan"

    DEFAULT_THRESHOLD = 0.001
    DEFAULT_MAX_COUNT = 1 << 14

    def __init__(self, table_name: str, filters: Sequence[Expr] = (),
                 projection: Sequence[str] | None = None,
                 index_filters: Sequence[tuple] | None = None,
                 decode_threshold: float = DEFAULT_THRESHOLD,
                 decode_max_count: int = DEFAULT_MAX_COUNT):
        super().__init__()
        self.table_name = table_name
        self.filters = list(filters)
        self.projection = list(projection) if projection is not None else None
        # index_filters: [(column, kind, args)] resolved by the optimizer
        self.index_filters = list(index_filters or [])
        self.decode_threshold = decode_threshold
        self.decode_max_count = decode_max_count
        # the build side of a join through a key-to-row table keeps its
        # table's row space (`HashJoin._align_pk_build`)
        self.keep_aligned = False

    def needed_columns(self, table: Table) -> list[str]:
        if self.projection is None:
            return list(table.columns.keys())
        needed = set(self.projection)
        for f in self.filters:
            needed |= _expr_columns(f)
        return [n for n in table.columns if n in needed]

    def _index_words(self, table: Table):
        """Evaluate pushed index filters -> combined candidate bitvector."""
        index_words = None
        for col_name, kind, args in self.index_filters:
            idx = table.indexes[col_name]
            if kind == "eq":
                words = idx.query_eq(args[0])
            elif kind == "isin":
                words = idx.query_isin(args[0])
            elif kind == "range":
                res = idx.query_range(*args)
                assert res.exact, "non-exact index range needs residual filter"
                words = res.words
            else:
                raise ValueError(kind)
            index_words = words if index_words is None else (index_words & words)
        return index_words

    def _index_count_bound(self, table: Table) -> int | None:
        """Host-side upper bound on the candidate count: min over each index
        filter's exact bin-range cardinality."""
        bound = None
        for col_name, kind, args in self.index_filters:
            idx = table.indexes[col_name]
            if kind == "eq":
                c = idx.count_eq(args[0])
            elif kind == "isin":
                c = idx.count_isin(args[0])
            elif kind == "range":
                c = idx.count_range(*args)
            else:
                c = None
            if c is not None:
                bound = c if bound is None else min(bound, c)
        return bound

    def prepare(self, ctx: ExecContext):
        """Evaluate index bitvectors and take the decode-vs-mask decision
        from host-side bin cardinalities: no device -> host pull.  The
        thresholds come from the session config when present; constructor
        arguments are plan-level overrides."""
        table = ctx.catalog.table(self.table_name)
        threshold = self.decode_threshold
        max_count = self.decode_max_count
        if ctx.config is not None:
            if self.decode_threshold == TableScan.DEFAULT_THRESHOLD:
                threshold = ctx.config.index_scan_percentage
            if self.decode_max_count == TableScan.DEFAULT_MAX_COUNT:
                max_count = ctx.config.index_scan_max_count
        self._words = self._index_words(table)
        self._decode_cap = None
        if self._words is not None and not self.filters and \
                not self.keep_aligned:
            n_rows = table.num_rows
            bound = self._index_count_bound(table)
            limit = max(max_count, int(n_rows * threshold))
            if bound is not None and bound <= limit and bound < n_rows // 2:
                # the bound is the whole table's count (global bin counts):
                # it holds a block's count too, and the decode pays only if
                # it is below the capacity of the rows this scan reads (the
                # block's, on a mesh)
                cap = pad_count(bound)
                if cap < table.capacity:
                    self._decode_cap = cap

    def _execute(self, ctx: ExecContext) -> Relation:
        table = ctx.catalog.table(self.table_name)
        if not hasattr(self, "_words"):
            self.prepare(ctx)
        names = self.needed_columns(table)
        words = self._words
        chunk = ctx.scan_chunks.get(id(self))
        if chunk is None:
            lo, hi = 0, table.capacity
            base_mask = table.row_mask()
        else:
            # an out-of-core pass: rows [lo, hi) of the table (lo and hi are
            # multiples of 32, so the index words slice along), the first
            # row_limit of them live; no column claims `monotone` here
            lo, hi, row_limit = chunk
            base_mask = torch.arange(hi - lo, device=table.device) < row_limit
            if table.deleted is not None:
                base_mask = base_mask & ~table.deleted[lo:hi]
            if words is not None:
                words = words[lo // 32:hi // 32]
        capacity = hi - lo
        rel = Relation(
            {n: RelColumn(table.columns[n].data[lo:hi], table.columns[n].dtype,
                          table.columns[n].dictionary,
                          table.columns[n].domain,
                          valid=None if table.columns[n].nulls is None
                          else ~table.columns[n].nulls[lo:hi],
                          monotone=chunk is None
                          and table.columns[n].is_sorted)
             for n in names},
            base_mask,
            capacity,
            table.sharded)
        if getattr(self, "always_false", False):
            # statistics propagation proved the filters unsatisfiable
            return rel.with_mask(torch.zeros(capacity, dtype=torch.bool,
                                             device=table.device))
        mask = rel.mask
        if words is not None:
            mask = mask & bm.expand(words, capacity)
        for f in self.filters:
            mask = mask & as_mask(rel.evaluate(f))
        rel = rel.with_mask(mask)
        if self._decode_cap is not None:
            # index-scan path: decode row ids, gather only projected columns
            cap = self._decode_cap
            rowids, count = kernels.mask_to_indices(mask, cap)
            valid = torch.arange(cap, device=table.device) < count
            mono = {n: c.monotone for n, c in rel.columns.items()}
            rel = rel.gather(rowids, valid, cap)
            for n, c in rel.columns.items():
                # row ids ascend, so a sorted source column stays sorted
                c.monotone = mono[n]
        return rel

    def _self_signature(self):
        idx = ";".join(f"{c}:{k}:{a}" for c, k, a in self.index_filters)
        decode = getattr(self, "_decode_cap", None)
        ff = getattr(self, "always_false", False)
        return (f"table_scan[{self.table_name};{self.projection};"
                f"{[repr(f) for f in self.filters]};{idx};decode={decode};"
                f"ff={ff}]")

    def describe(self):
        idx = f" index={[(c, k) for c, k, _ in self.index_filters]}" if self.index_filters else ""
        return f"table_scan({self.table_name}{idx}, filters={len(self.filters)})"


def _expr_columns(expr: Expr) -> set[str]:
    out = set()

    def walk(e):
        if isinstance(e, Col):
            out.add(e.name)
        for f in dataclasses.fields(e) if dataclasses.is_dataclass(e) else []:
            v = getattr(e, f.name)
            if isinstance(v, Expr):
                walk(v)
    walk(expr)
    return out


def _source_device(ctx: ExecContext) -> torch.device:
    """The device of a source that reads no table: the catalog's."""
    dev = getattr(ctx.catalog, "device", None)
    if dev is None:
        raise ValueError("the catalog names no device (open it through "
                         "api.Connection)")
    return dev


class RangeSource(PhysicalOperator):
    """range(start, stop, step) table function: a generated integer
    column."""

    name = "range_source"

    def __init__(self, start: int, stop: int, step: int, colname: str):
        super().__init__()
        if step == 0:
            raise ValueError("range() step must not be 0")
        self.start, self.stop, self.step = start, stop, step
        self.colname = colname
        self.n = max(0, -(-(stop - start) // step))

    def _execute(self, ctx):
        dev = _source_device(ctx)
        cap = pad_count(max(1, self.n))
        slots = torch.arange(cap, dtype=torch.int64, device=dev)
        return Relation({self.colname: RelColumn(slots * self.step
                                                 + self.start, INT64, None)},
                        slots < self.n, cap)

    def _self_signature(self):
        return (f"range[{self.start}:{self.stop}:{self.step}:"
                f"{self.colname}]")


class SingleRow(PhysicalOperator):
    """One-row, zero-column source: SELECT <exprs> without FROM."""

    name = "single_row"

    def _execute(self, ctx):
        n = 8192
        mask = torch.zeros(n, dtype=torch.bool, device=_source_device(ctx))
        mask[0] = True
        return Relation({}, mask, n)

    def _self_signature(self):
        return "single_row"


class Filter(PhysicalOperator):
    """Streaming filter: narrows the mask."""

    name = "filter"

    def __init__(self, child: PhysicalOperator, expr: Expr):
        super().__init__([child])
        self.expr = expr

    def _execute(self, ctx):
        rel = self.children[0].execute(ctx)
        return rel.with_mask(rel.mask & as_mask(rel.evaluate(self.expr)))

    def _self_signature(self):
        return f"filter[{self.expr!r}]"


def _broadcast(value, capacity: int, device) -> torch.Tensor:
    """A constant (host scalar or 0-d tensor) as a column of `capacity`,
    in the engine's 64-bit types."""
    if isinstance(value, torch.Tensor):
        return value.expand(capacity).clone()
    if isinstance(value, (bool, np.bool_)):
        dtype = torch.bool
    elif isinstance(value, (int, np.integer)):
        dtype = torch.int64
    else:
        dtype = torch.float64
    return torch.full((capacity,), value, dtype=dtype, device=device)


class Project(PhysicalOperator):
    """Projection: computed columns.

    `keep_input=True` keeps every input column and adds/overwrites the
    computed ones.
    """

    name = "project"

    def __init__(self, child: PhysicalOperator, exprs: dict[str, Expr | str],
                 keep_input: bool = False):
        super().__init__([child])
        self.exprs = exprs
        self.keep_input = keep_input

    def _execute(self, ctx):
        rel = self.children[0].execute(ctx)
        device = rel.mask.device
        cols = dict(rel.columns) if self.keep_input else {}
        for name, e in self.exprs.items():
            if isinstance(e, str):
                cols[name] = rel.columns[e]
                continue
            t = rel.evaluate(e)
            arr, valid, dictionary = t.array, t.valid, t.dictionary
            # constants broadcast to the row space (scalar validity too)
            if isinstance(arr, str):
                # string literal projection: a 1-entry dictionary
                dictionary = np.array([arr.encode()], dtype="S")
                arr = torch.zeros(rel.capacity, dtype=torch.int32,
                                  device=device)
            elif not isinstance(arr, torch.Tensor) or arr.ndim == 0:
                arr = _broadcast(arr, rel.capacity, device)
            if valid is not None and (not isinstance(valid, torch.Tensor)
                                      or valid.ndim == 0):
                valid = _broadcast(valid, rel.capacity, device)
            cols[name] = RelColumn(arr, t.dtype, dictionary,
                                   domain=t.domain, valid=valid)
        return Relation(cols, rel.mask, rel.capacity, rel.sharded)

    def _self_signature(self):
        return (f"project[{ {n: repr(e) for n, e in self.exprs.items()} };"
                f"keep={self.keep_input}]")


def _combine_keys(ctx, rel: Relation, names: list[str]) -> torch.Tensor:
    """Combine key columns into one int64 join key.

    Two columns pack exactly (collision-free) with a deferred range check
    of the low word, which is not recoverable: its failure raises.  Three or
    more columns hash-combine, and every probe path re-checks the real key
    columns after the match (`_exact_key_eq`)."""
    # float keys go through the injective monotone int64 encoding so
    # equality is exact
    key = kernels.monotone_i64(rel.columns[names[0]].array)
    if len(names) == 2:
        nxt = kernels.monotone_i64(rel.columns[names[1]].array)
        ok = (~rel.mask | ((nxt >= 0) & (nxt < 1 << 32))).all()
        ctx.checks.append((f"join_key_pack_range[{names[1]}]", ok))
        key = (key << 32) + nxt
    elif len(names) > 2:
        for n in names[1:]:
            nxt = kernels.monotone_i64(rel.columns[n].array)
            key = kernels.hash64(key) * 2654435761 ^ nxt
    return key


def _exact_key_eq(probe_rel, build_rel, probe_keys, build_keys, probe_rows,
                  build_rows, base):
    """AND `base` with exact equality of every key column pair, gathered
    through explicit row-index vectors (the collision re-check)."""
    safe_p = torch.clamp(probe_rows, 0, probe_rel.capacity - 1)
    safe_b = torch.clamp(build_rows, 0, build_rel.capacity - 1)
    for pk, bk in zip(probe_keys, build_keys):
        pa = probe_rel.columns[pk].array[safe_p]
        ba = build_rel.columns[bk].array[safe_b]
        base = base & (pa.to(torch.int64) == ba.to(torch.int64))
    return base


def _scatter_flags(size: int, at: torch.Tensor, ok: torch.Tensor):
    """A (size,) bool tensor, True at at[i] wherever ok[i]."""
    tgt = torch.where(ok, at.to(torch.int64), torch.full_like(
        at, size, dtype=torch.int64))
    hit = torch.zeros(size + 1, dtype=torch.bool, device=at.device)
    hit[tgt] = True
    return hit[:size]


class HashJoin(PhysicalOperator):
    """Equi-join.

    `single_match=True` keeps the probe relation's shape and gathers build
    columns through the matched row (no expansion, the mask narrows on a
    miss).  A single-column key whose build side stays aligned to a base
    table with a dense PK index takes the direct-address path; sorted probe
    keys then go through the monotone gather kernel (`ops/probe.py`), which
    fetches the row and the build values from key-space value luts in one
    pass.  A semi / anti join whose PROBE side owns the PK scatters the
    build side's hits into probe rows (the reverse-PK semi join).
    Otherwise the build side is sorted into a CSR and probed by a sort-merge
    (`ops/join.py`): single-match joins check that the matched build keys
    are unique (a recoverable check: the retry expands), and the general
    path expands matches into a fresh capacity (a recoverable check: the
    retry doubles it).  FULL OUTER always expands: unmatched probe rows get
    NULL build columns (as LEFT) and unmatched build rows are appended as an
    extra capacity segment with NULL probe columns.

    join_type: 'inner' | 'semi' | 'anti' | 'left' | 'full'
    """

    name = "hash_join"

    def __init__(self, probe: PhysicalOperator, build: PhysicalOperator,
                 probe_keys: Sequence[str], build_keys: Sequence[str],
                 join_type: str = "inner", single_match: bool = True,
                 out_capacity: int | None = None,
                 build_prefix: str = "", found_column: str | None = None):
        super().__init__([probe, build])
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.join_type = join_type
        self.single_match = single_match
        self.out_capacity = out_capacity
        self.build_prefix = build_prefix
        # left joins: expose the match flag as a named BOOL column (used by
        # decorrelated EXISTS rewrites)
        self.found_column = found_column
        if join_type == "full" and found_column:
            raise ValueError("found_column unsupported for FULL joins")

    def is_pipeline_breaker(self):
        return True

    def blocking_children(self):
        return [self.children[1]]

    def prepare(self, ctx: ExecContext):
        if len(self.build_keys) == 1 and (
                self.single_match or self.join_type in ("semi", "anti")):
            self._align_pk_build(ctx)
        super().prepare(ctx)
        # direct-address PK join eligibility: single-column key against a
        # mask-aligned base-table relation that has a key-to-row table
        self._pk = None
        self._reverse_pk = None
        if len(self.build_keys) == 1:
            base = static_base_table(self.children[1])
            if base is not None:
                table = ctx.catalog.table(base)
                pk = table.pk_indexes.get(self.build_keys[0])
                if pk is not None:
                    self._pk = (base, self.build_keys[0])
                    self._vlut_cols = self._pick_vlut_cols(table)
        if (self._pk is None and self.join_type in ("semi", "anti")
                and len(self.probe_keys) == 1):
            # reverse semi join: the PROBE side owns the PK
            base = static_base_table(self.children[0])
            if base is not None:
                table = ctx.catalog.table(base)
                pk = table.pk_indexes.get(self.probe_keys[0])
                if pk is not None:
                    self._reverse_pk = (base, self.probe_keys[0])

    def _align_pk_build(self, ctx):
        """Before the children prepare: a build side that is a scan (under
        filters and projections) of a table with a key-to-row table on the
        build key keeps its row space.  A selective index scan would
        otherwise decode its rows to a compacted relation, and the join
        would sort the probe side's keys (a sort over every probe row,
        where the table probes them)."""
        op = self.children[1]
        while isinstance(op, (Filter, Project, Limit)):
            op = op.children[0]
        if isinstance(op, TableScan) and self.build_keys[0] in \
                ctx.catalog.table(op.table_name).pk_indexes:
            op.keep_aligned = True

    def _pick_vlut_cols(self, table) -> list[str]:
        """Build columns eligible for the kernel's value-lut fetch:
        int-backed (<= int32 storage), no base NULLs, not the key itself (a
        matched row's key IS the probe key)."""
        out = []
        for name, c in table.columns.items():
            if name == self.build_keys[0] or c.nulls is not None:
                continue
            if c.data.dtype not in (torch.int8, torch.int16, torch.int32):
                continue
            out.append(name)
        return out

    def _pk_probe(self, ctx, probe_rel, build_rel, value_cols=()):
        """-> (build row or -1, found, the probe keys (at a matched row, the
        build key) or None when the plain lut path ran, {column: its build
        values fetched through its value lut by the same kernel pass}).
        `value_cols` are the columns to fetch on the kernel path."""
        table_name, col = self._pk
        table = ctx.catalog.table(table_name)
        pkidx = table.pk_indexes[col]
        kcol = probe_rel.columns[self.probe_keys[0]]
        route = "k2" if self._kernel_probe_eligible(
            ctx, kcol, probe_rel, pkidx.span, build_rel) else "gather"
        PROF.count("pk_probe_rows", probe_rel.capacity)
        with PROF.span("db.join.pk_probe") as sp:
            sp.set(rows=probe_rel.capacity, slots=pkidx.span, route=route)
            if route == "gather":
                row, found = pkidx.probe(kcol.array, probe_rel.mask,
                                         build_rel.mask)
                return row, found, None, {}
            return self._k2_probe(ctx, table, pkidx, kcol, probe_rel,
                                  build_rel, value_cols)

    def _k2_probe(self, ctx, table, pkidx, kcol, probe_rel, build_rel,
                  value_cols):
        """`_pk_probe`'s kernel route.  Build-side liveness folds into the
        lut with one scatter, so the probe and every value fetch are a
        single kernel pass; an overflow (a key that breaks the sorted,
        in-range precondition) is a recoverable deferred check: the executor
        sets _no_kernel_probe and runs the query again."""
        span = pkidx.span
        kc, in_range = pkidx.slots(kcol.array)
        in_range = in_range & probe_rel.mask
        bslot = pkidx.clamped(build_rel.columns[self.build_keys[0]].array)
        tgt = torch.where(build_rel.mask, bslot,
                          torch.full_like(bslot, span))
        alive_slots = torch.zeros(span + 1, dtype=torch.bool,
                                  device=bslot.device)
        alive_slots[tgt] = True
        lut_eff = torch.where(alive_slots[:span], pkidx.lut,
                              torch.full_like(pkidx.lut, -1))
        # value luts are built once on the host and cached on the index
        vluts = []
        for n in value_cols:
            bc = table.columns[n]
            vluts.append(pkidx.device_value_lut(
                n, bc.host if bc.host is not None else bc.data.cpu().numpy()))
        kc = kc.to(torch.int32)
        outs, ovf = PPK.monotone_gather_many([lut_eff, *vluts], kc)
        ctx.add_check(self, "pkprobe", ovf == 0)
        row = outs[0]
        found = in_range & (row >= 0)
        return (torch.where(found, row, torch.full_like(row, -1)), found,
                kcol.array, dict(zip(value_cols, outs[1:])))

    def _value_fetches(self, probe_rel, build_rel) -> list[str]:
        """Build columns the single-match gather takes from value luts: each
        eligible column the join reads and outputs, without NULLs."""
        return [n for n in self._vlut_cols
                if n in build_rel.columns
                and build_rel.columns[n].valid is None
                and self.build_prefix + n not in probe_rel.columns]

    def _kernel_probe_eligible(self, ctx, kcol, probe_rel, span,
                               build_rel) -> bool:
        """Host gate of the kernel probe: sorted probe keys (the storage
        column, or a compaction of it that keeps its order), no NULL keys,
        the kernel's size gate over the table's `span` slots, and not
        verification's leg 3."""
        if getattr(self, "_no_kernel_probe", False) or ctx.verify_mode:
            return False
        if not kcol.monotone or span >= 2**31:
            return False
        if kcol.valid is not None:
            return False
        if self.build_keys[0] not in build_rel.columns:
            return False
        return PPK.plan_monotone_gather(probe_rel.capacity, span)

    def _execute(self, ctx):
        probe_rel = self.children[0].execute(ctx)
        build_rel = self.children[1].execute(ctx)
        if not hasattr(self, "_pk"):
            self.prepare(ctx)
        if not ctx.verify_mode:
            if XJ.eligible(self, ctx, probe_rel, build_rel):
                # the radix exchange: both sides routed to their hash
                # owners, a local sort-merge join per rank, no build side
                # replicated
                self._exchange_used = True
                pkey = _combine_keys(ctx, probe_rel, self.probe_keys)
                bkey = _combine_keys(ctx, build_rel, self.build_keys)
                return XJ.execute(ctx, self, probe_rel, build_rel, pkey,
                                  bkey)
        use_pk = self._pk is not None and not ctx.verify_mode and (
            self.single_match or self.join_type in ("semi", "anti"))
        # on a mesh, a broadcast join: the build side whole on every rank
        # (a PK lut's rows are global), the probe side's block joined where
        # it lies.  FULL's unmatched build rows and the reverse-PK flags
        # (probe-row positions) need the probe side whole too.
        build_rel = ctx.replicated(build_rel)
        if self.join_type == "full" or (
                not use_pk and self._reverse_pk is not None
                and not ctx.verify_mode):
            probe_rel = ctx.replicated(probe_rel)
        if use_pk:
            if self.join_type in ("semi", "anti"):
                found = self._pk_probe(ctx, probe_rel, build_rel)[1]
                m = ~found if self.join_type == "anti" else found
                return probe_rel.with_mask(m & probe_rel.mask)
            build_row, found, kc, values = self._pk_probe(
                ctx, probe_rel, build_rel,
                self._value_fetches(probe_rel, build_rel))
            return self._gather_single(probe_rel, build_rel, build_row,
                                       found, kc, values)
        if self._reverse_pk is not None and not ctx.verify_mode:
            # the probe side owns the PK: one scatter of the build side's
            # hits into a probe-row flag array instead of a hash build
            pkidx = ctx.catalog.table(self._reverse_pk[0]).pk_indexes[
                self.probe_keys[0]]
            slot, ok = pkidx.slots(build_rel.columns[self.build_keys[0]].array)
            ok = build_rel.mask & ok
            rows = pkidx.lut[slot]
            hit = _scatter_flags(probe_rel.capacity, rows, ok & (rows >= 0))
            m = ~hit if self.join_type == "anti" else hit
            return probe_rel.with_mask(probe_rel.mask & m)
        bkey = _combine_keys(ctx, build_rel, self.build_keys)
        pkey = _combine_keys(ctx, probe_rel, self.probe_keys)
        bs = join_ops.build(bkey, build_rel.mask)
        if self.join_type in ("semi", "anti"):
            if len(self.probe_keys) > 2:
                # hash-combined keys can collide: expansion, the exact
                # re-check and a scatter of the hits
                hit = self._semi_exact(ctx, probe_rel, build_rel, bs, pkey)
                m = ~hit if self.join_type == "anti" else hit
                return probe_rel.with_mask(m & probe_rel.mask)
            return probe_rel.with_mask(join_ops.semi_mask(
                bs, pkey, probe_rel.mask, anti=self.join_type == "anti"))
        if self.single_match and not getattr(self, "_force_expand", False) \
                and not ctx.verify_mode and self.join_type != "full":
            entry = join_ops.probe(bs, pkey, probe_rel.mask)
            found = entry >= 0
            safe_e = entry.clamp(min=0).to(torch.int64)
            # an unused entry's start is the capacity: clamped, then masked
            start = bs.starts[safe_e].to(torch.int64).clamp(
                max=bs.sorted_rows.shape[0] - 1)
            build_row = torch.where(found, bs.sorted_rows[start],
                                    torch.full_like(entry, -1))
            # the single-match contract: the matched build keys are unique;
            # otherwise the retry takes the expansion join
            unique_ok = (~found | (bs.counts[safe_e] <= 1)).all()
            ctx.add_check(self, "unique", unique_ok)
            if len(self.probe_keys) > 2:
                probe_rows = torch.arange(probe_rel.capacity,
                                          device=entry.device)
                found = _exact_key_eq(probe_rel, build_rel, self.probe_keys,
                                      self.build_keys, probe_rows, build_row,
                                      found)
            return self._gather_single(probe_rel, build_rel, build_row,
                                       found, None, {})
        return self._expand(ctx, probe_rel, build_rel, bs, pkey)

    def _semi_exact(self, ctx, probe_rel, build_rel, bs, pkey):
        """Exact semi-join hit mask for hash-combined (3+ column) keys."""
        cap = (getattr(self, "_cap_override", None) or self.out_capacity
               or pad_count(probe_rel.capacity))
        entry = join_ops.probe(bs, pkey, probe_rel.mask)
        out_probe, out_build, total = join_ops.expand_matches(
            bs.starts, bs.counts, bs.sorted_rows, entry, probe_rel.mask, cap)
        ctx.add_check(self, "expansion", total <= cap, cap)
        valid = (torch.arange(cap, device=entry.device) < total) & \
            (out_probe >= 0)
        eq = _exact_key_eq(probe_rel, build_rel, self.probe_keys,
                           self.build_keys, out_probe, out_build, valid)
        return _scatter_flags(probe_rel.capacity, out_probe.clamp(min=0), eq)

    def _expand(self, ctx, probe_rel, build_rel, bs, pkey):
        """Inner / LEFT / FULL join with variable match counts, expanded
        into (probe row, build row) pairs at a static output capacity; the
        output columns are fresh gathers, so none claims `monotone`."""
        left = self.join_type in ("left", "full")
        entry = join_ops.probe(bs, pkey, probe_rel.mask)
        cap = getattr(self, "_cap_override", None) or self.out_capacity
        if cap is None:
            # a guess from the session config; the deferred check below
            # catches an undershoot and the executor regrows and retries
            factor = (ctx.config.join_expansion_factor
                      if ctx.config is not None else 1.0)
            cap = pad_count(int(probe_rel.capacity * factor))
        out_probe, out_build, total = join_ops.expand_matches(
            bs.starts, bs.counts, bs.sorted_rows, entry, probe_rel.mask, cap,
            left=left)
        ctx.add_check(self, "expansion", total <= cap, cap)
        valid = torch.arange(cap, device=entry.device) < total
        matched = out_build >= 0
        if len(self.probe_keys) > 2:
            eq = _exact_key_eq(probe_rel, build_rel, self.probe_keys,
                               self.build_keys, out_probe, out_build,
                               valid & matched)
            if left:
                matched = matched & eq
            else:
                valid = eq
        out = probe_rel.gather(out_probe, valid, cap)
        cols = dict(out.columns)
        safe_b = torch.clamp(out_build, 0, build_rel.capacity - 1)
        for n, c in build_rel.columns.items():
            out_name = self.build_prefix + n
            if out_name in cols:
                continue
            v = None if c.valid is None else c.valid[safe_b]
            if left:
                # unmatched probe rows see NULL build values
                v = matched if v is None else (v & matched)
            cols[out_name] = RelColumn(c.array[safe_b], c.dtype, c.dictionary,
                                       c.domain, v)
        if left and self.found_column:
            cols[self.found_column] = RelColumn(matched & valid, BOOL, None)
        if self.join_type == "full":
            return self._append_unmatched_build(
                probe_rel, build_rel, cols, valid, cap, out_build, matched)
        return Relation(cols, valid, cap, probe_rel.sharded)

    def _append_unmatched_build(self, probe_rel, build_rel, cols, valid,
                                cap, out_build, matched):
        """FULL OUTER tail: build rows no probe row matched, appended as an
        extra capacity segment with NULL probe columns."""
        bcap = build_rel.capacity
        dev = valid.device
        hit = _scatter_flags(bcap, out_build.clamp(min=0), matched & valid)
        extra_mask = build_rel.mask & ~hit
        probe_names = set(probe_rel.columns)
        ones_head = torch.ones(cap, dtype=torch.bool, device=dev)
        out_cols = {}
        for n, c in cols.items():
            head_v = c.valid if c.valid is not None else ones_head
            if n in probe_names:
                arr = torch.cat([c.array, torch.zeros(
                    bcap, dtype=c.array.dtype, device=dev)])
                v = torch.cat([head_v, torch.zeros(bcap, dtype=torch.bool,
                                                   device=dev)])
            else:
                # build-origin column: strip the prefix to find the source
                stripped = n[len(self.build_prefix):]
                src = build_rel.columns[
                    stripped if n.startswith(self.build_prefix)
                    and stripped in build_rel.columns else n]
                arr = torch.cat([c.array, src.array.to(c.array.dtype)])
                tail_v = src.valid if src.valid is not None else \
                    torch.ones(bcap, dtype=torch.bool, device=dev)
                v = torch.cat([head_v, tail_v])
            out_cols[n] = RelColumn(arr, c.dtype, c.dictionary, c.domain, v)
        return Relation(out_cols, torch.cat([valid, extra_mask]), cap + bcap)

    def _gather_single(self, probe_rel, build_rel, build_row, found,
                       kernel_keys, values):
        safe = torch.clamp(build_row, 0, build_rel.capacity - 1)
        left = self.join_type == "left"
        cols = dict(probe_rel.columns)
        for n, c in build_rel.columns.items():
            out_name = self.build_prefix + n
            if out_name in cols:
                continue
            v = None if c.valid is None else c.valid[safe]
            if left:
                # unmatched probe rows see NULL build values
                v = found if v is None else (v & found)
            if kernel_keys is not None and c.valid is None and \
                    n == self.build_keys[0]:
                # a matched row's build key IS the probe key: no gather
                cols[out_name] = RelColumn(kernel_keys.to(c.array.dtype),
                                           c.dtype, c.dictionary, c.domain,
                                           found if left else v)
                continue
            if n in values:
                # the build VALUE, fetched in the probe's kernel pass over
                # the key-space value lut; garbage at unmatched slots is
                # masked by `found` exactly like the row gather
                cols[out_name] = RelColumn(values[n].to(c.array.dtype),
                                           c.dtype, c.dictionary, c.domain,
                                           found if left else None)
                continue
            cols[out_name] = RelColumn(c.array[safe], c.dtype, c.dictionary,
                                       c.domain, v)
        if left:
            mask = probe_rel.mask
            if self.found_column:
                cols[self.found_column] = RelColumn(found, BOOL, None)
        else:
            mask = probe_rel.mask & found
        return Relation(cols, mask, probe_rel.capacity, probe_rel.sharded)

    def describe(self):
        return (f"hash_join({self.join_type}, {self.probe_keys}={self.build_keys},"
                f" single={self.single_match})")

    def _self_signature(self):
        # includes every switch a retry flips (the regrown capacity, the
        # expansion fallback, the kernel switch), so a retry is a new
        # prepare-cache entry and never the stale one
        return (f"hash_join[{self.join_type};{self.probe_keys};{self.build_keys};"
                f"{self.single_match};{self.out_capacity};{self.build_prefix};"
                f"fc={self.found_column};"
                f"pk={getattr(self, '_pk', None)};"
                f"rpk={getattr(self, '_reverse_pk', None)};"
                f"ov={getattr(self, '_cap_override', None)};"
                f"fe={getattr(self, '_force_expand', False)};"
                f"nkp={getattr(self, '_no_kernel_probe', False)};"
                f"exq={getattr(self, '_exq_probe', None)},"
                f"{getattr(self, '_exq_build', None)};"
                f"exu={getattr(self, '_exchange_used', False)}]")


def _comparable(pt: Typed, bt: Typed):
    """Two sides of a join condition in one domain: float64 when either
    is DOUBLE, else int64 at one decimal scale (as `ops/expressions`
    comparisons align them).  The reference compares the raw scaled
    integers, so a DECIMAL side against an INTEGER side matched wrongly
    there.  -> (probe array, build array, floating)."""
    if TypeId.DOUBLE in (pt.dtype.id, bt.dtype.id):
        return _as_double(pt), _as_double(bt), True
    s = max(t.dtype.scale if t.dtype.id == TypeId.DECIMAL else 0
            for t in (pt, bt))
    return (_wide(_rescale(pt, s).array), _wide(_rescale(bt, s).array),
            False)


def _cmp_arrays(a, op: str, b):
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    if op == "==":
        return a == b
    raise ValueError(f"unsupported range-join op {op}")


class RangeJoin(PhysicalOperator):
    """Non-equi join: band joins, inequality joins and the cross product.

    The build side is sorted on the first condition's build expression and
    each probe row's match set is a contiguous range of that order, located
    by one vectorized searchsorted.  The ranges expand through the same
    static-capacity machinery as the hash join (`ops/join.expand_matches`,
    with the recoverable `expansion` check the executor regrows), and every
    remaining condition is re-checked on the expanded pairs.  An empty
    condition list is the cross product.  Both sides of a condition compare
    at one decimal scale.

    conditions: [(probe_expr, op, build_expr), ...], op in < <= > >= ==,
    each expr reading only its own side's columns.  join_type: 'inner' |
    'semi' | 'anti' | 'left' ('left' takes one condition).
    """

    name = "range_join"

    def __init__(self, probe: PhysicalOperator, build: PhysicalOperator,
                 conditions: Sequence[tuple], join_type: str = "inner",
                 out_capacity: int | None = None, build_prefix: str = ""):
        super().__init__([probe, build])
        self.conditions = list(conditions)
        self.join_type = join_type
        self.out_capacity = out_capacity
        self.build_prefix = build_prefix
        if join_type == "left" and len(self.conditions) > 1:
            raise ValueError("LEFT range join supports one condition")

    def is_pipeline_breaker(self):
        return True

    def blocking_children(self):
        return [self.children[1]]

    @staticmethod
    def _keys(probe_rel, build_rel, pe, be):
        """One condition's sides as order-preserving int64 keys (DOUBLE
        through the monotone encoding), the key past every value, and the
        typed sides."""
        dev = probe_rel.mask.device
        pt, bt = probe_rel.evaluate(pe), build_rel.evaluate(be)
        pa, ba, floating = _comparable(pt, bt)
        pv = _column(pa, probe_rel.capacity, dev)
        bv = _column(ba, build_rel.capacity, dev)
        if floating:
            pv, bv = kernels.monotone_i64(pv), kernels.monotone_i64(bv)
            big = torch.iinfo(torch.int64).max
        else:
            pv, bv, big = pv.to(torch.int64), bv.to(torch.int64), 2**62
        return pv, bv, big, pt, bt

    @staticmethod
    def _span(op, sorted_vals, pv, nb):
        """[s, e): the positions of ascending `sorted_vals` (the first `nb`
        live) whose value v satisfies `probe op v`."""
        lo = torch.searchsorted(sorted_vals, pv)
        hi = torch.searchsorted(sorted_vals, pv, right=True)
        zero = torch.zeros_like(lo)
        nb = nb.expand_as(lo)
        spans = {"<": (hi, nb),     # probe < build: the strictly greater
                 "<=": (lo, nb),    # suffix
                 ">": (zero, lo),   # probe > build: the strictly smaller
                 ">=": (zero, hi),  # prefix
                 "==": (lo, hi)}
        if op not in spans:
            raise ValueError(f"unsupported range-join op {op}")
        return spans[op]

    def _ranges(self, probe_rel: Relation, build_rel: Relation):
        """Per-probe (start, count) into the sorted build order, and the
        order.

        A later condition whose build values ascend along that order (the
        upper bounds of non-overlapping bands sorted by their lower bounds)
        selects a contiguous range of it too, and the two ranges intersect:
        a band join then expands only the pairs inside the band.  Whether
        they ascend is read on the device and chosen by `where`, with no
        host read; the residual re-check on the pairs stays either way."""
        dev = probe_rel.mask.device
        if not self.conditions:  # cross product: every valid build row
            order = torch.sort((~build_rel.mask).to(torch.int8),
                               stable=True)[1]
            nb = build_rel.mask.to(torch.int64).sum()
            start = torch.zeros(probe_rel.capacity, dtype=torch.int64,
                                device=dev)
            count = torch.where(probe_rel.mask, nb, 0)
            return start, count, order
        pe, op, be = self.conditions[0]
        pv, bv, big, pt, bt = self._keys(probe_rel, build_rel, pe, be)
        bvalid = build_rel.mask if bt.valid is None \
            else build_rel.mask & bt.valid
        sort_key = torch.where(bvalid, bv, big)     # invalid rows sort last
        sorted_vals, order = torch.sort(sort_key, stable=True)
        nb = bvalid.to(torch.int64).sum()
        start, end = self._span(op, sorted_vals, pv, nb)
        live = torch.arange(build_rel.capacity, device=dev) < nb
        for pe2, op2, be2 in self.conditions[1:]:
            pv2, bv2, big2, _, bt2 = self._keys(probe_rel, build_rel, pe2,
                                                be2)
            if bt2.valid is not None:
                continue
            b2 = torch.where(live, bv2[order], big2)
            ascending = (b2[1:] >= b2[:-1]).all()
            s2, e2 = self._span(op2, b2, pv2, nb)
            start = torch.where(ascending, torch.maximum(start, s2), start)
            end = torch.where(ascending, torch.minimum(end, e2), end)
        count = torch.clamp(end - start, min=0)
        if pt.valid is not None:               # a NULL probe value: no match
            count = torch.where(pt.valid, count, torch.zeros_like(count))
        return start, count, order

    def _execute(self, ctx):
        probe_rel, build_rel = self._inputs(ctx)
        dev = probe_rel.mask.device
        left = self.join_type == "left"
        start, count, order = self._ranges(probe_rel, build_rel)
        cap = getattr(self, "_cap_override", None) or self.out_capacity
        if cap is None:
            factor = (ctx.config.join_expansion_factor
                      if ctx.config is not None else 1.0)
            cap = pad_count(int(probe_rel.capacity * factor))
        slots = torch.arange(probe_rel.capacity, dtype=torch.int32,
                             device=dev)
        entry = torch.where(count > 0, slots, -1)
        out_probe, out_build, total = join_ops.expand_matches(
            start, count, order, entry, probe_rel.mask, cap, left=left)
        ctx.add_check(self, "expansion", total <= cap, cap)
        valid = torch.arange(cap, device=dev) < total
        matched = out_build >= 0
        safe_b = torch.clamp(out_build, 0, build_rel.capacity - 1)
        # residual conditions re-checked on the expanded pairs
        keep = valid & matched
        if len(self.conditions) > 1:
            gp = probe_rel.gather(out_probe, keep, cap)
            gb = build_rel.gather(safe_b, keep, cap)
            for pe2, op2, be2 in self.conditions[1:]:
                pt2, bt2 = gp.evaluate(pe2), gb.evaluate(be2)
                pa, ba, _ = _comparable(pt2, bt2)
                c2 = _cmp_arrays(pa, op2, ba)
                for v in (pt2.valid, bt2.valid):
                    if v is not None:
                        c2 = c2 & v
                keep = keep & c2
        if self.join_type in ("semi", "anti"):
            hit = _scatter_flags(probe_rel.capacity, out_probe.clamp(min=0),
                                 keep)
            m = ~hit if self.join_type == "anti" else hit
            return probe_rel.with_mask(m & probe_rel.mask)
        out_valid = valid if left else keep
        out = probe_rel.gather(out_probe, out_valid, cap)
        cols = dict(out.columns)
        for n, c in build_rel.columns.items():
            out_name = self.build_prefix + n
            if out_name in cols:
                continue
            v = None if c.valid is None else c.valid[safe_b]
            if left:    # unmatched probe rows see NULL build values
                v = matched if v is None else (v & matched)
            cols[out_name] = RelColumn(c.array[safe_b], c.dtype,
                                       c.dictionary, c.domain, v)
        return Relation(cols, out_valid, cap)

    def describe(self):
        conds = [f"{p!r}{op}{b!r}" for p, op, b in self.conditions] or ["x"]
        return f"range_join({self.join_type}, {', '.join(conds)})"

    def _self_signature(self):
        conds = ";".join(f"{p!r}{op}{b!r}" for p, op, b in self.conditions)
        return (f"range_join[{self.join_type};{conds};{self.out_capacity};"
                f"{self.build_prefix};"
                f"ov={getattr(self, '_cap_override', None)}]")


class BroadcastScalar(PhysicalOperator):
    """Attach a 1-row subplan's columns to every row of the child: the
    uncorrelated scalar subquery.  The value, its presence (the subplan's
    row may be absent: an empty input) and its validity stay device tensors,
    broadcast as stride-0 views, so the consuming filter runs with no host
    round trip.  names: {output column name: subplan column name}."""

    name = "broadcast_scalar"

    def __init__(self, child: PhysicalOperator, sub: PhysicalOperator,
                 names: dict[str, str]):
        super().__init__([child, sub])
        self.names = dict(names)

    def is_pipeline_breaker(self):
        return True

    def blocking_children(self):
        return [self.children[1]]

    def _execute(self, ctx):
        # the child's rows stay where they lie; the 1-row subplan is
        # gathered whole
        rel = self.children[0].execute(ctx)
        sub = ctx.replicated(self.children[1].execute(ctx))
        cols = dict(rel.columns)
        present = sub.mask[0]
        for out_name, sub_name in self.names.items():
            c = sub.columns[sub_name]
            valid = present if c.valid is None else (present & c.valid[0])
            cols[out_name] = RelColumn(c.array[0].expand(rel.capacity),
                                       c.dtype, c.dictionary, c.domain,
                                       valid.expand(rel.capacity))
        return Relation(cols, rel.mask, rel.capacity, rel.sharded)

    def _self_signature(self):
        return f"broadcast_scalar[{sorted(self.names.items())}]"

    def describe(self):
        return f"broadcast_scalar({list(self.names)})"


@dataclasses.dataclass
class Aggregate:
    kind: str                 # sum | count | min | max | avg | sum_double
    expr: Expr | None         # None for count(*)
    name: str


class GroupAggregate(PhysicalOperator):
    """Aggregation.

    With no keys, the single-row aggregate, including the fused bitmap-scan
    + SUM kernel path.  With keys: FK-dense grouping when the one key is a
    foreign key with a direct PK index (group ids are the referenced rows),
    the dense mixed-radix path when every key is a dictionary / CHAR1 /
    small-int domain, and sort-based grouping otherwise.
    """

    name = "group_aggregate"

    DEFAULT_DENSE_LIMIT = 1 << 22

    def __init__(self, child: PhysicalOperator, keys: Sequence[str],
                 aggregates: Sequence[Aggregate],
                 carry: Sequence[str] = (),
                 dense_domain_limit: int = DEFAULT_DENSE_LIMIT):
        super().__init__([child])
        self.keys = list(keys)
        self.aggregates = list(aggregates)
        # columns functionally dependent on the keys, carried through the
        # group via a representative row (c_name etc. in Q3/Q10/Q18)
        self.carry = list(carry)
        self.dense_domain_limit = dense_domain_limit

    def is_pipeline_breaker(self):
        return True

    def _self_signature(self):
        aggs = ";".join(f"{a.kind}:{a.name}:{a.expr!r}" for a in self.aggregates)
        kernel = getattr(self, "_kernel", None)
        return (f"group_aggregate[{self.keys};{self.carry};{aggs};"
                f"fk={getattr(self, '_fk_dense', None)};"
                f"kernel={None if kernel is None else kernel[1]}]")

    def prepare(self, ctx: ExecContext):
        super().prepare(ctx)
        # FK-dense grouping: a single key that is a registered foreign key
        # with a direct PK index groups straight into the referenced table's
        # row space
        self._fk_dense = None
        if len(self.keys) == 1:
            fk = ctx.catalog.foreign_keys.get(self.keys[0])
            if fk is not None:
                pk_table, pk_col = fk
                table = ctx.catalog.table(pk_table)
                pk = table.pk_indexes.get(pk_col)
                if pk is not None:
                    # the group ids are the referenced table's global rows
                    self._fk_dense = (pk_table, pk_col,
                                      table.global_capacity)
        self._prepare_kernel(ctx)

    def _execute(self, ctx):
        fused = None if ctx.verify_mode else self._fused_scan_sum(ctx)
        if fused is not None:
            return fused
        rel = self.children[0].execute(ctx)
        if not hasattr(self, "_fk_dense"):
            self.prepare(ctx)
        # unroll-vs-scatter strategy threshold (SET small_group_limit)
        self._small = (ctx.config.small_group_limit
                       if ctx.config is not None else kernels.SMALL_GROUP_LIMIT)
        evaluated = self._evaluate(rel)
        if rel.sharded:
            if self._reducible(ctx, rel, evaluated):
                return self._reduced(ctx, rel, evaluated)
            rel = ctx.replicated(rel)
            evaluated = self._evaluate(rel)
        if not self.keys:
            return self._ungrouped(rel, evaluated)
        return self._grouped(ctx, rel, evaluated)

    def _evaluate(self, rel) -> dict[str, Typed]:
        return {agg.name: rel.evaluate(agg.expr) for agg in self.aggregates
                if agg.expr is not None}

    def _dense_limit(self, ctx) -> int:
        if (ctx.config is not None
                and self.dense_domain_limit == GroupAggregate.DEFAULT_DENSE_LIMIT):
            return ctx.config.dense_domain_limit
        return self.dense_domain_limit

    def _dense_slots(self, ctx, rel):
        """The dense mixed-radix (sizes, codes) of the keys, or (None, None)
        when the grouping is not dense (the single-device path's test)."""
        sizes, codes = self._dense_codes(rel)
        if sizes is None or int(np.prod(sizes)) > self._dense_limit(ctx) \
                or self.carry:
            return None, None
        return sizes, codes

    def _reducible(self, ctx, rel, evaluated) -> bool:
        """Whether a row block's partial aggregates can be reduced over the
        mesh into exactly the single-device answer: group slots the same on
        every rank (no keys, or dense codes of global dictionaries and
        domains; FK-dense and sort-based grouping read representative rows
        of a block), and integer aggregates only (counts, exact split sums,
        MIN / MAX through the int64 encoding; a grouped AVG from its exact
        sum).  A DOUBLE sum, an ungrouped AVG (a float sum) and
        SUM(DOUBLE) are order-dependent: those gather instead."""
        if self.keys:
            if self._fk_dense is not None and not ctx.verify_mode:
                return False
            if self._dense_slots(ctx, rel)[0] is None:
                return False
        for agg in self.aggregates:
            if agg.kind in ("count", "min", "max"):
                continue
            exact = evaluated[agg.name].dtype.id in (
                TypeId.DECIMAL, TypeId.INT32, TypeId.INT64)
            if not exact or agg.kind not in ("sum", "avg") or (
                    agg.kind == "avg" and not self.keys):
                return False
        return True

    def _reduced(self, ctx, rel, evaluated) -> Relation:
        """Partial aggregates of this rank's block over the shared group
        slots, then one `all_reduce` per kind (SUM for counts and the (hi,
        lo) halves of exact sums, MIN, MAX): a replicated result equal to
        the single-device one.  An empty block adds zeros and the
        identities."""
        dev = rel.mask.device
        if self.keys:
            sizes, codes = self._dense_slots(ctx, rel)
            gids, num_groups = groupby_ops.mixed_radix_codes(codes, sizes)
        else:
            gids = torch.zeros(rel.capacity, dtype=torch.int32, device=dev)
            num_groups = 1
        valid, small = rel.mask, self._small
        parts: dict[str, list] = {"sum": [], "min": [], "max": []}

        def part(kind, x):
            parts[kind].append(x.to(torch.int64))
            return kind, len(parts[kind]) - 1

        counts = part("sum", kernels.group_count(gids, valid, num_groups,
                                                 small_limit=small))
        pending = []
        for agg in self.aggregates:
            if agg.kind == "count" and agg.expr is None:
                pending.append((agg, None, counts, (), False))
                continue
            t = evaluated[agg.name]
            arr = _column(t.array, rel.capacity, dev)
            avalid = valid if t.valid is None else (valid & t.valid)
            # without NULLs every live row counts: the row counts serve
            nonnull = counts if t.valid is None else part(
                "sum", kernels.group_count(gids, avalid, num_groups,
                                           small_limit=small))
            refs = ()
            if agg.kind in ("sum", "avg"):
                hi, lo = kernels.group_sum_exact(
                    gids, arr.to(torch.int64), avalid, num_groups,
                    small_limit=small)
                refs = (part("sum", hi), part("sum", lo))
            elif agg.kind in ("min", "max"):
                fn = kernels.group_min if agg.kind == "min" \
                    else kernels.group_max
                fill = _I64_MAX if agg.kind == "min" else _I64_MIN
                refs = (part(agg.kind, fn(gids, kernels.monotone_i64(arr),
                                          avalid, num_groups, fill,
                                          small_limit=small)),)
            pending.append((agg, t, nonnull, refs, arr.is_floating_point()))
        total = {kind: SH.all_reduce(torch.stack(xs), ctx.mesh, kind)
                 for kind, xs in parts.items() if xs}

        def get(ref):
            return total[ref[0]][ref[1]]

        n_rows = get(counts)
        out_cols = self._dense_key_columns(rel, num_groups) \
            if self.keys else {}
        for agg, t, nonnull, refs, floating in pending:
            nonnull = get(nonnull)
            if t is None or agg.kind == "count":
                out_cols[agg.name] = RelColumn(nonnull, INT64, None)
                continue
            out_valid = None if t.valid is None else (nonnull > 0)
            if agg.kind in ("sum", "avg"):
                out_cols[agg.name] = self._exact_sum_column(
                    agg, t, get(refs[0]), get(refs[1]), nonnull, out_valid)
            else:
                r = kernels.monotone_i64_inverse(get(refs[0]), floating)
                out_cols[agg.name] = RelColumn(r, t.dtype, t.dictionary,
                                               valid=out_valid)
        # as `_ungrouped`: without a count, an empty input gives no row
        null_on_empty = all(a.kind != "count" for a in self.aggregates)
        if self.keys or null_on_empty:
            mask = n_rows > 0
        else:
            mask = torch.ones(1, dtype=torch.bool, device=dev)
        return Relation(out_cols, mask, num_groups)

    def _fused_pattern(self, ctx):
        """Host-side check for the fused bitmap-scan + SUM pattern.

        Matches `SUM(col)` / `SUM(a*b)` over a pure index scan (every
        predicate answered by CUBIT bitvectors, mask-based, not provably
        empty).  Returns the host facts the fused paths need, or None.
        Value bounds come from zone maps."""
        if self.keys or len(self.aggregates) != 1:
            return None
        agg = self.aggregates[0]
        if agg.kind != "sum" or agg.expr is None:
            return None
        e = agg.expr
        if isinstance(e, Arith) and e.op == "*" and \
                isinstance(e.left, Col) and isinstance(e.right, Col):
            col_names = [e.left.name, e.right.name]
        elif isinstance(e, Col):
            col_names = [e.name]
        else:
            return None
        child = self.children[0]
        if not isinstance(child, TableScan):
            return None
        if not hasattr(child, "_words"):
            child.prepare(ctx)
        if child._words is None or child.filters or \
                child._decode_cap is not None or \
                getattr(child, "always_false", False):
            return None
        table = ctx.catalog.table(child.table_name)
        # deleted rows: the generic path, which reads the scan's mask (the
        # reference declines too)
        if table.deleted is not None or table.capacity % 8192 != 0:
            return None
        scale = 0
        maxes = []
        nonneg = True
        for cn in col_names:
            c = table.columns.get(cn)
            if c is None or c.dtype.id not in (TypeId.DECIMAL, TypeId.INT32,
                                               TypeId.INT64):
                return None
            if c.zone_map is None:
                return None
            if c.dtype.id == TypeId.DECIMAL:
                scale += c.dtype.scale
            lo = int(c.zone_map.mins.min())
            hi = int(c.zone_map.maxs.max())
            nonneg &= lo >= 0
            maxes.append(max(abs(lo), abs(hi), 1))
        prod_max = 1
        for m in maxes:
            prod_max *= m
        return {"agg": agg, "child": child, "table": table,
                "cols": col_names, "scale": scale, "maxes": maxes,
                "nonneg": nonneg, "prod_max": prod_max}

    def _prepare_kernel(self, ctx):
        """Prepare the fused-scan kernel instance (the reference's
        `_prepare_pallas`): widen narrowed payloads to int32 and, when the
        ranges allow, pack two columns into one int32 stream — once per
        prepared plan: the executor's prepare cache hands the result to
        every later plan with the same signature.  Gated exactly as the
        reference gates its kernel: SET use_pallas, non-negative payloads,
        product bound below 2**31, int32-representable columns, and the
        reference kernel plan's minimum capacity of 2**15 rows."""
        self._kernel = None
        if ctx.config is not None and not ctx.config.use_pallas:
            return
        if ctx.catalog.placement != "default":
            # a catalog on a mesh takes the plain split-sum path per block
            # and reduces it, as the reference's kernel declines there
            return
        info = self._fused_pattern(ctx)
        if info is None or not info["nonneg"] or info["prod_max"] >= 2**31:
            return
        table, cols, maxes = info["table"], info["cols"], info["maxes"]
        if table.capacity < 1 << 15:
            return
        arrays = [table.columns[cn].data for cn in cols]
        arrays = [a.to(torch.int32) if a.dtype in (torch.int8, torch.int16)
                  else a for a in arrays]
        if any(a.dtype != torch.int32 for a in arrays):
            return
        # pack two columns into one int32 stream when ranges allow
        # (wider column low, narrower high)
        packed = None
        if len(cols) == 2:
            wide, narrow = (0, 1) if maxes[0] >= maxes[1] else (1, 0)
            if maxes[wide] < 2**24 and maxes[narrow] < 2**8:
                packed = fs.pack_columns(arrays[wide], arrays[narrow])
        self._kernel = ([packed], True) if packed is not None \
            else (arrays, False)

    def _fused_scan_sum(self, ctx):
        """Fused bitmap-scan + ungrouped SUM — the Q6 hot path.

        Two implementations, picked at prepare time:
         - the fused scan-sum kernel wrapper (`ops/fused_scan.py`): packed
           words + one packed (or one/two plain) int32 payload; the CUDA
           kernel on a CUDA catalog, its plain body on a CPU one;
         - otherwise (SET use_pallas = false, unprovable bounds): the
           expanded mask times the int64 product, with exact split sums.
        """
        if ctx.no_fused:
            return None
        info = self._fused_pattern(ctx)
        if info is None:
            return None
        agg, child, table = info["agg"], info["child"], info["table"]
        col_names, scale = info["cols"], info["scale"]
        if not hasattr(self, "_kernel"):
            self._prepare_kernel(ctx)
        words = child._words
        if self._kernel is not None:
            payloads, packed = self._kernel
            total = fs.fused_scan_sum(words, payloads, packed)
            cnt = bm.popcount(words)
        else:
            mask = bm.expand(words, table.capacity)
            val = table.columns[col_names[0]].data.to(torch.int64)
            for cn in col_names[1:]:
                val = val * table.columns[cn].data.to(torch.int64)
            hi, lo = kernels.masked_sum_exact(val, mask)
            cnt = mask.sum()
            if table.sharded:
                # this rank's block of the table: the halves and the count
                # added over the mesh
                hi, lo, cnt = SH.all_reduce(torch.stack([hi, lo, cnt]),
                                            ctx.mesh)
            total = (hi << 32) + lo
        dt = DataType(TypeId.DECIMAL, scale) if scale else INT64
        out = {agg.name: RelColumn(total.reshape(1), dt, None)}
        # sum over an empty input is NULL -> zero result rows (matches the
        # generic _ungrouped null_on_empty handling)
        return Relation(out, (cnt > 0).reshape(1), 1)

    def _grouped(self, ctx, rel, evaluated):
        """GROUP BY: FK-dense (not in verification's leg 3), dense
        mixed-radix or sort-based group ids, then `_aggregate`."""
        if self._fk_dense is not None and not ctx.verify_mode:
            pk_table, pk_col, num_groups = self._fk_dense
            pkidx = ctx.catalog.table(pk_table).pk_indexes[pk_col]
            slot, in_range = pkidx.slots(rel.columns[self.keys[0]].array)
            gid = pkidx.lut[slot]
            valid = rel.mask & in_range & (gid >= 0)
            gids = torch.clamp(gid, min=0).to(torch.int32)
            if num_groups > self._small:
                # the sorted path finds its own representative rows
                rep = torch.zeros(num_groups, dtype=torch.int32,
                                  device=gids.device)
            else:
                rows = torch.arange(rel.capacity, dtype=torch.int32,
                                    device=gids.device)
                slot = torch.where(valid, gids, torch.full_like(gids,
                                                                num_groups))
                rep = torch.full((num_groups + 1,), -1, dtype=torch.int32,
                                 device=gids.device).scatter_reduce_(
                    0, slot.to(torch.int64), rows, reduce="amax")[:num_groups]
            out_cols, out_mask = self._aggregate(rel, evaluated, gids, valid,
                                                 num_groups, rep)
            return Relation(out_cols, out_mask, num_groups)
        dense_sizes, dense_codes = self._dense_slots(ctx, rel)
        if dense_sizes is not None:
            gids, num_groups = groupby_ops.mixed_radix_codes(dense_codes,
                                                             dense_sizes)
            valid, rep = rel.mask, None
        else:
            # NULL keys form one group: a leading null-flag key per nullable
            # column, with the value zeroed under NULL so garbage payloads
            # do not split the group (SQL GROUP BY NULL-equality)
            key_arrays = []
            for k in self.keys:
                c = rel.columns[k]
                enc = kernels.monotone_i64(c.array)
                if c.valid is not None:
                    key_arrays.append((~c.valid).to(torch.int64))
                    enc = torch.where(c.valid, enc, torch.zeros_like(enc))
                key_arrays.append(enc)
            gk = groupby_ops.group_by_sort(tuple(key_arrays), rel.mask,
                                           rel.capacity)
            gids, valid, num_groups, rep = (
                gk.group_ids, gk.valid, rel.capacity, gk.rep_rows)
        out_cols, out_mask = self._aggregate(rel, evaluated, gids, valid,
                                             num_groups, rep)
        return Relation(out_cols, out_mask, num_groups)

    def _dense_codes(self, rel):
        """Per-key codes in a small known domain, and the domain sizes, or
        (None, None) when some key has none (or may be NULL: NULL is a group
        of its own)."""
        sizes, codes = [], []
        device = rel.mask.device
        for k in self.keys:
            c = rel.columns[k]
            if c.valid is not None:
                return None, None
            if c.dtype.id == TypeId.VARCHAR and c.dictionary is not None:
                sizes.append(len(c.dictionary))
                codes.append(c.array)
            elif c.dtype.id == TypeId.CHAR1 and c.domain is not None:
                # compact byte values to [0, |domain|) via a 256-entry lut
                lut = np.zeros(256, np.int32)
                lut[c.domain] = np.arange(len(c.domain), dtype=np.int32)
                sizes.append(len(c.domain))
                codes.append(torch.as_tensor(lut, device=device)[
                    c.array.to(torch.int64)])
            elif c.dtype.id == TypeId.CHAR1:
                sizes.append(256)
                codes.append(c.array)
            elif c.dtype.id in (TypeId.INT32, TypeId.INT64, TypeId.DATE,
                                TypeId.DECIMAL) and c.domain is not None:
                # small int/date domains: perfect-hash grouping instead of
                # a full sort
                sizes.append(len(c.domain))
                lo = int(c.domain[0])
                if int(c.domain[-1]) - lo + 1 == len(c.domain):
                    codes.append((c.array.to(torch.int64) - lo).to(
                        torch.int32))
                else:
                    codes.append(torch.searchsorted(
                        torch.as_tensor(c.domain, device=device),
                        c.array.to(torch.int64)).to(torch.int32))
            else:
                return None, None
        return sizes, codes

    def _aggregate(self, rel, evaluated, gids, valid, num_groups, rep):
        if num_groups > self._small:
            # large group domains reduce in group-sorted order (sort +
            # cumsum + boundary gathers) instead of scattering
            return self._aggregate_sorted(rel, evaluated, gids, valid,
                                          num_groups, rep)
        counts = kernels.group_count(gids, valid, num_groups,
                                     small_limit=self._small)
        out_cols: dict[str, RelColumn] = {}
        if rep is None:
            out_cols.update(self._dense_key_columns(rel, num_groups))
        else:
            out_cols.update(self._rep_key_columns(rel, rep))
        for agg in self.aggregates:
            out_cols[agg.name] = self._one_agg(agg, rel, evaluated, gids,
                                               valid, num_groups, counts)
        return out_cols, counts > 0

    def _rep_key_columns(self, rel, rep_rows):
        """Key and carried columns read at one representative row per
        group."""
        safe_rep = torch.clamp(rep_rows, 0, rel.capacity - 1)
        out_cols = {}
        for k in list(self.keys) + list(self.carry):
            c = rel.columns[k]
            out_cols[k] = RelColumn(
                c.array[safe_rep], c.dtype, c.dictionary,
                valid=None if c.valid is None else c.valid[safe_rep])
        return out_cols

    def _aggregate_sorted(self, rel, evaluated, gids, valid, num_groups, rep):
        gid_sorted, srows = kernels.sort_by_group(gids, valid)
        start, end = kernels.segment_bounds(gid_sorted, num_groups)
        counts = end - start
        occupied = counts > 0
        out_cols: dict[str, RelColumn] = {}
        if rep is None and self.keys:
            # dense-code grouping: keys rebuilt from code arithmetic
            out_cols.update(self._dense_key_columns(rel, num_groups))
        else:
            safe_start = torch.clamp(start, max=gids.shape[0] - 1)
            rep_rows = torch.where(occupied, srows[safe_start],
                                   torch.zeros_like(start))
            out_cols.update(self._rep_key_columns(rel, rep_rows))
        for agg in self.aggregates:
            out_cols[agg.name] = self._one_agg_sorted(
                agg, rel, evaluated, gids, valid, num_groups, counts,
                srows, start, end)
        return out_cols, occupied

    def _one_agg_sorted(self, agg, rel, evaluated, gids, valid, num_groups,
                        counts, srows, start, end):
        if agg.kind == "count" and agg.expr is None:
            return RelColumn(counts, INT64, None)
        t = evaluated[agg.name]
        arr = _column(t.array, rel.capacity, valid.device)
        avalid = valid if t.valid is None else (valid & t.valid)
        v_sorted = arr[srows]
        avalid_sorted = avalid[srows]
        if t.valid is not None or agg.kind == "count":
            nonnull = kernels.segment_count(avalid_sorted, start, end)
            out_valid = None if t.valid is None else (nonnull > 0)
        else:
            nonnull, out_valid = counts, None
        if agg.kind == "count":
            return RelColumn(nonnull, INT64, None)
        if agg.kind in ("sum", "avg") and t.dtype.id in (
                TypeId.DECIMAL, TypeId.INT32, TypeId.INT64):
            hi, lo = kernels.segment_sum_exact(
                v_sorted.to(torch.int64), avalid_sorted, start, end)
            return self._exact_sum_column(agg, t, hi, lo, nonnull, out_valid)
        if agg.kind in ("sum", "avg", "sum_double"):
            v = torch.where(avalid_sorted, v_sorted.to(torch.float64),
                            torch.zeros((), dtype=torch.float64,
                                        device=v_sorted.device))
            if t.dtype.id == TypeId.DECIMAL:
                v = v / (10.0 ** t.dtype.scale)
            s = kernels._segment_sum_from_cumsum(torch.cumsum(v, 0), start,
                                                 end)
            if agg.kind == "avg":
                s = s / torch.clamp(nonnull, min=1).to(torch.float64)
            return RelColumn(s, DOUBLE, None, valid=out_valid)
        if agg.kind in ("min", "max"):
            # floats go through the monotone int64 encoding so the int64
            # min/max machinery is exact; empty groups get the int64 extremes
            want_max = agg.kind == "max"
            r = kernels.segment_minmax(gids, kernels.monotone_i64(arr),
                                       avalid, num_groups,
                                       _I64_MIN if want_max else _I64_MAX,
                                       want_max=want_max)
            r = kernels.monotone_i64_inverse(r, arr.is_floating_point())
            return RelColumn(r, t.dtype, t.dictionary, valid=out_valid)
        raise ValueError(agg.kind)

    def _dense_key_columns(self, rel, num_groups):
        """Rebuild key values from dense mixed-radix codes (mirrors the size
        and code scheme of `_dense_codes`)."""
        out_cols: dict[str, RelColumn] = {}
        sizes = []
        for k in self.keys:
            c = rel.columns[k]
            if c.dtype.id == TypeId.VARCHAR:
                sizes.append(len(c.dictionary))
            elif c.domain is not None:
                sizes.append(len(c.domain))
            else:
                sizes.append(256)
        rem = torch.arange(num_groups, dtype=torch.int32,
                           device=rel.mask.device)
        for k, size in reversed(list(zip(self.keys, sizes))):
            c = rel.columns[k]
            kv = rem % size
            rem = rem // size
            if c.dtype.id == TypeId.VARCHAR:
                pass
            elif c.domain is not None:
                kv = torch.as_tensor(c.domain, device=kv.device)[kv].to(
                    c.array.dtype)
            else:
                kv = kv.to(torch.uint8)
            out_cols[k] = RelColumn(kv, c.dtype, c.dictionary, c.domain)
        return dict(reversed(list(out_cols.items())))

    def _one_agg(self, agg, rel, evaluated, gids, valid, num_groups, counts):
        if agg.kind == "count" and agg.expr is None:
            return RelColumn(counts, INT64, None)
        t = evaluated[agg.name]
        arr = _column(t.array, rel.capacity, valid.device)
        # NULL semantics: aggregates skip NULL inputs (count(expr) counts
        # only non-NULL; sum/min/max/avg over an all-NULL group are NULL)
        avalid = valid if t.valid is None else (valid & t.valid)
        if t.valid is not None or agg.kind == "count":
            nonnull = kernels.group_count(gids, avalid, num_groups,
                                          small_limit=self._small)
            out_valid = None if t.valid is None else (nonnull > 0)
        else:
            nonnull, out_valid = counts, None
        if agg.kind == "count":
            return RelColumn(nonnull, INT64, None)
        if agg.kind in ("sum", "avg") and t.dtype.id in (
                TypeId.DECIMAL, TypeId.INT32, TypeId.INT64):
            hi, lo = kernels.group_sum_exact(
                gids, arr.to(torch.int64), avalid, num_groups,
                small_limit=self._small)
            return self._exact_sum_column(agg, t, hi, lo, nonnull, out_valid)
        if agg.kind in ("sum", "avg", "sum_double"):
            v = torch.where(avalid, arr.to(torch.float64),
                            torch.zeros((), dtype=torch.float64,
                                        device=arr.device))
            if t.dtype.id == TypeId.DECIMAL:
                v = v / (10.0 ** t.dtype.scale)
            safe = torch.where(avalid, gids, torch.zeros_like(gids))
            s = torch.zeros(num_groups, dtype=torch.float64,
                            device=arr.device).index_add_(
                0, safe.to(torch.int64), v)
            if agg.kind == "avg":
                s = s / torch.clamp(nonnull, min=1).to(torch.float64)
            return RelColumn(s, DOUBLE, None, valid=out_valid)
        if agg.kind in ("min", "max"):
            enc = kernels.monotone_i64(arr)
            if agg.kind == "min":
                r = kernels.group_min(gids, enc, avalid, num_groups, _I64_MAX,
                                      small_limit=self._small)
            else:
                r = kernels.group_max(gids, enc, avalid, num_groups, _I64_MIN,
                                      small_limit=self._small)
            r = kernels.monotone_i64_inverse(r, arr.is_floating_point())
            return RelColumn(r, t.dtype, t.dictionary, valid=out_valid)
        raise ValueError(agg.kind)

    @staticmethod
    def _exact_sum_column(agg, t, hi, lo, nonnull, out_valid) -> RelColumn:
        """A grouped exact sum (or its average) from its (hi, lo) halves."""
        if agg.kind == "sum":
            return RelColumn((hi << 32) + lo,
                             DataType(TypeId.DECIMAL, t.dtype.scale)
                             if t.dtype.id == TypeId.DECIMAL else INT64,
                             None, valid=out_valid)
        scale = 10.0 ** t.dtype.scale if t.dtype.id == TypeId.DECIMAL \
            else 1.0
        avg = (hi.to(torch.float64) * (2.0**32) + lo.to(torch.float64)) \
            / torch.clamp(nonnull, min=1).to(torch.float64) / scale
        return RelColumn(avg, DOUBLE, None, valid=out_valid)

    def _ungrouped(self, rel, evaluated):
        device = rel.mask.device
        out_cols = {}
        for agg in self.aggregates:
            if agg.kind == "count" and agg.expr is None:
                out_cols[agg.name] = RelColumn(
                    rel.mask.to(torch.int64).sum().reshape(1), INT64, None)
                continue
            t = evaluated[agg.name]
            amask = rel.mask if t.valid is None else (rel.mask & t.valid)
            out_valid = None if t.valid is None else amask.any().reshape(1)
            if agg.kind == "count":
                out_cols[agg.name] = RelColumn(
                    amask.to(torch.int64).sum().reshape(1), INT64, None)
            elif agg.kind == "sum" and t.dtype.id in (TypeId.DECIMAL,
                                                      TypeId.INT32,
                                                      TypeId.INT64):
                hi, lo = kernels.masked_sum_exact(
                    _column(t.array, rel.capacity, device).to(torch.int64),
                    amask)
                combined = (hi << 32) + lo
                out_cols[agg.name] = RelColumn(
                    combined.reshape(1), DataType(TypeId.DECIMAL, t.dtype.scale)
                    if t.dtype.id == TypeId.DECIMAL else INT64, None,
                    valid=out_valid)
            elif agg.kind in ("sum", "sum_double", "avg"):
                v = _column(t.array, rel.capacity, device).to(torch.float64)
                v = torch.where(amask, v, torch.zeros_like(v))
                if t.dtype.id == TypeId.DECIMAL:
                    v = v / (10.0 ** t.dtype.scale)
                s = v.sum()
                if agg.kind == "avg":
                    s = s / torch.clamp(amask.sum(), min=1)
                out_cols[agg.name] = RelColumn(s.reshape(1), DOUBLE, None,
                                               valid=out_valid)
            elif agg.kind in ("min", "max"):
                arr = _column(t.array, rel.capacity, device)
                floating = arr.is_floating_point()
                enc = kernels.monotone_i64(arr)
                info = torch.iinfo(torch.int64)
                fill = info.max if agg.kind == "min" else info.min
                v = torch.where(amask, enc, torch.full_like(enc, fill))
                r = v.min() if agg.kind == "min" else v.max()
                r = kernels.monotone_i64_inverse(r, floating)
                out_cols[agg.name] = RelColumn(r.reshape(1), t.dtype,
                                               t.dictionary, valid=out_valid)
            else:
                raise ValueError(agg.kind)
        # sum/avg/min/max over an empty input are NULL; the golden answers
        # render that as zero result rows (count() still yields a row)
        null_on_empty = all(a.kind != "count" for a in self.aggregates)
        out_mask = (rel.mask.any().reshape(1) if null_on_empty
                    else torch.ones(1, dtype=torch.bool, device=device))
        return Relation(out_cols, out_mask, 1)


def _column(arr, capacity: int, device) -> torch.Tensor:
    """An aggregate input as a full column (constants broadcast)."""
    if isinstance(arr, torch.Tensor) and arr.ndim == 1:
        return arr
    return _broadcast(arr, capacity, device)


_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max


class OrderBy(PhysicalOperator):
    """Sort + optional limit (a top-N when the limit is set).

    Keys are total-order encoded: DOUBLEs through the sign-flip bijection
    (`kernels.monotone_i64`), everything else as int64; DESC by bitwise NOT
    (~a = -a-1 is a decreasing bijection on int64, with no overflow at
    INT64_MIN).  NULLs and masked rows are ordered by a separate class
    operand (0 = value, 1 = NULL, 2 = masked row; -1 for NULL under SET
    default_null_order = 'nulls_first') instead of in-band sentinels, so
    keys near the int64 extremes never collide with them.
    """

    name = "order_by"

    def __init__(self, child: PhysicalOperator, keys: Sequence[tuple[str, bool]],
                 limit: int | None = None):
        super().__init__([child])
        self.keys = list(keys)  # (column, descending)
        self.limit = limit

    def is_pipeline_breaker(self):
        return True

    def _execute(self, ctx):
        rel, = self._inputs(ctx)
        nulls_first = (ctx.config is not None and
                       ctx.config.default_null_order == "nulls_first")
        operands = []
        for name, desc in self.keys:
            c = rel.columns[name]
            if c.dtype.id == TypeId.DOUBLE:
                a = kernels.monotone_i64(c.array)
            else:
                a = c.array.to(torch.int64)
            cls = torch.where(rel.mask, 0, 2).to(torch.int8)
            if c.valid is not None:
                cls = torch.where(rel.mask & ~c.valid,
                                  -1 if nulls_first else 1, cls).to(torch.int8)
                # NULLs are equal: the payload under a NULL (whatever the
                # join gathered there) must not order them; the next key
                # does.  The reference keeps the payload (ROADMAP queue 3)
                a = torch.where(c.valid, a, torch.zeros_like(a))
            operands += [cls, ~a if desc else a]
        perm = kernels.lexsort(operands)
        total = rel.mask.to(torch.int64).sum()
        cap = rel.capacity if self.limit is None else min(
            pad_count(self.limit), rel.capacity)
        limit = total if self.limit is None else torch.clamp(total,
                                                             max=self.limit)
        valid = torch.arange(cap, device=perm.device) < limit
        return rel.gather(perm[:cap], valid, cap)

    def _self_signature(self):
        return f"order_by[{self.keys};{self.limit}]"


class Limit(PhysicalOperator):
    name = "limit"

    def __init__(self, child: PhysicalOperator, limit: int):
        super().__init__([child])
        self.limit = limit

    def _execute(self, ctx):
        rel, = self._inputs(ctx)
        keep = rel.mask & (torch.cumsum(rel.mask.to(torch.int64), 0)
                           <= self.limit)
        return rel.with_mask(keep)

    def _self_signature(self):
        return f"limit[{self.limit}]"


@dataclasses.dataclass
class WindowFunc:
    kind: str                 # row_number|rank|dense_rank|lead|lag|
    #                           first_value|last_value|sum|avg|min|max|
    #                           count|total
    expr: Expr | None         # value expression (None: row_number/count(*))
    name: str                 # output column
    offset: int = 1           # lead/lag distance
    default: object = None    # lead/lag default (None -> NULL)
    # frame: a legacy string (rows_upto | range_upto | partition) or a
    # sliding tuple (mode, lo, hi), mode in {"rows", "range"}, lo/hi int
    # offsets with None = UNBOUNDED (ops/window.py frame_bounds).  None ->
    # range_upto with ORDER BY, else the whole partition.
    frame: object | None = None


class Window(PhysicalOperator):
    """Window functions over partitions: one shared sort per window
    (`ops/window.analyze`), then each function's segmented prefix
    primitive.  The output keeps the input's rows and mask."""

    name = "window"

    def __init__(self, child: PhysicalOperator,
                 partition_by: Sequence[str],
                 order_by: Sequence[tuple[str, bool]],
                 functions: Sequence[WindowFunc]):
        super().__init__([child])
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.functions = list(functions)

    def is_pipeline_breaker(self):
        return True

    def _key_arrays(self, rel):
        """Sort keys: float keys through the monotone int64 encoding, DESC
        as bitwise NOT (a decreasing bijection with no overflow), and a
        leading NULL-flag key for a nullable column (NULLs form one
        partition and sort last)."""
        def keys(name, desc):
            c = rel.columns[name]
            enc = kernels.monotone_i64(c.array)
            if desc:
                enc = ~enc
            if c.valid is None:
                return [enc]
            return [(~c.valid).to(torch.int64),
                    torch.where(c.valid, enc, torch.zeros_like(enc))]

        parts = [a for k in self.partition_by for a in keys(k, False)]
        orders = [a for k, desc in self.order_by for a in keys(k, desc)]
        return tuple(parts), tuple(orders)

    def _frame(self, f: WindowFunc, rel, order_enc):
        """The function's frame, degenerate tuples normalized to the legacy
        running forms; a RANGE offset frame is checked."""
        frame = f.frame or ("range_upto" if self.order_by else "partition")
        if not isinstance(frame, tuple):
            return frame
        mode, flo, fhi = frame
        if flo is None and fhi is None:
            return "partition"
        if flo is None and fhi == 0:
            return "rows_upto" if mode == "rows" else "range_upto"
        if mode == "range":
            if order_enc is None:
                raise ValueError(
                    "RANGE offset frame requires exactly one ORDER BY key")
            oc = rel.columns[self.order_by[0][0]]
            if oc.dtype.id not in (TypeId.INT32, TypeId.INT64, TypeId.DATE,
                                   TypeId.DECIMAL):
                raise ValueError(
                    "RANGE offset frame requires an integer-ordered key")
            # DESC needs no offset flip: the ~ encoding is affine with slope
            # -1, so "m PRECEDING" is m encoded units below the current key
        return frame

    def _execute(self, ctx):
        from ..ops import window as W

        rel, = self._inputs(ctx)
        dev = rel.mask.device
        parts, orders = self._key_arrays(rel)
        wctx = W.analyze(parts, orders, rel.mask)
        # RANGE sliding frames need the single order key in sorted order
        order_enc = wctx.take(orders[0]) if len(orders) == 1 else None
        cols = dict(rel.columns)
        for f in self.functions:
            frame = self._frame(f, rel, order_enc)
            if f.kind in ("row_number", "rank", "dense_rank"):
                fn = getattr(W, f.kind)
                cols[f.name] = RelColumn(fn(wctx), INT64, None)
                continue
            if f.kind == "count" and f.expr is None:
                out, _ = W.agg(wctx, "count", None, None, frame,
                               order_enc=order_enc)
                cols[f.name] = RelColumn(out, INT64, None)
                continue
            t = rel.evaluate(f.expr)
            arr = _column(t.array, rel.capacity, dev)
            if f.kind in ("lead", "lag"):
                off = f.offset if f.kind == "lead" else -f.offset
                out, ok = W.shift(wctx, arr, t.valid, off, f.default)
                cols[f.name] = RelColumn(out, t.dtype, t.dictionary,
                                         valid=ok)
            elif f.kind in ("first_value", "last_value"):
                ab = W.frame_bounds(wctx, frame, order_enc)
                if ab is not None:
                    out, ok = W.first_last_sliding(
                        wctx, arr, t.valid, ab, last=f.kind == "last_value")
                    cols[f.name] = RelColumn(out, t.dtype, t.dictionary,
                                             valid=ok)
                elif f.kind == "first_value":
                    cols[f.name] = RelColumn(W.first_value(wctx, arr),
                                             t.dtype, t.dictionary)
                else:
                    cols[f.name] = RelColumn(
                        W.last_value(wctx, arr, frame=frame), t.dtype,
                        t.dictionary)
            elif f.kind in ("sum", "total", "avg", "min", "max", "count"):
                cols[f.name] = self._aggregate(W, wctx, f, t, arr, frame,
                                               order_enc)
            else:
                raise ValueError(f.kind)
        return Relation(cols, rel.mask, rel.capacity)

    @staticmethod
    def _aggregate(W, wctx, f, t, arr, frame, order_enc) -> RelColumn:
        kind = "sum" if f.kind == "total" else f.kind
        if f.kind == "total":
            frame = "partition"
        if kind in ("sum", "avg"):
            if arr.is_floating_point():
                kind = "sum_double" if kind == "sum" else "avg"
            else:
                arr = arr.to(torch.int64)
        out, ok = W.agg(wctx, kind, arr, t.valid, frame, order_enc=order_enc)
        if kind == "avg":
            dt = DOUBLE
            if t.dtype.id == TypeId.DECIMAL:
                out = out / 10.0 ** t.dtype.scale
        elif f.kind == "count":
            dt = INT64
        elif t.dtype.id == TypeId.DECIMAL or kind in ("min", "max"):
            dt = t.dtype
        else:
            dt = DOUBLE if out.is_floating_point() else INT64
        return RelColumn(out, dt, t.dictionary if kind in ("min", "max")
                         else None, valid=ok)

    def _self_signature(self):
        fs = ";".join(f"{f.kind}:{f.name}:{f.expr!r}:{f.offset}:"
                      f"{f.default}:{f.frame}" for f in self.functions)
        return f"window[{self.partition_by};{self.order_by};{fs}]"

    def describe(self):
        return (f"window(partition={self.partition_by}, order={self.order_by},"
                f" funcs={[f.kind for f in self.functions]})")


class AsofJoin(PhysicalOperator):
    """ASOF join: each probe row matches AT MOST ONE build row, the one with
    the greatest build time <= the probe time (op '>=', the canonical form;
    '>' strict, and '<=' / '<' by negating both sides) among the rows with
    equal equi-keys.

    The build side is sorted once by (equi-key, time); keys and times are
    rank-encoded into one int64, so each probe row finds its candidate with
    one vectorized searchsorted, and a gather re-checks the key columns
    exactly.  The probe's shape is kept (single match): 'inner' narrows the
    mask on a miss, 'left' NULL-extends the build columns.

    probe_keys / build_keys: equi-key column names; probe_time op
    build_time: the int-typed time condition.
    """

    name = "asof_join"

    def __init__(self, probe, build, probe_keys, build_keys,
                 probe_time: Expr, op: str, build_time: Expr,
                 join_type: str = "inner", build_prefix: str = ""):
        super().__init__([probe, build])
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.probe_time = probe_time
        self.op = op
        self.build_time = build_time
        if join_type not in ("inner", "left"):
            raise ValueError("ASOF join supports inner/left")
        self.join_type = join_type
        self.build_prefix = build_prefix

    def is_pipeline_breaker(self):
        return True

    def blocking_children(self):
        return [self.children[1]]

    def _execute(self, ctx):
        probe_rel, build_rel = self._inputs(ctx)
        dev = probe_rel.mask.device
        pt = probe_rel.evaluate(self.probe_time)
        bt = build_rel.evaluate(self.build_time)
        ptv = kernels.monotone_i64(_column(pt.array, probe_rel.capacity, dev))
        btv = kernels.monotone_i64(_column(bt.array, build_rel.capacity, dev))
        op = self.op
        if op in ("<=", "<"):          # probe_t <= build_t: negate the times
            ptv, btv = -ptv, -btv
            op = ">=" if op == "<=" else ">"
        if op == ">":                  # strict: t_b <= t_p - 1 (int times)
            ptv = ptv - 1
        pkey = _combine_keys(ctx, probe_rel, self.probe_keys) \
            if self.probe_keys else torch.zeros(
                probe_rel.capacity, dtype=torch.int64, device=dev)
        bkey = _combine_keys(ctx, build_rel, self.build_keys) \
            if self.build_keys else torch.zeros(
                build_rel.capacity, dtype=torch.int64, device=dev)
        bvalid = build_rel.mask
        if bt.valid is not None:
            bvalid = bvalid & bt.valid
        bcap = build_rel.capacity
        perm = kernels.lexsort(((~bvalid).to(torch.int64), bkey, btv))
        sk, st = bkey[perm], btv[perm]
        nb = bvalid.to(torch.int64).sum()
        big = torch.iinfo(torch.int64).max
        in_prefix = torch.arange(bcap, device=dev) < nb
        sk_valid = torch.where(in_prefix, sk, big)   # the valid prefix only
        st_valid = torch.where(in_prefix, st, big)
        # rank-encode keys and times so the composite (key, time) fits one
        # int64 whatever the raw ranges: rank(x) = #values <= x is monotone,
        # and probe times rank with right=True, so st <= ptv <=> rank(st) <=
        # rank(ptv) exactly
        ts = torch.sort(st_valid)[0]
        krb = torch.searchsorted(sk_valid, sk)
        rtb = torch.searchsorted(ts, st, right=True)
        krp = torch.searchsorted(sk_valid, pkey)
        rtp = torch.searchsorted(ts, ptv, right=True)
        enc_b = torch.where(in_prefix, (krb << 32) + rtb, big)
        enc_p = (krp << 32) + rtp
        pos = torch.searchsorted(enc_b, enc_p, right=True) - 1
        safe = torch.clamp(pos, 0, bcap - 1)
        # the candidate must carry the probe's key (otherwise the search fell
        # into the previous key's run: no time <= ptv for this key)
        found = (pos >= 0) & (sk_valid[safe] == pkey) & probe_rel.mask
        build_row = torch.where(found, perm[safe], -1)
        if pt.valid is not None:
            found = found & pt.valid
        if self.probe_keys:
            # the exact key re-check through the matched rows
            probe_rows = torch.arange(probe_rel.capacity, device=dev)
            found = _exact_key_eq(probe_rel, build_rel, self.probe_keys,
                                  self.build_keys, probe_rows,
                                  torch.clamp(build_row, min=0), found)
        left = self.join_type == "left"
        safe_b = torch.clamp(build_row, 0, bcap - 1)
        cols = dict(probe_rel.columns)
        for n, c in build_rel.columns.items():
            out_name = self.build_prefix + n
            if out_name in cols:
                continue
            v = None if c.valid is None else c.valid[safe_b]
            if left:
                v = found if v is None else (v & found)
            cols[out_name] = RelColumn(c.array[safe_b], c.dtype,
                                       c.dictionary, c.domain, v)
        mask = probe_rel.mask if left else (probe_rel.mask & found)
        return Relation(cols, mask, probe_rel.capacity)

    def _self_signature(self):
        return (f"asof_join[{self.join_type};{self.probe_keys};"
                f"{self.build_keys};{self.probe_time!r}{self.op}"
                f"{self.build_time!r};{self.build_prefix}]")

    def describe(self):
        return (f"asof_join({self.join_type}, {self.probe_keys}="
                f"{self.build_keys}, {self.op})")


class Materialized(PhysicalOperator):
    """Placeholder for a relation the executor injects into `ctx._cache`
    (the out-of-core merge pass); run without one, it raises."""

    name = "materialized"

    def _execute(self, ctx):
        raise RuntimeError("materialized input was not injected")


class MarkJoin(PhysicalOperator):
    """Subquery mark join: EXISTS / IN with residual correlated predicates.

    The probe relation keeps its shape, and each probe row gets a mark:
    whether any build row matches the equi keys AND satisfies the residual.
    The residual may read probe columns (by name) and build columns (under
    `build_prefix`); it is evaluated over the expanded (probe row, build
    row) pairs of `ops/join.py` at a static capacity, whose undershoot is
    the recoverable `expansion` check (the executor doubles the capacity
    and runs again).  A scatter-any brings the pairs' verdicts back to probe
    rows.  Output: the probe masked by the mark (negated for NOT EXISTS),
    or, with `mark_column`, the mark as a BOOL column (for OR / CASE).
    """

    name = "mark_join"

    def __init__(self, probe: PhysicalOperator, build: PhysicalOperator,
                 probe_keys: Sequence[str], build_keys: Sequence[str],
                 residual: Expr | None = None, negated: bool = False,
                 build_prefix: str = "__mark_",
                 out_capacity: int | None = None,
                 mark_column: str | None = None):
        super().__init__([probe, build])
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.residual = residual
        self.negated = negated
        self.build_prefix = build_prefix
        self.out_capacity = out_capacity
        self.mark_column = mark_column

    def is_pipeline_breaker(self):
        return True

    def blocking_children(self):
        return [self.children[1]]

    def _execute(self, ctx):
        probe_rel, build_rel = self._inputs(ctx)
        bkey = _combine_keys(ctx, build_rel, self.build_keys)
        pkey = _combine_keys(ctx, probe_rel, self.probe_keys)
        bs = join_ops.build(bkey, build_rel.mask)
        entry = join_ops.probe(bs, pkey, probe_rel.mask)
        cap = getattr(self, "_cap_override", None) or self.out_capacity
        if cap is None:
            factor = (ctx.config.join_expansion_factor
                      if ctx.config is not None else 1.0)
            cap = pad_count(int(probe_rel.capacity * factor))
        out_probe, out_build, total = join_ops.expand_matches(
            bs.starts, bs.counts, bs.sorted_rows, entry, probe_rel.mask, cap)
        ctx.add_check(self, "expansion", total <= cap, cap)
        ok = (torch.arange(cap, device=entry.device) < total) & \
            (out_probe >= 0)
        if len(self.probe_keys) > 2:
            ok = _exact_key_eq(probe_rel, build_rel, self.probe_keys,
                               self.build_keys, out_probe, out_build, ok)
        if self.residual is not None:
            ok = ok & as_mask(self._pairs(probe_rel, build_rel, out_probe,
                                          out_build, ok, cap).evaluate(
                                              self.residual))
        mark = _scatter_flags(probe_rel.capacity, out_probe.clamp(min=0), ok)
        if self.negated:
            mark = ~mark
        if self.mark_column is not None:
            cols = dict(probe_rel.columns)
            cols[self.mark_column] = RelColumn(mark, BOOL, None)
            return Relation(cols, probe_rel.mask, probe_rel.capacity)
        return probe_rel.with_mask(probe_rel.mask & mark)

    def _pairs(self, probe_rel, build_rel, out_probe, out_build, ok, cap):
        """The residual's columns gathered at the expanded pairs: probe
        columns by name, build columns under `build_prefix` (row ids
        clamped, as the padding slots hold -1)."""
        needed = _expr_columns(self.residual)
        safe_p = torch.clamp(out_probe, 0, probe_rel.capacity - 1)
        safe_b = torch.clamp(out_build, 0, build_rel.capacity - 1)
        cols: dict[str, RelColumn] = {}
        for prefix, rel, safe in (("", probe_rel, safe_p),
                                  (self.build_prefix, build_rel, safe_b)):
            for n, c in rel.columns.items():
                if prefix + n in needed:
                    cols[prefix + n] = RelColumn(
                        c.array[safe], c.dtype, c.dictionary, c.domain,
                        None if c.valid is None else c.valid[safe])
        return Relation(cols, ok, cap)

    def _self_signature(self):
        return (f"mark_join[{self.probe_keys};{self.build_keys};"
                f"{self.residual!r};neg={self.negated};{self.out_capacity};"
                f"{self.build_prefix};mc={self.mark_column};"
                f"ov={getattr(self, '_cap_override', None)}]")

    def describe(self):
        kind = "not_exists" if self.negated else "exists"
        return (f"mark_join({kind}, {self.probe_keys}={self.build_keys},"
                f" residual={self.residual is not None})")
