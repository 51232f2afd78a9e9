"""Physical operators.

Counterpart of `duckdb_cubit_tpu/plan/physical.py`.  Every operator consumes
and produces a `Relation` — named device tensors plus a validity mask — and
keeps its input's capacity wherever it can, narrowing the mask instead of
moving rows.  This module ports the operators of a single-table SELECT with
an ungrouped aggregate: TableScan (CUBIT index words, the decode-vs-mask
decision, row-id decode), Filter, Project, and GroupAggregate without keys,
including the fused bitmap-scan + SUM path that runs the hand-written CUDA
kernel (`ops/fused_scan.py`).  Operators that later slices port exist by
name for the shared binder and optimizer, and raise NotImplementedError when
constructed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..ops import bitmap as bm
from ..ops import fused_scan as fs
from ..ops import kernels
from ..ops.expressions import (Arith, Col, ColMeta, EvalContext, Expr,
                               Typed, as_mask)
from ..storage.table import Table, pad_count
from ..types import DOUBLE, INT64, DataType, TypeId


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
    """A batch of named columns + validity mask (the inter-operator format)."""
    columns: dict[str, RelColumn]
    mask: torch.Tensor
    capacity: int

    def eval_ctx(self) -> EvalContext:
        arrays = {n: c.array for n, c in self.columns.items()}
        meta = {n: ColMeta(c.dtype, c.dictionary) for n, c in self.columns.items()}
        valids = {n: c.valid for n, c in self.columns.items()
                  if c.valid is not None}
        return EvalContext(arrays, meta, valids)

    def count(self) -> int:
        """Live rows (a device -> host sync)."""
        return int(self.mask.sum())

    def evaluate(self, expr: Expr) -> Typed:
        return expr.eval(self.eval_ctx())

    def with_mask(self, mask) -> "Relation":
        return Relation(self.columns, mask, self.capacity)

    def gather(self, indices: torch.Tensor, valid: torch.Tensor,
               capacity: int) -> "Relation":
        safe = torch.clamp(indices, 0, self.capacity - 1)
        cols = {
            n: RelColumn(c.array[safe], c.dtype, c.dictionary, c.domain,
                         None if c.valid is None else c.valid[safe])
            for n, c in self.columns.items()
        }
        return Relation(cols, valid, capacity)


class ExecContext:
    def __init__(self, catalog, config=None):
        self.catalog = catalog
        self.config = config
        # id(op) -> its output, so a subtree shared by two parents runs once
        self._cache: dict[int, Relation] = {}


class PhysicalOperator:
    """Base physical operator; `children` gives the pipeline structure."""

    name = "physical_op"

    def __init__(self, children: Sequence["PhysicalOperator"] = ()):
        self.children = list(children)

    def execute(self, ctx: ExecContext) -> Relation:
        key = id(self)
        if key not in ctx._cache:
            ctx._cache[key] = self._execute(ctx)
        return ctx._cache[key]

    def _execute(self, ctx: ExecContext) -> Relation:
        raise NotImplementedError

    # pipeline-breaker protocol (build sides finish before probes run)
    def is_pipeline_breaker(self) -> bool:
        return False

    def blocking_children(self) -> list["PhysicalOperator"]:
        return []

    def describe(self) -> str:
        return self.name

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


class _NotPorted(PhysicalOperator):
    """An operator the binder can emit but this port does not run yet:
    constructing it raises, so a query that needs it fails by name."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{type(self).__name__}: not ported yet")


class HashJoin(_NotPorted): name = "hash_join"
class RangeJoin(_NotPorted): name = "range_join"
class AsofJoin(_NotPorted): name = "asof_join"
class MarkJoin(_NotPorted): name = "mark_join"
class OrderBy(_NotPorted): name = "order_by"
class Limit(_NotPorted): name = "limit"
class BroadcastScalar(_NotPorted): name = "broadcast_scalar"
class Window(_NotPorted): name = "window"
class Materialized(_NotPorted): name = "materialized"
class RangeSource(_NotPorted): name = "range_source"
class SingleRow(_NotPorted): name = "single_row"


class WindowFunc:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("WindowFunc: not ported yet")


def static_base_table(op: PhysicalOperator) -> str | None:
    """Which base table's row space an operator's output stays aligned to
    (mask-preserving operators keep the base table's capacity and order)."""
    if isinstance(op, TableScan):
        return None if getattr(op, "_decode_cap", None) is not None \
            else op.table_name
    if isinstance(op, (Filter, Project)):
        return static_base_table(op.children[0])
    return None


def relation_from_table(table: Table) -> Relation:
    cols = {
        n: RelColumn(c.data, c.dtype, c.dictionary, c.domain)
        for n, c in table.columns.items()
    }
    return Relation(cols, table.row_mask(), table.capacity)


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
        if self._words is not None and not self.filters:
            n_rows = table.num_rows
            bound = self._index_count_bound(table)
            limit = max(max_count, int(n_rows * threshold))
            if bound is not None and bound <= limit and bound < n_rows // 2:
                cap = pad_count(bound)
                if cap < table.capacity:
                    self._decode_cap = cap

    def _execute(self, ctx: ExecContext) -> Relation:
        table = ctx.catalog.table(self.table_name)
        if not hasattr(self, "_words"):
            self.prepare(ctx)
        capacity = table.capacity
        names = self.needed_columns(table)
        rel = Relation(
            {n: RelColumn(table.columns[n].data, table.columns[n].dtype,
                          table.columns[n].dictionary,
                          table.columns[n].domain,
                          valid=None if table.columns[n].nulls is None
                          else ~table.columns[n].nulls,
                          monotone=table.columns[n].is_sorted)
             for n in names},
            table.row_mask(),
            capacity)
        if getattr(self, "always_false", False):
            # statistics propagation proved the filters unsatisfiable
            return rel.with_mask(torch.zeros(capacity, dtype=torch.bool,
                                             device=table.device))
        mask = rel.mask
        if self._words is not None:
            mask = mask & bm.expand(self._words, capacity)
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


class Filter(PhysicalOperator):
    """Streaming filter: narrows the mask."""

    name = "filter"

    def __init__(self, child: PhysicalOperator, expr: Expr):
        super().__init__([child])
        self.expr = expr

    def _execute(self, ctx):
        rel = self.children[0].execute(ctx)
        return rel.with_mask(rel.mask & as_mask(rel.evaluate(self.expr)))


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
        return Relation(cols, rel.mask, rel.capacity)


@dataclasses.dataclass
class Aggregate:
    kind: str                 # sum | count | min | max | avg | sum_double
    expr: Expr | None         # None for count(*)
    name: str


class GroupAggregate(PhysicalOperator):
    """Aggregation.  This slice ports the ungrouped single-row aggregate
    (no keys), including the fused bitmap-scan + SUM kernel path; grouped
    aggregation comes with the next slice and raises here."""

    name = "group_aggregate"

    DEFAULT_DENSE_LIMIT = 1 << 22

    def __init__(self, child: PhysicalOperator, keys: Sequence[str],
                 aggregates: Sequence[Aggregate],
                 carry: Sequence[str] = (),
                 dense_domain_limit: int = DEFAULT_DENSE_LIMIT):
        # `carry` and `dense_domain_limit` only shape grouped aggregation
        if keys:
            raise NotImplementedError(
                "GroupAggregate with GROUP BY keys: not ported yet")
        super().__init__([child])
        self.aggregates = list(aggregates)

    def is_pipeline_breaker(self):
        return True

    def _execute(self, ctx):
        fused = self._fused_scan_sum(ctx)
        if fused is not None:
            return fused
        rel = self.children[0].execute(ctx)
        evaluated: dict[str, Typed] = {}
        for agg in self.aggregates:
            if agg.expr is not None:
                evaluated[agg.name] = rel.evaluate(agg.expr)
        return self._ungrouped(rel, evaluated)

    def _fused_pattern(self, ctx):
        """Host-side check for the fused bitmap-scan + SUM pattern.

        Matches `SUM(col)` / `SUM(a*b)` over a pure index scan (every
        predicate answered by CUBIT bitvectors, mask-based, not provably
        empty).  Returns the host facts the fused paths need, or None.
        Value bounds come from zone maps."""
        if len(self.aggregates) != 1:
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
        if table.capacity % 8192 != 0:
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
        plan object.  `conn.sql` binds a new plan per query and the port has
        no prepare cache yet (the reference's `Executor._prepare_cache`), so
        each query repeats this work on the device.  Gated exactly as the
        reference gates its kernel: SET use_pallas, non-negative payloads,
        product bound below 2**31, int32-representable columns, and the
        reference kernel plan's minimum capacity of 2**15 rows."""
        self._kernel = None
        if ctx.config is not None and not ctx.config.use_pallas:
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
            total = (hi << 32) + lo
            cnt = mask.sum()
        dt = DataType(TypeId.DECIMAL, scale) if scale else INT64
        out = {agg.name: RelColumn(total.reshape(1), dt, None)}
        # sum over an empty input is NULL -> zero result rows (matches the
        # generic _ungrouped null_on_empty handling)
        return Relation(out, (cnt > 0).reshape(1), 1)

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
