"""Physical operators.

Counterpart of `duckdb_cubit_tpu/plan/physical.py`.  Every operator consumes
and produces a `Relation` — named device tensors plus a validity mask — and
keeps its input's capacity wherever it can, narrowing the mask instead of
moving rows.  Ported so far: TableScan (CUBIT index words, the decode-vs-mask
decision, row-id decode), Filter, Project, GroupAggregate (ungrouped, with
the fused bitmap-scan + SUM kernel of `ops/fused_scan.py`; dense mixed-radix,
FK-dense and sort-based grouping), HashJoin's direct-address PK path (the
probe and the build-value fetch through the monotone gather kernel of
`ops/probe.py`), OrderBy and Limit.  Operators and join paths that later
slices port exist by name for the shared binder and optimizer, and raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..ops import bitmap as bm
from ..ops import fused_scan as fs
from ..ops import groupby as groupby_ops
from ..ops import kernels
from ..ops import probe as PPK
from ..ops.expressions import (Arith, Col, ColMeta, EvalContext, Expr,
                               Typed, as_mask)
from ..storage.table import Table, pad_count
from ..types import BOOL, DOUBLE, INT64, DataType, TypeId


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
        # deferred runtime assertions (name, 0-d bool tensor), read by the
        # executor after the run
        self.checks: list[tuple[str, object]] = []
        # id(op) -> the op's position in plan.walk(), so a failed check
        # names the operator the executor's retry flips
        self.check_tags: dict[int, int] = {}
        # id(op) -> its output, so a subtree shared by two parents runs once
        self._cache: dict[int, Relation] = {}

    def add_check(self, op, kind: str, ok):
        """Attach a deferred runtime assertion.  `kind` in {"pkprobe",
        "unique"} is recoverable: the executor flips the operator to its
        plain path and runs the query again (exec/executor.py)."""
        tag = self.check_tags.get(id(op), -1)
        self.checks.append((f"{kind}#{tag}", ok))


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


class _NotPorted(PhysicalOperator):
    """An operator the binder can emit but this port does not run yet:
    constructing it raises, so a query that needs it fails by name."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{type(self).__name__}: not ported yet")


class RangeJoin(_NotPorted): name = "range_join"
class AsofJoin(_NotPorted): name = "asof_join"
class MarkJoin(_NotPorted): name = "mark_join"
class BroadcastScalar(_NotPorted): name = "broadcast_scalar"
class Window(_NotPorted): name = "window"
class Materialized(_NotPorted): name = "materialized"
class RangeSource(_NotPorted): name = "range_source"
class SingleRow(_NotPorted): name = "single_row"


class WindowFunc:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("WindowFunc: not ported yet")


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
        return Relation(cols, rel.mask, rel.capacity)

    def _self_signature(self):
        return (f"project[{ {n: repr(e) for n, e in self.exprs.items()} };"
                f"keep={self.keep_input}]")


class HashJoin(PhysicalOperator):
    """Equi-join.  This slice ports the direct-address PK-FK path: a
    single-column key whose build side stays aligned to a base table with a
    dense PK index.  `single_match=True` keeps the probe relation's shape
    and gathers build columns through the matched row (no expansion, the
    mask narrows on a miss).  Sorted probe keys go through the monotone
    gather kernel (`ops/probe.py`), which fetches the row and the build
    values from key-space value luts in one pass.  The general hash build,
    the reverse-PK semi join and the expansion path come with ROADMAP queue
    1 item 9 and raise.

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
        super().prepare(ctx)
        # direct-address PK join eligibility: single-column key against a
        # mask-aligned base-table relation that has a dense PK index
        self._pk = None
        self._reverse_pk = None
        if len(self.build_keys) == 1:
            base = static_base_table(self.children[1])
            if base is not None:
                table = ctx.catalog.table(base)
                pk = table.pk_indexes.get(self.build_keys[0])
                if pk is not None:
                    self._pk = (base, self.build_keys[0], pk.max_key)
                    self._vlut_cols = self._pick_vlut_cols(table)
        if (self._pk is None and self.join_type in ("semi", "anti")
                and len(self.probe_keys) == 1):
            # reverse semi join: the PROBE side owns the PK
            base = static_base_table(self.children[0])
            if base is not None:
                table = ctx.catalog.table(base)
                pk = table.pk_indexes.get(self.probe_keys[0])
                if pk is not None:
                    self._reverse_pk = (base, self.probe_keys[0], pk.max_key)

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
        """-> (build row or -1, found, the kernel's clipped int32 keys or
        None when the plain lut path ran, {column: its build values fetched
        through its value lut by the same kernel pass}).  `value_cols` are
        the columns to fetch on the kernel path."""
        base, col, max_key = self._pk
        table = ctx.catalog.table(base)
        pkidx = table.pk_indexes[col]
        kcol = probe_rel.columns[self.probe_keys[0]]
        if not self._kernel_probe_eligible(kcol, probe_rel, max_key,
                                           build_rel):
            row, found = pkidx.probe(kcol.array, probe_rel.mask,
                                     build_rel.mask)
            return row, found, None, {}
        # build-side liveness folds into the lut with one scatter, so the
        # probe and every value fetch are a single kernel pass; an overflow
        # (a key that breaks the sorted, in-range precondition) is a
        # recoverable deferred check: the executor sets _no_kernel_probe and
        # runs the query again
        k = kcol.array.to(torch.int64)
        in_range = (k >= 0) & (k <= max_key) & probe_rel.mask
        bk = build_rel.columns[self.build_keys[0]].array.to(torch.int64)
        tgt = torch.where(build_rel.mask, torch.clamp(bk, 0, max_key),
                          torch.full_like(bk, max_key + 1))
        alive_slots = torch.zeros(max_key + 2, dtype=torch.bool,
                                  device=bk.device)
        alive_slots[tgt] = True
        lut_eff = torch.where(alive_slots[: max_key + 1], pkidx.lut,
                              torch.full_like(pkidx.lut, -1))
        # value luts are built once on the host and cached on the index
        vluts = []
        for n in value_cols:
            bc = table.columns[n]
            vluts.append(pkidx.device_value_lut(
                n, bc.host if bc.host is not None else bc.data.cpu().numpy()))
        kc = torch.clamp(k, 0, max_key).to(torch.int32)
        outs, ovf = PPK.monotone_gather_many([lut_eff, *vluts], kc)
        ctx.add_check(self, "pkprobe", ovf == 0)
        row = outs[0]
        found = in_range & (row >= 0)
        return (torch.where(found, row, torch.full_like(row, -1)), found, kc,
                dict(zip(value_cols, outs[1:])))

    def _value_fetches(self, probe_rel, build_rel) -> list[str]:
        """Build columns the single-match gather takes from value luts: each
        eligible column the join reads and outputs, without NULLs."""
        return [n for n in self._vlut_cols
                if n in build_rel.columns
                and build_rel.columns[n].valid is None
                and self.build_prefix + n not in probe_rel.columns]

    def _kernel_probe_eligible(self, kcol, probe_rel, max_key,
                               build_rel) -> bool:
        """Host gate of the kernel probe: sorted base-aligned probe keys
        (the array is the full storage column, so key density matches
        storage density), no NULL keys, and the kernel's size gate."""
        if getattr(self, "_no_kernel_probe", False):
            return False
        if not kcol.monotone or max_key + 1 >= 2**31:
            return False
        if kcol.valid is not None:
            return False
        if self.build_keys[0] not in build_rel.columns:
            return False
        return PPK.plan_monotone_gather(probe_rel.capacity, max_key + 1)

    def _execute(self, ctx):
        probe_rel = self.children[0].execute(ctx)
        build_rel = self.children[1].execute(ctx)
        if not hasattr(self, "_pk"):
            self.prepare(ctx)
        if self._pk is not None and (
                self.single_match or self.join_type in ("semi", "anti")):
            if self.join_type in ("semi", "anti"):
                found = self._pk_probe(ctx, probe_rel, build_rel)[1]
                m = ~found if self.join_type == "anti" else found
                return probe_rel.with_mask(m & probe_rel.mask)
            build_row, found, kc, values = self._pk_probe(
                ctx, probe_rel, build_rel,
                self._value_fetches(probe_rel, build_rel))
            return self._gather_single(probe_rel, build_rel, build_row,
                                       found, kc, values)
        path = "reverse-PK semi join" if self._reverse_pk is not None \
            else "hash build and expansion"
        raise NotImplementedError(
            f"HashJoin {path}: not ported yet (ROADMAP queue 1 item 9)")

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
        return Relation(cols, mask, probe_rel.capacity)

    def describe(self):
        return (f"hash_join({self.join_type}, {self.probe_keys}={self.build_keys},"
                f" single={self.single_match})")

    def _self_signature(self):
        # includes the kernel switch, so a retry after an overflow is a new
        # prepare-cache entry and never the stale one
        return (f"hash_join[{self.join_type};{self.probe_keys};{self.build_keys};"
                f"{self.single_match};{self.out_capacity};{self.build_prefix};"
                f"fc={self.found_column};"
                f"pk={getattr(self, '_pk', None)};"
                f"rpk={getattr(self, '_reverse_pk', None)};"
                f"fe={getattr(self, '_force_expand', False)};"
                f"nkp={getattr(self, '_no_kernel_probe', False)}]")


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
                    self._fk_dense = (pk_table, pk_col, pk.max_key,
                                      table.capacity)
        self._prepare_kernel(ctx)

    def _execute(self, ctx):
        fused = self._fused_scan_sum(ctx)
        if fused is not None:
            return fused
        rel = self.children[0].execute(ctx)
        if not hasattr(self, "_fk_dense"):
            self.prepare(ctx)
        # unroll-vs-scatter strategy threshold (SET small_group_limit)
        self._small = (ctx.config.small_group_limit
                       if ctx.config is not None else kernels.SMALL_GROUP_LIMIT)
        evaluated: dict[str, Typed] = {}
        for agg in self.aggregates:
            if agg.expr is not None:
                evaluated[agg.name] = rel.evaluate(agg.expr)
        if not self.keys:
            return self._ungrouped(rel, evaluated)
        return self._grouped(ctx, rel, evaluated)

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
        prepared plan: the executor's prepare cache hands the result to
        every later plan with the same signature.  Gated exactly as the
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

    def _grouped(self, ctx, rel, evaluated):
        """GROUP BY: FK-dense, dense mixed-radix or sort-based group ids,
        then `_aggregate`."""
        if self._fk_dense is not None:
            pk_table, pk_col, max_key, num_groups = self._fk_dense
            lut = ctx.catalog.table(pk_table).pk_indexes[pk_col].lut
            key = rel.columns[self.keys[0]].array.to(torch.int64)
            in_range = (key >= 0) & (key <= max_key)
            gid = lut[torch.clamp(key, 0, max_key)]
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
        dense_sizes, dense_codes = self._dense_codes(rel)
        dense_limit = self.dense_domain_limit
        if (ctx.config is not None
                and dense_limit == GroupAggregate.DEFAULT_DENSE_LIMIT):
            dense_limit = ctx.config.dense_domain_limit
        if dense_sizes is not None and int(np.prod(dense_sizes)) <= \
                dense_limit and not self.carry:
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
        rel = self.children[0].execute(ctx)
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
        rel = self.children[0].execute(ctx)
        keep = rel.mask & (torch.cumsum(rel.mask.to(torch.int64), 0)
                           <= self.limit)
        return rel.with_mask(keep)

    def _self_signature(self):
        return f"limit[{self.limit}]"
