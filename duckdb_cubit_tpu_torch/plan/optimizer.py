"""Plan optimizer passes.

Analog of the reference Optimizer (reference src/optimizer/optimizer.cpp:102
pass list).  Round-1 passes:

 - **filter pushdown**: Filter nodes directly above a TableScan merge their
   conjuncts into the scan (reference FilterPushdown);
 - **index matching**: scan conjuncts of the forms col <op> literal /
   BETWEEN / IN-list are resolved against the table's CUBIT indexes when the
   bin ranges answer them exactly; matched conjuncts move to the scan's
   index_filters (the analog of TableScanPushdownComplexFilter asking each
   index TryInitializeScan, reference table_scan.cpp:296-370), the rest stay
   as residual vectorized predicates evaluated through the bitmap mask.
"""

from __future__ import annotations

import numpy as np

from ..ops import expressions as E
from ..types import TypeId
from . import physical as P


def split_conjuncts(expr: E.Expr) -> list[E.Expr]:
    if isinstance(expr, E.BoolOp) and expr.op == "and":
        return split_conjuncts(expr.left) + split_conjuncts(expr.right)
    return [expr]


def _literal_device_value(lit: E.Lit, col_dtype, dictionary):
    """Convert a literal to the column's device representation, or None."""
    v = lit.value
    dt = lit.dtype
    if isinstance(v, str):
        return None  # handled separately for dict columns
    if col_dtype.id == TypeId.DECIMAL:
        scale = col_dtype.scale
        lscale = dt.scale if (dt and dt.id == TypeId.DECIMAL) else 0
        if dt and dt.id == TypeId.DECIMAL:
            if lscale == scale:
                return int(v)
            if lscale < scale:
                return int(v) * 10 ** (scale - lscale)
            return None
        if isinstance(v, int):
            return int(v) * 10**scale
        return None
    if isinstance(v, (int, np.integer)):
        return int(v)
    return None


def _match_conjunct(conj: E.Expr, table):
    """-> (column, kind, payload) or None.

    kinds: ('cmp', op, value) for range composition; ('eq', value);
    ('isin', [bins]).
    """
    if isinstance(conj, E.Compare):
        left, right, op = conj.left, conj.right, conj.op
        if isinstance(right, E.Col) and isinstance(left, E.Lit):
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                    "==": "==", "!=": "!="}
            left, right, op = right, left, flip[op]
        if not (isinstance(left, E.Col) and isinstance(right, E.Lit)):
            return None
        c = table.columns.get(left.name)
        if c is not None and getattr(c, "nulls", None) is not None:
            # NULL-bearing column: bitmap bins cover the placeholder
            # values, so index answers would include NULL rows —
            # evaluate as a residual expression (validity-aware)
            return None
        col_name = left.name
        if col_name not in table.indexes:
            return None
        col = table.columns[col_name]
        lit = right
        if isinstance(lit.value, str):
            from ..types import TypeId
            if col.dtype.id == TypeId.CHAR1 and len(lit.value) == 1:
                if op != "==":
                    return None
                return (col_name, "cmp", ("==", ord(lit.value)))
            if col.dictionary is None or op != "==":
                return None
            b = lit.value.encode()
            pos = int(np.searchsorted(col.dictionary, b))
            if pos >= len(col.dictionary) or col.dictionary[pos] != b:
                return (col_name, "empty", None)
            return (col_name, "cmp", ("==", pos))
        v = _literal_device_value(lit, col.dtype, col.dictionary)
        if v is None or op == "!=":
            return None
        return (col_name, "cmp", (op, v))
    if isinstance(conj, E.InList):
        if not isinstance(conj.child, E.Col):
            return None
        col_name = conj.child.name
        if col_name not in table.indexes:
            return None
        col = table.columns[col_name]
        idx = table.indexes[col_name]
        bins = []
        for v in conj.values:
            if isinstance(v, str):
                if col.dictionary is None:
                    return None
                b = v.encode()
                pos = int(np.searchsorted(col.dictionary, b))
                if pos < len(col.dictionary) and col.dictionary[pos] == b:
                    bins.append(pos)
            else:
                dv = _literal_device_value(E.Lit(v), col.dtype, col.dictionary)
                if dv is None:
                    return None
                if idx.bin_edges is not None:
                    blo, bhi, refine = idx.range_bins(dv, dv)
                    if refine or blo != bhi:
                        return None
                    bins.append(blo)
                else:
                    bins.append(int(dv))
        return (col_name, "isin", sorted(set(bins)))
    return None


def match_index_filters(scan: P.TableScan, table) -> None:
    """Split scan.filters into index_filters + residual filters, in place.

    Idempotent: plans are DAGs (shared subtrees, e.g. Q17's join feeding
    both the aggregate and the re-probe), so a scan may be visited twice.
    """
    if getattr(scan, "_index_matched", False):
        return
    scan._index_matched = True
    conjuncts = []
    for f in scan.filters:
        conjuncts.extend(split_conjuncts(f))
    residual = []
    # per-column accumulated range bounds
    ranges: dict[str, dict] = {}
    matched: list[tuple] = []
    matched_conjs: dict[str, list] = {}
    for conj in conjuncts:
        m = _match_conjunct(conj, table)
        if m is None:
            residual.append(conj)
            continue
        col_name, kind, payload = m
        if kind == "empty":
            scan.index_filters = [(col_name, "isin", ([],))]
            scan.filters = []
            return
        if kind == "isin":
            matched.append((col_name, "isin", (payload,)))
            continue
        op, v = payload
        r = ranges.setdefault(col_name, {"lo": None, "hi": None,
                                         "lo_inc": True, "hi_inc": True})
        matched_conjs.setdefault(col_name, []).append(conj)
        if op == "==":
            r["lo"], r["hi"] = v, v
        elif op in (">", ">="):
            inc = op == ">="
            eff = v if inc else v + 1
            if r["lo"] is None or eff > r["lo"]:
                r["lo"] = eff
        elif op in ("<", "<="):
            inc = op == "<="
            eff = v if inc else v - 1
            if r["hi"] is None or eff < r["hi"]:
                r["hi"] = eff
    for col_name, r in ranges.items():
        idx = table.indexes[col_name]
        blo, bhi, refine = idx.range_bins(r["lo"], r["hi"])
        if refine:
            # not exactly answerable: keep the original conjuncts
            residual.extend(matched_conjs[col_name])
            continue
        matched.append((col_name, "range", (r["lo"], r["hi"])))
    scan.index_filters = matched
    scan.filters = residual


def push_filters(op: P.PhysicalOperator,
                 seen: dict | None = None) -> P.PhysicalOperator:
    """Merge Filter nodes into their child TableScan where possible.

    DAG-safe: shared subtrees are rewritten once (memoized by identity).
    """
    if seen is None:
        seen = {}
    if id(op) in seen:
        return seen[id(op)]
    op.children = [push_filters(c, seen) for c in op.children]
    out = op
    if isinstance(op, P.Filter) and isinstance(op.children[0], P.TableScan):
        scan = op.children[0]
        scan.filters = scan.filters + split_conjuncts(op.expr)
        out = scan
    seen[id(op)] = out
    return out


def _stats_bounds(table, col_name):
    """Global (min, max) from the column's zone map, or None."""
    c = table.columns.get(col_name)
    if c is None or c.zone_map is None:
        return None
    return int(c.zone_map.mins.min()), int(c.zone_map.maxs.max())


def _classify_vs_bounds(op: str, v: int, lo: int, hi: int) -> str:
    """'always' | 'never' | 'maybe' for `col op v` given col in [lo, hi]."""
    table = {
        "<":  (hi < v,  lo >= v),
        "<=": (hi <= v, lo > v),
        ">":  (lo > v,  hi <= v),
        ">=": (lo >= v, hi < v),
        "==": (lo == hi == v, v < lo or v > hi),
        "!=": (v < lo or v > hi, lo == hi == v),
    }
    always, never = table[op]
    return "always" if always else ("never" if never else "maybe")


def propagate_statistics(scan: P.TableScan, table) -> None:
    """Zone-map statistics propagation over pushed scan conjuncts, in place.

    The analog of the reference's StatisticsPropagator constant-folding
    (src/optimizer/statistics_propagator.cpp via optimizer.cpp:102) backed by
    the same per-block min/max statistics the scan's zone-map skip uses
    (row_group.cpp:407 CheckZonemapSegments): conjuncts proven true by the
    column's global bounds are dropped; a conjunct proven false marks the
    whole scan empty (`always_false`, consumed by TableScan._execute).
    """
    kept = []
    for conj in [c for f in scan.filters for c in split_conjuncts(f)]:
        verdict = "maybe"
        if isinstance(conj, E.Compare):
            left, right, op = conj.left, conj.right, conj.op
            if isinstance(right, E.Col) and isinstance(left, E.Lit):
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                        "==": "==", "!=": "!="}
                left, right, op = right, left, flip[op]
            if isinstance(left, E.Col) and isinstance(right, E.Lit):
                bounds = _stats_bounds(table, left.name)
                v = None if bounds is None else _literal_device_value(
                    right, table.columns[left.name].dtype,
                    table.columns[left.name].dictionary)
                if bounds is not None and v is not None:
                    verdict = _classify_vs_bounds(op, v, *bounds)
                    if verdict == "always" and getattr(
                            table.columns[left.name], "nulls",
                            None) is not None:
                        # provably true for every NON-NULL value, but NULL
                        # rows still compare UNKNOWN: keep the conjunct
                        verdict = "maybe"
        if verdict == "never":
            scan.always_false = True
            scan.filters = []
            scan.index_filters = []
            return
        if verdict != "always":
            kept.append(conj)
    scan.filters = kept


def optimize(plan: P.PhysicalOperator, catalog) -> P.PhysicalOperator:
    plan = push_filters(plan)
    seen = set()

    def walk(op):
        if id(op) in seen:
            return
        seen.add(id(op))
        for c in op.children:
            walk(c)
        if isinstance(op, P.TableScan):
            table = catalog.table(op.table_name)
            propagate_statistics(op, table)
            if table.indexes and not getattr(op, "always_false", False):
                match_index_filters(op, table)

    walk(plan)
    return plan
