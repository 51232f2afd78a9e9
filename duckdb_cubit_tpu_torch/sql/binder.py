"""SQL binder: resolve parsed SELECTs against the catalog into plans.

Analog of the reference's Binder/Planner (reference src/planner/: name
resolution, type inference, subquery flattening/decorrelation, building the
logical operator tree).  Round-2 scope covers the full reference TPC-H
q01..q22 SQL surface:

 - multi-table FROM with comma joins and [LEFT] JOIN .. ON;
 - derived tables (subqueries in FROM) with optional column aliases,
   including repeated instances of the same base table (nation n1/n2,
   lineitem l1/l2/l3) disambiguated by join build prefixes;
 - WHERE conjunct classification into per-source pushed filters, equi-join
   edges, and post-join filters, with common-factor extraction out of OR
   (the reference optimizer's OR factoring, q19's join key inside OR arms);
 - subquery predicates:
     * uncorrelated scalar  -> BroadcastScalar + Filter (stays on device,
       the analog of the reference flattening into a one-row cross product);
     * correlated scalar    -> grouped-aggregate rewrite + single-match left
       join + Filter (classic magic-set decorrelation; reference
       src/planner/subquery flattening into delim joins);
     * [NOT] EXISTS         -> semi/anti join on the correlated equality
       keys; residual correlated predicates (q21's l2.l_suppkey <>
       l1.l_suppkey) go through MarkJoin (expansion + residual + any-reduce);
     * [NOT] IN (SELECT)    -> semi/anti join (mark join when correlated);
 - grouped aggregation with aggregate-expression items (sum(x)/sum(y),
   0.2*avg(x)), GROUP BY aliases/expressions, HAVING (with uncorrelated
   scalar subqueries), count(DISTINCT col), SELECT DISTINCT;
 - ORDER BY output names / LIMIT.

Join-order: greedy largest-source-first over the equi-edge graph (the
reference uses DP join ordering, src/optimizer/join_order/; greedy is enough
for TPC-H shapes and keeps probe sides wide for the single-match fast path).
Build sides join as `single_match` only when the build keys cover a unique
key set (PK or group keys); otherwise the general expansion join runs with a
capacity bound derived from uniqueness of the probe keys where provable.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..ops import expressions as E
from ..plan import physical as P
from ..storage.table import pad_count
from ..types import DataType, TypeId, date_to_days
from . import aggregates as port_aggs
from . import ast as A
from .parser import parse

_CMPS = ("==", "!=", "<", "<=", ">", ">=")
_AGG_FUNCS = ("sum", "avg", "min", "max", "count")
# statistical aggregates lowered to sum/sum-of-squares/count arithmetic
# (reference src/core_functions/aggregate/distributive/stddev.cpp)
_STAT_AGGS = ("stddev", "stddev_samp", "stddev_pop",
              "variance", "var_samp", "var_pop")


class BindError(ValueError):
    pass


@dataclasses.dataclass
class Source:
    """One FROM entry: a base table or a bound derived table."""
    alias: str
    table_name: str | None               # None for derived tables
    sub: "Bound | None"
    cols: list[str]
    size: int
    unique_sets: list                    # list[frozenset[str]] (logical names)
    join_type: str = "inner"
    join_cond: Any = None
    prefix: str = ""                     # set during join-tree construction
    filters: list = dataclasses.field(default_factory=list)  # AST conjuncts


@dataclasses.dataclass
class Bound:
    """A bound SELECT: plan + output schema metadata."""
    plan: P.PhysicalOperator
    out_names: list[str]
    unique_sets: list
    size: int


class Scope:
    """Name resolution over the FROM sources, chained to an outer scope for
    correlated-subquery analysis (innermost wins, SQL scoping rules)."""

    def __init__(self, sources: list[Source], outer: "Scope | None" = None):
        self.sources = list(sources)
        self.outer = outer
        self.by_alias = {s.alias: s for s in self.sources}
        self.by_name: dict[str, list[Source]] = {}
        for s in self.sources:
            for c in s.cols:
                self.by_name.setdefault(c, []).append(s)

    def find_local(self, ref: A.ColumnRef) -> Source | None:
        if ref.table is not None:
            s = self.by_alias.get(ref.table)
            if s is None or ref.name not in s.cols:
                return None
            return s
        owners = self.by_name.get(ref.name, [])
        if len(owners) > 1:
            raise BindError(f"ambiguous column {ref.name}")
        return owners[0] if owners else None

    def resolve(self, ref: A.ColumnRef):
        """-> (source, depth) through the outer chain, or (None, -1)."""
        sc, depth = self, 0
        while sc is not None:
            s = sc.find_local(ref)
            if s is not None:
                return s, depth
            sc, depth = sc.outer, depth + 1
        return None, -1

    def physical(self, ref: A.ColumnRef) -> str:
        s = self.find_local(ref)
        if s is None:
            q = f"{ref.table}." if ref.table else ""
            raise BindError(f"cannot resolve column {q}{ref.name}")
        return s.prefix + ref.name


# --------------------------------------------------------------- AST helpers

def _split_and(node) -> list:
    if node is None:
        return []
    if isinstance(node, A.BinaryOp) and node.op == "and":
        return _split_and(node.left) + _split_and(node.right)
    return [node]


def _and_all(conjs: list):
    out = None
    for c in conjs:
        out = c if out is None else A.BinaryOp("and", out, c)
    return out


def _factor_or(node):
    """Extract conjuncts common to every OR branch (reference optimizer OR
    factoring; q19 keeps its join key inside each OR arm)."""
    if not (isinstance(node, A.BinaryOp) and node.op == "or"):
        return [node]

    def branches(n):
        if isinstance(n, A.BinaryOp) and n.op == "or":
            return branches(n.left) + branches(n.right)
        return [_split_and(n)]

    brs = branches(node)
    common = [c for c in brs[0] if all(c in b for b in brs[1:])]
    if not common:
        return [node]
    rest_branches = []
    for b in brs:
        rest = [c for c in b if c not in common]
        rest_branches.append(_and_all(rest) or A.Literal(True))
    out = list(common)
    rest_or = rest_branches[0]
    for rb in rest_branches[1:]:
        rest_or = A.BinaryOp("or", rest_or, rb)
    out.append(rest_or)
    return out


def _walk_ast(node, fn, into_selects: bool):
    """Generic AST walk; optionally descends into nested SelectStmt nodes."""
    if node is None:
        return
    fn(node)
    if isinstance(node, A.SelectStmt):
        if not into_selects:
            return
        for it in node.items:
            _walk_ast(it.expr, fn, into_selects)
        for t in node.tables:
            if t.subquery is not None:
                _walk_ast(t.subquery, fn, into_selects)
            _walk_ast(getattr(t, "join_cond", None), fn, into_selects)
        _walk_ast(node.where, fn, into_selects)
        for g in node.group_by:
            _walk_ast(g, fn, into_selects)
        _walk_ast(node.having, fn, into_selects)
        for oi in node.order_by:
            _walk_ast(oi.expr, fn, into_selects)
        return
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if dataclasses.is_dataclass(v):
                _walk_ast(v, fn, into_selects)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if dataclasses.is_dataclass(x):
                        _walk_ast(x, fn, into_selects)
                    elif isinstance(x, (list, tuple)):
                        # CaseExpr.whens holds (cond, result) pairs
                        for y in x:
                            if dataclasses.is_dataclass(y):
                                _walk_ast(y, fn, into_selects)


def _collect_colrefs(stmt) -> set:
    """All (qualifier|None, name) pairs anywhere in the statement tree
    (including nested subqueries: correlated refs count toward the outer
    table's scan projection)."""
    out = set()

    def fn(n):
        if isinstance(n, A.ColumnRef):
            out.add((n.table, n.name))

    _walk_ast(stmt, fn, into_selects=True)
    return out


def _contains_subquery(node) -> bool:
    found = [False]

    def fn(n):
        if isinstance(n, (A.SubqueryExpr, A.ExistsExpr)):
            found[0] = True
        if isinstance(n, A.InExpr) and isinstance(n.values, A.SelectStmt):
            found[0] = True

    _walk_ast(node, fn, into_selects=False)
    return found[0]


def _has_aggregate(node) -> bool:
    """Aggregate calls at THIS query level (stops at subquery boundaries)."""
    if node is None:
        return False
    if isinstance(node, (A.SubqueryExpr, A.ExistsExpr, A.SelectStmt)):
        return False
    if isinstance(node, A.InExpr):
        return _has_aggregate(node.expr)
    # port-only {
    if isinstance(node, A.FuncCall) and node.name in port_aggs.NAMES:
        return True
    # port-only }
    if isinstance(node, A.FuncCall) and (node.name in _AGG_FUNCS
                                         or node.name in _STAT_AGGS):
        return True
    if isinstance(node, A.WindowExpr):
        return False  # window functions are not aggregates
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if dataclasses.is_dataclass(v) and _has_aggregate(v):
                return True
            if isinstance(v, (list, tuple)) and any(
                    dataclasses.is_dataclass(x) and _has_aggregate(x)
                    for x in v):
                return True
    return False


def _colrefs_of(node) -> list:
    refs = []

    def fn(n):
        if isinstance(n, A.ColumnRef):
            refs.append(n)

    _walk_ast(node, fn, into_selects=False)
    return refs


def _default_name(expr, i: int) -> str:
    if isinstance(expr, A.ColumnRef):
        return expr.name
    return f"col{i}"


def _fold_date_arith(node: A.BinaryOp):
    """date '1998-12-01' - interval '90' day -> folded date literal."""
    if node.op not in ("+", "-"):
        return None
    l, r = node.left, node.right
    if isinstance(l, A.CastExpr) and l.target == "date" \
            and isinstance(l.child, A.Literal):
        l = A.Literal(l.child.value, "date")
    if isinstance(l, A.Literal) and l.type_hint == "date" \
            and isinstance(r, A.IntervalLit):
        import datetime

        base = datetime.date.fromisoformat(l.value)
        sign = 1 if node.op == "+" else -1
        if r.unit == "day":
            out = base + datetime.timedelta(days=sign * r.value)
        elif r.unit == "month":
            m = base.month - 1 + sign * r.value
            out = base.replace(year=base.year + m // 12, month=m % 12 + 1)
        elif r.unit == "year":
            out = base.replace(year=base.year + sign * r.value)
        else:
            return None
        return E.date_lit(out.isoformat())
    return None


def _dec_lit_norm(value) -> E.Lit:
    """Decimal literal with trailing fraction zeros stripped (keeps int64
    fixed-point arithmetic in range: 0.0001000000 -> scale 4, not 10)."""
    s = str(value)
    if "." in s:
        frac = s.split(".")[1].rstrip("0")
        scale = max(len(frac), 1)
    else:
        scale = 0
    if scale == 0:
        return E.Lit(int(float(s)))
    return E.dec_lit(round(float(s), scale), scale)


def _fold_const_ast(v):
    """Host-fold a constant AST expression (literals + - * / and unary
    minus) to a python value; None when not constant."""
    if isinstance(v, A.UnaryOp) and v.op == "-":
        inner = _fold_const_ast(v.child)
        return None if inner is None else -inner
    if isinstance(v, A.Literal):
        if isinstance(v.value, (int, float, str)) \
                and not isinstance(v.value, bool):
            return v.value
        return None
    if isinstance(v, A.BinaryOp) and v.op in "+-*/":
        l, r = _fold_const_ast(v.left), _fold_const_ast(v.right)
        if l is None or r is None or isinstance(l, str) \
                or isinstance(r, str):
            return None
        if v.op == "+":
            return l + r
        if v.op == "-":
            return l - r
        if v.op == "*":
            return l * r
        return l / r if r else None
    return None


def _make_cmp(op: str, l: E.Expr, r: E.Expr) -> E.Expr:
    return {"==": lambda: l == r, "!=": lambda: l != r,
            "<": lambda: l < r, "<=": lambda: l <= r,
            ">": lambda: l > r, ">=": lambda: l >= r}[op]()


class Binder:
    def __init__(self, catalog, executor=None):
        self.catalog = catalog
        self.executor = executor
        self._gen_counter = 0

    def _gen(self, tag: str) -> str:
        self._gen_counter += 1
        return f"__{tag}{self._gen_counter}"

    # ------------------------------------------------------------ entry
    def bind(self, stmt: A.SelectStmt) -> P.PhysicalOperator:
        # gensym names are deterministic per statement so the same SQL text
        # always binds to the same plan signature — load-bearing for the
        # executor's compiled-plan cache (a drifting counter re-keys the jit
        # on every call and forces a compile-cache round trip per query)
        self._gen_counter = 0
        return self._bind_select(stmt, None).plan

    def bind_sql(self, sql: str) -> P.PhysicalOperator:
        return self.bind(parse(sql))

    def bind_table_expr(self, table_name: str, node) -> E.Expr:
        """Bind an expression against a single table (DML WHERE/SET)."""
        table = self.catalog.table(table_name)
        src = Source(table_name, table_name, None, list(table.columns),
                     table.num_rows, [])
        return self.to_expr(node, Scope([src]))

    # ----------------------------------------------------------- SELECT
    def _bind_select(self, stmt: A.SelectStmt,
                     outer: Scope | None) -> Bound:
        pushed = 0
        if getattr(stmt, "ctes", None):
            # non-recursive WITH: each CTE is a named derived table,
            # visible to later CTEs and the main query (inlined per
            # reference; no materialization sharing)
            if not hasattr(self, "_ctes"):
                self._ctes = {}
            for name, cols, sub in stmt.ctes:
                self._ctes[name] = (cols, sub)
                pushed += 1
        try:
            return self._bind_select_inner(stmt, outer)
        finally:
            if pushed:
                for name, _, _ in stmt.ctes:
                    self._ctes.pop(name, None)

    def _bind_select_inner(self, stmt: A.SelectStmt,
                           outer: Scope | None) -> Bound:
        if not stmt.tables:
            return self._bind_fromless(stmt, outer)
        refs = _collect_colrefs(stmt)
        sources = self._bind_sources(stmt)
        scope = Scope(sources, outer)
        edges, post, sub_preds, range_edges = self._classify(stmt, scope)
        plan, cur_size, cur_unique, leftover = self._build_tree(
            scope, edges, refs, range_edges)
        post = leftover + post
        for conj in post:
            plan = P.Filter(plan, self.to_expr(conj, scope))
        for conj in sub_preds:
            plan = self._apply_subquery_pred(plan, conj, scope)
        return self._bind_output(stmt, plan, scope, cur_size)

    def _bind_fromless(self, stmt: A.SelectStmt, outer) -> Bound:
        """SELECT <exprs> with no FROM: a one-row dummy source (the
        reference's PhysicalDummyScan / ExpressionExecutor constant path).
        """
        scope = Scope([], outer)
        plan: P.PhysicalOperator = P.SingleRow()
        if stmt.where is not None:
            plan = P.Filter(plan, self.to_expr(stmt.where, scope))
        return self._bind_output(stmt, plan, scope, 1)

    def _bind_table_function(self, ref, jt, cond) -> Source:
        """range(stop) / range(start, stop[, step]) (reference
        src/function/table/range.cpp)."""
        if ref.name.lower() not in ("range", "generate_series"):
            raise BindError(f"unknown table function {ref.name}")
        vals = []
        for a in ref.func_args:
            v = _fold_const_ast(a)
            if not isinstance(v, int):
                raise BindError("range() arguments must be constant "
                                "integers")
            vals.append(v)
        if len(vals) == 1:
            start, stop, step = 0, vals[0], 1
        elif len(vals) == 2:
            start, stop, step = vals[0], vals[1], 1
        elif len(vals) == 3:
            start, stop, step = vals
        else:
            raise BindError("range() takes 1-3 arguments")
        if ref.name.lower() == "generate_series" and len(vals) >= 2:
            stop = stop + (1 if step > 0 else -1)   # inclusive stop
        coln = (ref.column_aliases[0] if ref.column_aliases
                else "range")
        plan = P.RangeSource(start, stop, step, coln)
        alias = ref.alias or self._gen("rf")
        n = plan.n
        return Source(alias, None,
                      Bound(plan, [coln], [frozenset({coln})], n),
                      [coln], n, [frozenset({coln})], jt, cond)

    # ------------------------------------------------------------- FROM
    def _bind_sources(self, stmt) -> list[Source]:
        sources = []
        for ref in stmt.tables:
            jt = getattr(ref, "join_type", "inner")
            cond = getattr(ref, "join_cond", None)
            if getattr(ref, "func_args", None) is not None:
                sources.append(self._bind_table_function(ref, jt, cond))
                continue
            cte = getattr(self, "_ctes", {}).get(ref.name) \
                if ref.subquery is None else None
            if cte is not None:
                cols, sub = cte
                import dataclasses as _dc
                ref = _dc.replace(ref, subquery=sub, name="",
                                  alias=ref.alias or ref.name,
                                  column_aliases=ref.column_aliases or cols)
            if ref.subquery is not None:
                b = self._bind_select(ref.subquery, None)
                alias = ref.alias or self._gen("dt")
                out_names = list(b.out_names)
                unique_sets = list(b.unique_sets)
                plan = b.plan
                if ref.column_aliases:
                    if len(ref.column_aliases) != len(out_names):
                        raise BindError(
                            f"derived table {alias}: {len(ref.column_aliases)}"
                            f" aliases for {len(out_names)} columns")
                    ren = dict(zip(out_names, ref.column_aliases))
                    plan = P.Project(plan, {ren[n]: n for n in out_names})
                    unique_sets = [frozenset(ren[c] for c in us)
                                   for us in unique_sets]
                    out_names = list(ref.column_aliases)
                sub = Bound(plan, out_names, unique_sets, b.size)
                sources.append(Source(alias, None, sub, out_names, b.size,
                                      unique_sets, jt, cond))
            else:
                if ref.name not in self.catalog.tables:
                    raise BindError(f"unknown table {ref.name}")
                table = self.catalog.table(ref.name)
                unique_sets = [frozenset({k}) for k in table.pk_indexes]
                unique_sets += [frozenset(ks) for ks in
                                getattr(table, "unique_keys", [])]
                sources.append(Source(
                    ref.alias or ref.name, ref.name, None,
                    list(table.columns.keys()), table.num_rows,
                    unique_sets, jt, cond))
        # RIGHT JOIN normalizes to LEFT with sides swapped (the reference
        # planner does the same side flip, src/planner/binder/tableref):
        # `A RIGHT JOIN B ON c` == `B LEFT JOIN A ON c`
        for s in sources:
            if s.join_type == "right":
                if len(sources) != 2:
                    raise BindError(
                        "RIGHT JOIN is supported for two-table FROM "
                        "(rewrite as LEFT JOIN)")
                other = next(o for o in sources if o is not s)
                if other.join_type != "inner":
                    raise BindError("cannot mix RIGHT JOIN with other joins")
                other.join_type = "left"
                other.join_cond = s.join_cond
                s.join_type = "inner"
                s.join_cond = None
        return sources

    # ---------------------------------------------- WHERE classification
    def _classify(self, stmt, scope: Scope):
        """Split WHERE + ON conjuncts into per-source filters (in place on
        the sources), equi-join edges, post-join filters, and subquery
        predicates.  The analog of the reference's filter pushdown +
        join-edge extraction (src/optimizer/filter_pushdown)."""
        conjs = []
        for c in _split_and(stmt.where):
            conjs.extend(_factor_or(c))
        for s in scope.sources:
            if s.join_cond is None:
                continue
            on = []
            for c in _split_and(s.join_cond):
                on.extend(_factor_or(c))
            if s.join_type == "left":
                for c in on:
                    if _contains_subquery(c):
                        raise BindError("subquery in LEFT JOIN ON")
                    e = self._as_edge(c, scope)
                    if e is not None:
                        conjs.append(c)
                        continue
                    owners = self._owners(c, scope)
                    if owners == {s.alias}:
                        s.filters.append(c)
                    else:
                        raise BindError(
                            "LEFT JOIN ON must be equi-join keys plus "
                            "right-side filters")
            elif s.join_type == "full":
                # FULL OUTER: non-equi ON conjuncts would have to apply
                # without dropping unmatched rows from either side —
                # restrict to pure equi keys
                for c in on:
                    if self._as_edge(c, scope) is None:
                        raise BindError(
                            "FULL JOIN ON must be equi-join keys")
                    conjs.append(c)
            else:
                conjs.extend(on)
        left_aliases = {s.alias for s in scope.sources
                        if s.join_type == "left"}
        if any(s.join_type == "full" for s in scope.sources):
            # every side of a FULL join is NULL-extended: all single-owner
            # WHERE filters apply post-join
            left_aliases = {s.alias for s in scope.sources}
        edges, post, sub_preds, range_edges = [], [], [], []
        for conj in conjs:
            if _contains_subquery(conj):
                sub_preds.append(conj)
                continue
            if isinstance(conj, A.Literal) and conj.value is True:
                continue
            e = self._as_edge(conj, scope)
            if e is not None:
                edges.append(e)
                continue
            re_ = self._as_range_edge(conj, scope)
            if re_ is not None:
                range_edges.append(re_)
                continue
            owners = self._owners(conj, scope)
            if len(owners) == 1:
                alias = next(iter(owners))
                if alias in left_aliases:
                    # WHERE filters on the NULL-extended side apply after
                    # the outer join (SQL semantics)
                    post.append(conj)
                else:
                    scope.by_alias[alias].filters.append(conj)
            else:
                post.append(conj)
        return edges, post, sub_preds, range_edges

    def _as_range_edge(self, conj, scope: Scope):
        """A non-equi conjunct whose two sides each touch exactly one
        (distinct) source: a range-join edge (the IEJoin/merge-join input,
        reference physical_piecewise_merge_join.cpp)."""
        if not (isinstance(conj, A.BinaryOp) and conj.op in
                ("<", "<=", ">", ">=")):
            return None
        try:
            lo = self._owners(conj.left, scope)
            ro = self._owners(conj.right, scope)
        except BindError:
            return None
        if len(lo) != 1 or len(ro) != 1 or lo == ro:
            return None
        return (next(iter(lo)), next(iter(ro)), conj)

    def _owners(self, conj, scope: Scope) -> set:
        owners = set()
        for ref in _colrefs_of(conj):
            s, depth = scope.resolve(ref)
            if s is None:
                q = f"{ref.table}." if ref.table else ""
                raise BindError(f"cannot resolve column {q}{ref.name}")
            if depth > 0:
                raise BindError(
                    f"unexpected correlated reference {ref.name}")
            owners.add(s.alias)
        return owners

    def _as_edge(self, conj, scope: Scope):
        if not (isinstance(conj, A.BinaryOp) and conj.op == "=="):
            return None
        l, r = conj.left, conj.right
        if not (isinstance(l, A.ColumnRef) and isinstance(r, A.ColumnRef)):
            return None
        ls = scope.find_local(l)
        rs = scope.find_local(r)
        if ls is None or rs is None or ls.alias == rs.alias:
            return None
        return (ls.alias, l.name, rs.alias, r.name)

    def _attach_asof(self, plan, plans, t, build_alias, probe_keys,
                     build_keys, prefix, range_edges, scope, joined):
        """Attach an ASOF source: equi keys + ONE inequality from the
        range-edge pool drive the AsofJoin single-match operator."""
        idx = flip = None
        for i, (la, ra, conj) in enumerate(range_edges):
            if la == build_alias and ra in joined:
                idx, flip = i, True
                break
            if ra == build_alias and la in joined:
                idx, flip = i, False
                break
        if idx is None:
            raise BindError(
                "ASOF JOIN needs one inequality condition in ON")
        _, _, conj = range_edges[idx]
        range_edges = range_edges[:idx] + range_edges[idx + 1:]
        # the build-side expression evaluates against the RAW build
        # relation (pre-join, no prefix)
        saved = t.prefix
        t.prefix = ""
        try:
            if flip:
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}[conj.op]
                build_e = self.to_expr(conj.left, scope)
            else:
                op = conj.op
                build_e = self.to_expr(conj.right, scope)
        finally:
            t.prefix = saved
        probe_e = self.to_expr(conj.right if flip else conj.left, scope)
        jt = "left" if t.join_type == "asof_left" else "inner"
        plan = P.AsofJoin(plan, plans[build_alias], probe_keys, build_keys,
                          probe_e, op, build_e, join_type=jt,
                          build_prefix=prefix)
        return plan, range_edges

    # -------------------------------------------------------- join tree
    def _source_plan(self, s: Source, scope: Scope,
                     refs: set) -> P.PhysicalOperator:
        if s.table_name is not None:
            table = self.catalog.table(s.table_name)
            needed = [c for c in table.columns
                      if (None, c) in refs or (s.alias, c) in refs]
            bound = [self.to_expr(c, scope) for c in s.filters]
            return P.TableScan(s.table_name, filters=bound,
                               projection=needed or None)
        plan = s.sub.plan
        for c in s.filters:
            plan = P.Filter(plan, self.to_expr(c, scope))
        return plan

    def _build_tree(self, scope: Scope, edges: list, refs: set,
                    range_edges: list = ()):
        """Greedy join-tree construction with prefix bookkeeping.

        Equi edges drive hash joins first; remaining sources attach via
        range joins (non-equi edges -> RangeJoin, the IEJoin/merge-join
        analog) or, with no edge at all, a cross product.  Returns (plan,
        row-count upper bound, unique key sets of the joined relation in
        physical names, leftover AST conjuncts to apply as post filters)."""
        range_edges = list(range_edges)
        sources = scope.sources
        plans = {s.alias: self._source_plan(s, scope, refs)
                 for s in sources}
        if len(sources) == 1:
            s = sources[0]
            return (plans[s.alias], s.size,
                    [frozenset(s.prefix + c for c in us)
                     for us in s.unique_sets],
                    [c for _, _, c in range_edges])
        inner = [s for s in sources if s.join_type == "inner"]
        if not inner:
            raise BindError("FROM needs at least one non-outer entry")
        start = max(inner, key=lambda s: s.size)
        start.prefix = ""
        joined = {start.alias}
        out_names = set(start.cols)
        plan = plans[start.alias]
        cur_size = start.size
        cur_unique = [frozenset(us) for us in start.unique_sets]
        pending = list(edges)
        while True:
            # pick the next build source: one with >=1 edge into the joined set
            candidates: dict[str, list] = {}
            for e in pending:
                la, lc, ra, rc = e
                if la in joined and ra not in joined:
                    candidates.setdefault(ra, []).append((la, lc, ra, rc))
                elif ra in joined and la not in joined:
                    candidates.setdefault(la, []).append((ra, rc, la, lc))
            if not candidates:
                break
            build_alias = next(iter(candidates))
            pairs = candidates[build_alias]
            t = scope.by_alias[build_alias]
            probe_keys = [scope.by_alias[pa].prefix + pc
                          for pa, pc, _, _ in pairs]
            build_keys = [bc for _, _, _, bc in pairs]
            # assign a disambiguating prefix on name collision (same base
            # table joined twice: nation n1/n2, lineitem l1/l2)
            prefix = ""
            if out_names & set(t.cols):
                prefix = f"{t.alias}__"
            t.prefix = prefix
            build_unique = any(us <= set(build_keys) for us in t.unique_sets)
            probe_unique = any(us <= set(probe_keys) for us in cur_unique)
            jt = "left" if t.join_type == "left" else "inner"
            if t.join_type in ("asof", "asof_left"):
                plan, range_edges = self._attach_asof(
                    plan, plans, t, build_alias, probe_keys, build_keys,
                    prefix, range_edges, scope, joined)
                # asof is probe-preserving single-match: prefix uniqueness
                # survives; cur_size unchanged
            elif t.join_type == "full":
                # FULL OUTER: always the expansion join (unmatched build
                # rows are appended by the operator)
                plan = P.HashJoin(plan, plans[build_alias], probe_keys,
                                  build_keys, "full", single_match=False,
                                  out_capacity=pad_count(max(cur_size, 1))
                                  if build_unique else None,
                                  build_prefix=prefix)
                cur_size = cur_size + t.size
                cur_unique = []
            elif build_unique:
                plan = P.HashJoin(plan, plans[build_alias], probe_keys,
                                  build_keys, jt, single_match=True,
                                  build_prefix=prefix)
                if jt == "inner":
                    cur_unique = [u for u in cur_unique]
                # cur_size unchanged: <= probe rows
            else:
                # expansion join; bound the capacity from provable uniqueness
                # (reference analog: statistics-fed size estimates feeding
                # the build, join_hashtable.cpp:1312)
                cap = None
                if probe_unique:
                    # each build row matches <= 1 probe row
                    bound = t.size + (cur_size if jt == "left" else 0)
                    cap = pad_count(max(bound, 1))
                    cur_size = bound
                else:
                    cur_size = cur_size * 2  # config-factor guess
                plan = P.HashJoin(plan, plans[build_alias], probe_keys,
                                  build_keys, jt, single_match=False,
                                  out_capacity=cap, build_prefix=prefix)
                cur_unique = []  # probe rows may duplicate
            joined.add(build_alias)
            out_names |= {prefix + c for c in t.cols}
            cur_unique += [frozenset(prefix + c for c in us)
                           for us in t.unique_sets]
            # retire edges now internal to the joined set as post filters
            still = []
            for e in pending:
                la, lc, ra, rc = e
                if la in joined and ra in joined:
                    if (la, lc, ra, rc) not in [
                            (pa, pc, build_alias, bc)
                            for pa, pc, _, bc in pairs] and \
                       (ra, rc, la, lc) not in [
                            (pa, pc, build_alias, bc)
                            for pa, pc, _, bc in pairs]:
                        lp = scope.by_alias[la].prefix + lc
                        rp = scope.by_alias[ra].prefix + rc
                        plan = P.Filter(plan, E.Col(lp) == E.Col(rp))
                else:
                    still.append(e)
            pending = still
        # attach sources with no equi edge: range join where a non-equi
        # edge exists (IEJoin/merge-join analog), else cross product
        # (PhysicalCrossProduct analog)
        missing = {s.alias for s in sources} - joined
        while missing:
            pick = None
            for la, ra, conj in range_edges:
                if la in joined and ra in missing:
                    pick = ra
                    break
                if ra in joined and la in missing:
                    pick = la
                    break
            if pick is None:
                pick = min(missing, key=lambda a: scope.by_alias[a].size)
            t = scope.by_alias[pick]
            if t.join_type in ("left", "full"):
                raise BindError("outer JOIN requires equi-join keys in ON")
            if t.join_type in ("asof", "asof_left"):
                prefix = ""
                if out_names & set(t.cols):
                    prefix = f"{t.alias}__"
                t.prefix = prefix
                plan, range_edges = self._attach_asof(
                    plan, plans, t, pick, [], [], prefix, range_edges,
                    scope, joined)
                joined.add(pick)
                out_names |= {prefix + c for c in t.cols}
                missing.discard(pick)
                continue
            conds, still = [], []
            for la, ra, conj in range_edges:
                if ra == pick and la in joined:
                    be = self.to_expr(conj.right, scope)   # raw: prefix=""
                    conds.append((self.to_expr(conj.left, scope),
                                  conj.op, be))
                elif la == pick and ra in joined:
                    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
                    be = self.to_expr(conj.left, scope)
                    conds.append((self.to_expr(conj.right, scope),
                                  flip[conj.op], be))
                else:
                    still.append((la, ra, conj))
            range_edges = still
            prefix = ""
            if out_names & set(t.cols):
                prefix = f"{t.alias}__"
            t.prefix = prefix
            bound = max(cur_size, 1) * max(t.size, 1)
            plan = P.RangeJoin(plan, plans[pick], conds,
                               out_capacity=pad_count(min(bound, 1 << 22)),
                               build_prefix=prefix)
            cur_size = bound
            cur_unique = []
            joined.add(pick)
            out_names |= {prefix + c for c in t.cols}
            missing.discard(pick)
        return plan, cur_size, cur_unique, [c for _, _, c in range_edges]

    # -------------------------------------------- subquery predicates
    def _apply_subquery_pred(self, plan, conj, scope: Scope,
                             negated: bool = False):
        if isinstance(conj, A.UnaryOp) and conj.op == "not":
            return self._apply_subquery_pred(plan, conj.child, scope,
                                             not negated)
        if isinstance(conj, A.ExistsExpr):
            return self._exists_pred(plan, conj.query, scope,
                                     negated ^ conj.negated)
        if isinstance(conj, A.InExpr) and isinstance(conj.values,
                                                     A.SelectStmt):
            return self._in_pred(plan, conj, scope, negated ^ conj.negated)
        if isinstance(conj, A.BinaryOp) and conj.op in _CMPS:
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                    "==": "==", "!=": "!="}
            if isinstance(conj.right, A.SubqueryExpr):
                return self._scalar_pred(plan, conj.left, conj.op,
                                         conj.right.query, scope, negated)
            if isinstance(conj.left, A.SubqueryExpr):
                return self._scalar_pred(plan, conj.right, flip[conj.op],
                                         conj.left.query, scope, negated)
        raise BindError(f"unsupported subquery predicate shape: {conj!r}")

    def _analyze_subquery(self, substmt: A.SelectStmt, outer: Scope):
        """Split the subquery's WHERE into local conjuncts, correlated
        equality pairs [(outer_ref, inner_ref)], and residual correlated
        conjuncts.  The decorrelation front half of the reference's subquery
        flattening (src/planner/binder/query_node)."""
        inner_sources = self._bind_sources(substmt)
        inner_scope = Scope(inner_sources, outer)
        local, corr, residual = [], [], []
        for conj in _split_and(substmt.where):
            if _contains_subquery(conj):
                local.append(conj)   # nested subquery: recursion handles it
                continue
            depths = []
            for ref in _colrefs_of(conj):
                s, depth = inner_scope.resolve(ref)
                if s is None:
                    q = f"{ref.table}." if ref.table else ""
                    raise BindError(f"cannot resolve {q}{ref.name}")
                if depth > 1:
                    raise BindError("doubly-nested correlation unsupported")
                depths.append(depth)
            if all(d == 0 for d in depths):
                local.append(conj)
                continue
            # correlated equality?
            if isinstance(conj, A.BinaryOp) and conj.op == "==" and \
                    isinstance(conj.left, A.ColumnRef) and \
                    isinstance(conj.right, A.ColumnRef):
                ls, ld = inner_scope.resolve(conj.left)
                rs, rd = inner_scope.resolve(conj.right)
                if ld == 0 and rd == 1:
                    corr.append((conj.right, conj.left))
                    continue
                if ld == 1 and rd == 0:
                    corr.append((conj.left, conj.right))
                    continue
            residual.append(conj)
        return local, corr, residual, inner_scope

    def _exists_pred(self, plan, substmt, scope: Scope, negated: bool):
        local, corr, residual, inner_scope = self._analyze_subquery(
            substmt, scope)
        if not corr:
            raise BindError("uncorrelated EXISTS is not supported")
        probe_keys = [scope.physical(orf) for orf, _ in corr]
        inner_items = []
        seen = set()
        for _, iref in corr:
            if iref.name not in seen:
                inner_items.append(A.SelectItem(iref, None))
                seen.add(iref.name)
        res_inner = []
        for conj in residual:
            for ref in _colrefs_of(conj):
                s, depth = inner_scope.resolve(ref)
                if depth == 0 and ref.name not in seen:
                    inner_items.append(A.SelectItem(ref, None))
                    seen.add(ref.name)
                    res_inner.append(ref.name)
        synth = A.SelectStmt(inner_items, substmt.tables, _and_all(local),
                             [], None, [], None)
        sub = self._bind_select(synth, None)
        build_keys = [iref.name for _, iref in corr]
        if not residual:
            return P.HashJoin(plan, sub.plan, probe_keys, build_keys,
                              "anti" if negated else "semi")
        mark_prefix = self._gen("mark") + "_"
        res_expr = None
        for conj in residual:
            e = self._bind_mixed(conj, inner_scope, scope, mark_prefix)
            res_expr = e if res_expr is None else (res_expr & e)
        return P.MarkJoin(plan, sub.plan, probe_keys, build_keys, res_expr,
                          negated, build_prefix=mark_prefix)

    def _bind_mixed(self, node, inner_scope: Scope, outer_scope: Scope,
                    prefix: str) -> E.Expr:
        """Bind a residual correlated expression over the MarkJoin's
        combined namespace: inner columns under `prefix`, outer columns at
        their joined physical names (innermost scope wins)."""

        def resolver(ref: A.ColumnRef) -> str:
            if inner_scope.find_local(ref) is not None:
                return prefix + ref.name
            return outer_scope.physical(ref)

        return self.to_expr(node, outer_scope, resolver=resolver)

    def _in_pred(self, plan, node: A.InExpr, scope: Scope, negated: bool):
        substmt = node.values
        if len(substmt.items) != 1:
            raise BindError("IN subquery must select exactly one column")
        if not isinstance(node.expr, A.ColumnRef):
            raise BindError("IN (SELECT ...) left side must be a column")
        local, corr, residual, inner_scope = self._analyze_subquery(
            substmt, scope)
        if residual:
            raise BindError("IN subquery with non-equality correlation")
        if not corr and not substmt.group_by and not substmt.having and \
                not any(_has_aggregate(i.expr) for i in substmt.items):
            # plain uncorrelated IN: bind as-is (keeps nested predicates)
            sub = self._bind_select(substmt, None)
            return P.HashJoin(plan, sub.plan, [scope.physical(node.expr)],
                              [sub.out_names[0]],
                              "anti" if negated else "semi")
        if not corr:
            # uncorrelated with grouping (q18): bind unchanged
            sub = self._bind_select(substmt, None)
            return P.HashJoin(plan, sub.plan, [scope.physical(node.expr)],
                              [sub.out_names[0]],
                              "anti" if negated else "semi")
        # correlated IN -> semi/anti on (in-pair + correlation keys)
        item = substmt.items[0]
        if not isinstance(item.expr, A.ColumnRef):
            raise BindError("correlated IN subquery item must be a column")
        inner_items = [A.SelectItem(item.expr, None)]
        seen = {item.expr.name}
        for _, iref in corr:
            if iref.name not in seen:
                inner_items.append(A.SelectItem(iref, None))
                seen.add(iref.name)
        synth = A.SelectStmt(inner_items, substmt.tables, _and_all(local),
                             [], None, [], None)
        sub = self._bind_select(synth, None)
        probe_keys = [scope.physical(node.expr)] + \
            [scope.physical(orf) for orf, _ in corr]
        build_keys = [item.expr.name] + [iref.name for _, iref in corr]
        return P.HashJoin(plan, sub.plan, probe_keys, build_keys,
                          "anti" if negated else "semi")

    def _scalar_pred(self, plan, lhs_ast, op, substmt, scope: Scope,
                     negated: bool):
        local, corr, residual, inner_scope = self._analyze_subquery(
            substmt, scope)
        if residual:
            raise BindError("scalar subquery with non-equality correlation")
        if not corr:
            sub = self._bind_select(substmt, None)
            if len(sub.out_names) != 1:
                raise BindError("scalar subquery must return one column")
            if not self._is_scalar_stmt(substmt):
                raise BindError("scalar subquery must aggregate to one row")
            gen = self._gen("sq")
            plan = P.BroadcastScalar(plan, sub.plan,
                                     {gen: sub.out_names[0]})
            expr = _make_cmp(op, self.to_expr(lhs_ast, scope), E.Col(gen))
            return P.Filter(plan, ~expr if negated else expr)
        # correlated scalar: group the inner by the correlation keys and
        # join back single-match (magic decorrelation; the reference's
        # flattening of correlated aggregates into delim joins)
        if substmt.group_by or len(substmt.items) != 1:
            raise BindError("correlated scalar subquery must be a bare "
                            "aggregate")
        item = substmt.items[0]
        agg_name = self._gen("agg")
        inner_items = []
        seen = set()
        group_refs = []
        for _, iref in corr:
            if iref.name not in seen:
                inner_items.append(A.SelectItem(iref, None))
                group_refs.append(iref)
                seen.add(iref.name)
        inner_items.append(A.SelectItem(item.expr, agg_name))
        synth = A.SelectStmt(inner_items, substmt.tables, _and_all(local),
                             list(group_refs), None, [], None)
        sub = self._bind_select(synth, None)
        prefix = self._gen("sq") + "_"
        has_count = self._contains_count(item.expr)
        found_col = prefix + "found" if has_count else None
        plan = P.HashJoin(plan, sub.plan,
                          [scope.physical(orf) for orf, _ in corr],
                          [iref.name for _, iref in corr],
                          "left", single_match=True, build_prefix=prefix,
                          found_column=found_col)
        agg_col: E.Expr = E.Col(prefix + agg_name)
        if has_count:
            # COUNT over an empty correlated set is 0, not NULL
            agg_col = E.Case(E.Col(found_col), agg_col, E.Lit(0))
        expr = _make_cmp(op, self.to_expr(lhs_ast, scope), agg_col)
        return P.Filter(plan, ~expr if negated else expr)

    @staticmethod
    def _is_scalar_stmt(stmt: A.SelectStmt) -> bool:
        return (not stmt.group_by
                and all(_has_aggregate(i.expr) for i in stmt.items))

    @staticmethod
    def _contains_count(node) -> bool:
        found = [False]

        def fn(n):
            if isinstance(n, A.FuncCall) and n.name == "count":
                found[0] = True

        _walk_ast(node, fn, into_selects=False)
        return found[0]

    # ------------------------------------------ SELECT list / aggregates
    def _bind_output(self, stmt, plan, scope: Scope, cur_size: int) -> Bound:
        items = list(stmt.items)
        if len(items) == 1 and isinstance(items[0].expr, A.ColumnRef) \
                and items[0].expr.name == "*":
            items = [A.SelectItem(A.ColumnRef(None, c), c)
                     for s in scope.sources for c in s.cols]
        has_agg = bool(stmt.group_by) or _has_aggregate(stmt.having) or \
            any(_has_aggregate(i.expr) for i in items)
        # window functions: OVER(...) items lower to Window operators over
        # the joined/filtered relation, then project as generated columns
        win_found: list[tuple[A.WindowExpr, str]] = []
        items = [A.SelectItem(self._replace_windows(it.expr, win_found),
                              it.alias) for it in items]
        win_names = set()
        if win_found:
            if has_agg:
                raise BindError("window functions cannot be mixed with "
                                "GROUP BY / aggregates in one SELECT "
                                "(wrap the aggregate in a subquery)")
            plan = self._bind_windows(plan, scope, win_found)
            win_names = {gen for _, gen in win_found}
        # UNCORRELATED scalar subqueries in the SELECT list: each becomes
        # one BroadcastScalar column (reference: uncorrelated subquery
        # flattening); correlated ones still need the WHERE-side rewrite
        sq_nodes: list = []

        def _find_sq(n):
            if isinstance(n, A.SubqueryExpr):
                sq_nodes.append(n)
        for it in items:
            _walk_ast(it.expr, _find_sq, into_selects=False)
        if sq_nodes and not has_agg:
            self._sq_cols = getattr(self, "_sq_cols", {})
            for node in sq_nodes:
                _, corr, _, _ = self._analyze_subquery(node.query, scope)
                if corr:
                    continue
                sub = self._bind_select(node.query, None)
                if len(sub.out_names) != 1 or \
                        not self._is_scalar_stmt(node.query):
                    continue
                gen = self._gen("ssq")
                plan = P.BroadcastScalar(plan, sub.plan,
                                         {gen: sub.out_names[0]})
                self._sq_cols[id(node)] = gen
                win_names.add(gen)
        if not has_agg:
            def _resolver(ref: A.ColumnRef):
                if ref.table is None and ref.name in win_names:
                    return ref.name
                return scope.physical(ref)
            projections: dict[str, E.Expr] = {}
            unique_sets = []
            name_of: dict[str, str] = {}   # physical -> out name
            for i, item in enumerate(items):
                name = item.alias or _default_name(item.expr, i)
                if name in projections:
                    raise BindError(f"duplicate output column {name}")
                projections[name] = self.to_expr(item.expr, scope,
                                                 resolver=_resolver)
                if isinstance(item.expr, A.ColumnRef) \
                        and item.expr.name not in win_names:
                    name_of[scope.physical(item.expr)] = name
            if len(scope.sources) == 1:
                s = scope.sources[0]
                for us in s.unique_sets:
                    phys = {s.prefix + c for c in us}
                    if phys <= set(name_of):
                        unique_sets.append(
                            frozenset(name_of[p] for p in phys))
            out = P.Project(plan, projections)
            out_names = list(projections.keys())
            if stmt.distinct:
                out = P.GroupAggregate(out, out_names, [])
                unique_sets = [frozenset(out_names)]
            out = self._order_limit(stmt, out, out_names)
            return Bound(out, out_names, unique_sets, cur_size)
        return self._bind_aggregate(stmt, items, plan, scope, cur_size)

    def _bind_aggregate(self, stmt, items, plan, scope: Scope,
                        cur_size: int) -> Bound:
        # ---- group keys
        alias_map = {i.alias: i.expr for i in items if i.alias}
        group_keys: list[str] = []          # physical key column names
        group_out: dict[str, str] = {}      # out/alias name -> key column
        pre_proj: dict[str, E.Expr] = {}
        for g in stmt.group_by:
            expr_ast = g
            out_name = None
            if isinstance(g, A.ColumnRef) and g.table is None \
                    and g.name in alias_map \
                    and scope.by_name.get(g.name) is None:
                expr_ast = alias_map[g.name]
                out_name = g.name
            if isinstance(expr_ast, A.ColumnRef):
                key = scope.physical(expr_ast)
                group_out[out_name or expr_ast.name] = key
                if expr_ast.table is not None:
                    group_out.setdefault(expr_ast.name, key)
            else:
                key = out_name or self._gen("gk")
                pre_proj[key] = self.to_expr(expr_ast, scope)
                group_out[out_name or key] = key
            group_keys.append(key)
        if pre_proj:
            plan = P.Project(plan, pre_proj, keep_input=True)

        # ---- count(DISTINCT col) interception (q16)
        distinct_aggs = []

        def find_distinct(n):
            if isinstance(n, A.FuncCall) and n.distinct:
                distinct_aggs.append(n)

        for it in items:
            _walk_ast(it.expr, find_distinct, into_selects=False)
        if distinct_aggs:
            return self._bind_count_distinct(stmt, items, plan, scope,
                                             group_keys, group_out,
                                             distinct_aggs, cur_size)

        # ---- aggregate extraction from items (+ having)
        aggs: list[P.Aggregate] = []
        post_exprs: dict[str, E.Expr] = {}
        extra_cols: set[str] = set()
        having_post = None
        lifted: list[tuple[str, A.SelectStmt]] = []
        for i, item in enumerate(items):
            name = item.alias or _default_name(item.expr, i)
            if name in post_exprs:
                raise BindError(f"duplicate output column {name}")
            # scalar subqueries in SELECT items of an aggregate query are
            # lifted to BroadcastScalar columns on the aggregate output
            # (same path HAVING subqueries use)
            item_ast = self._replace_subqueries(item.expr, lifted)
            extra_cols |= {gen for gen, _ in lifted}
            post_exprs[name] = self._bind_post_expr(
                item_ast, scope, aggs, group_out, extra_cols)
        if stmt.having is not None:
            having_ast = self._replace_subqueries(stmt.having, lifted)
            extra_cols |= {gen for gen, _ in lifted}
            having_post = self._bind_post_expr(having_ast, scope, aggs,
                                               group_out, extra_cols,
                                               alias_exprs=post_exprs)
        plan = P.GroupAggregate(plan, group_keys, aggs)
        for gen, substmt in lifted:
            sub = self._bind_select(substmt, None)
            if len(sub.out_names) != 1 or not self._is_scalar_stmt(substmt):
                raise BindError("HAVING subquery must be a scalar aggregate")
            plan = P.BroadcastScalar(plan, sub.plan, {gen: sub.out_names[0]})
        if having_post is not None:
            plan = P.Filter(plan, having_post)
        plan = P.Project(plan, post_exprs)
        out_names = list(post_exprs.keys())
        if stmt.distinct:
            plan = P.GroupAggregate(plan, out_names, [])
        plan = self._order_limit(stmt, plan, out_names)
        key_outs = frozenset(n for n, k in group_out.items()
                             if n in out_names and k in group_keys)
        unique_sets = [key_outs] if group_keys and len(key_outs) == len(
            set(group_keys)) else ([frozenset(out_names)] if not group_keys
                                   else [])
        return Bound(plan, out_names, unique_sets, cur_size)

    def _bind_count_distinct(self, stmt, items, plan, scope, group_keys,
                             group_out, distinct_aggs, cur_size) -> Bound:
        """count(DISTINCT col): dedup on (group keys + col) then count —
        the two-level plan the reference builds for distinct aggregates."""
        if len(distinct_aggs) != 1 or any(
                _has_aggregate(i.expr) and i.expr is not distinct_aggs[0]
                for i in items):
            raise BindError("only a single count(DISTINCT col) aggregate "
                            "is supported")
        agg = distinct_aggs[0]
        if agg.name != "count" or len(agg.args) != 1:
            raise BindError("DISTINCT only in count(DISTINCT col)")
        arg = agg.args[0]
        if isinstance(arg, A.ColumnRef):
            dkey = scope.physical(arg)
        else:
            dkey = self._gen("dk")
            plan = P.Project(plan, {dkey: self.to_expr(arg, scope)},
                             keep_input=True)
        plan = P.GroupAggregate(plan, group_keys + [dkey], [])
        cname = self._gen("cd")
        plan = P.GroupAggregate(plan, group_keys,
                                [P.Aggregate("count", None, cname)])
        post_exprs: dict[str, E.Expr] = {}
        for i, item in enumerate(items):
            name = item.alias or _default_name(item.expr, i)
            if isinstance(item.expr, A.FuncCall) and item.expr.distinct:
                post_exprs[name] = E.Col(cname)
            else:
                post_exprs[name] = self._bind_post_expr(
                    item.expr, scope, [], group_out, {cname})
        if stmt.having is not None:
            raise BindError("HAVING with count(DISTINCT) unsupported")
        plan = P.Project(plan, post_exprs)
        out_names = list(post_exprs.keys())
        plan = self._order_limit(stmt, plan, out_names)
        return Bound(plan, out_names, [], cur_size)

    # ------------------------------------------------------ window binding
    def _replace_windows(self, node, found: list):
        """Replace WindowExpr nodes with generated column refs; collect
        (node, gen_name) pairs for _bind_windows."""
        if isinstance(node, A.WindowExpr):
            gen = self._gen("w")
            found.append((node, gen))
            return A.ColumnRef(None, gen)
        if dataclasses.is_dataclass(node) and not isinstance(
                node, A.SelectStmt):
            kwargs = {}
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                if dataclasses.is_dataclass(v) and not isinstance(
                        v, A.SelectStmt):
                    v = self._replace_windows(v, found)
                elif isinstance(v, list):
                    v = [self._replace_windows(x, found)
                         if dataclasses.is_dataclass(x) else x for x in v]
                kwargs[f.name] = v
            return type(node)(**kwargs)
        return node

    _WINDOW_FUNCS = {"row_number", "rank", "dense_rank", "lead", "lag",
                     "first_value", "last_value", "sum", "avg", "min",
                     "max", "count"}

    def _bind_windows(self, plan, scope: Scope, found: list):
        """Lower collected WindowExprs: one Window operator per distinct
        (PARTITION BY, ORDER BY) pair (the reference groups window
        expressions the same way, physical_window.cpp:822)."""
        pre_proj: dict[str, E.Expr] = {}

        def key_col(expr_ast) -> str:
            if isinstance(expr_ast, A.ColumnRef):
                return scope.physical(expr_ast)
            gen = self._gen("wk")
            pre_proj[gen] = self.to_expr(expr_ast, scope)
            return gen

        groups: dict[tuple, list] = {}
        for node, gen in found:
            if node.func not in self._WINDOW_FUNCS:
                raise BindError(f"unknown window function {node.func}")
            parts = tuple(key_col(p) for p in node.partition_by)
            orders = tuple((key_col(oi.expr), oi.descending)
                           for oi in node.order_by)
            groups.setdefault((parts, orders), []).append((node, gen))
        if pre_proj:
            plan = P.Project(plan, pre_proj, keep_input=True)
        for (parts, orders), members in groups.items():
            funcs = []
            for node, gen in members:
                kind = node.func
                expr = None
                offset, default = 1, None
                if kind in ("row_number", "rank", "dense_rank"):
                    if node.args:
                        raise BindError(f"{kind}() takes no arguments")
                elif kind == "count" and (node.star or not node.args):
                    expr = None
                else:
                    if not node.args:
                        raise BindError(f"{kind}() needs a value argument")
                    expr = self.to_expr(node.args[0], scope)
                    if kind in ("lead", "lag"):
                        if len(node.args) > 1:
                            a1 = node.args[1]
                            if not isinstance(a1, A.Literal) or \
                                    not isinstance(a1.value, int):
                                raise BindError(
                                    f"{kind} offset must be an integer "
                                    f"literal")
                            offset = a1.value
                        if len(node.args) > 2:
                            a2 = node.args[2]
                            neg = False
                            while isinstance(a2, A.UnaryOp) and a2.op == "-":
                                neg, a2 = not neg, a2.child
                            if not isinstance(a2, A.Literal):
                                raise BindError(
                                    f"{kind} default must be a literal")
                            default = -a2.value if neg else a2.value
                funcs.append(P.WindowFunc(kind, expr, gen, offset=offset,
                                          default=default, frame=node.frame))
            plan = P.Window(plan, list(parts), list(orders), funcs)
        return plan

    def _replace_subqueries(self, node, lifted: list):
        """Replace scalar SubqueryExpr nodes with generated column refs
        (bound later via BroadcastScalar on the aggregate output)."""
        if isinstance(node, A.SubqueryExpr):
            gen = self._gen("hsq")
            lifted.append((gen, node.query))
            return A.ColumnRef(None, gen)
        if dataclasses.is_dataclass(node) and not isinstance(
                node, A.SelectStmt):
            kwargs = {}
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                if dataclasses.is_dataclass(v) and not isinstance(
                        v, A.SelectStmt):
                    v = self._replace_subqueries(v, lifted)
                elif isinstance(v, A.SubqueryExpr):
                    v = self._replace_subqueries(v, lifted)
                elif isinstance(v, list):
                    v = [self._replace_subqueries(x, lifted)
                         if dataclasses.is_dataclass(x) else x for x in v]
                kwargs[f.name] = v
            return type(node)(**kwargs)
        return node

    def _bind_post_expr(self, node, scope: Scope, aggs: list,
                        group_out: dict, extra_cols: set,
                        alias_exprs: dict | None = None) -> E.Expr:
        """Bind a select/having expression over the aggregate OUTPUT
        relation: aggregate calls become Aggregate specs + output column
        refs; plain columns must be group keys, select aliases (HAVING
        referencing an aggregate alias), or lifted scalars."""
        # port-only {
        if isinstance(node, A.FuncCall) and node.name in port_aggs.NAMES:
            return port_aggs.bind(self, node, scope, aggs)
        # port-only }
        if isinstance(node, A.FuncCall) and node.name in _AGG_FUNCS:
            if node.distinct:
                raise BindError("DISTINCT aggregate in unsupported position")
            gen = self._gen("a")
            arg = None if (node.star or not node.args) else \
                self.to_expr(node.args[0], scope)
            aggs.append(P.Aggregate(node.name, arg, gen))
            return E.Col(gen)
        if isinstance(node, A.FuncCall) and node.name in _STAT_AGGS:
            # stddev/variance via the sum-of-squares identity over exact
            # per-group sums: var_samp = (n*sum(x^2) - sum(x)^2) / (n*(n-1))
            arg = self.to_expr(node.args[0], scope).cast_double()
            g_s, g_ss, g_n = self._gen("a"), self._gen("a"), self._gen("a")
            aggs.append(P.Aggregate("sum_double", arg, g_s))
            aggs.append(P.Aggregate("sum_double", arg * arg, g_ss))
            aggs.append(P.Aggregate("count", arg, g_n))
            n, s, ss = E.Col(g_n), E.Col(g_s), E.Col(g_ss)
            pop = node.name.endswith("_pop")
            denom = (n * n) if pop else (n * (n - E.Lit(1)))
            var = (n * ss - s * s) / denom
            # var_samp over n<=1 rows (var_pop over 0) is NULL, not 0/0=NaN
            # (reference STDDEV finalize, core_functions/aggregate/
            # distributive/stddev.cpp); numerical cancellation can also
            # drive the identity a hair negative — clamp at 0
            var = E.ValidIf(E.Case(var > E.Lit(0.0), var, E.Lit(0.0)),
                            n > E.Lit(0 if pop else 1))
            if node.name.startswith("var"):
                return var
            return E.MathFn("sqrt", var)

        def resolver(ref: A.ColumnRef):
            if ref.table is None:
                if ref.name in extra_cols:
                    return ref.name
                if ref.name in group_out:
                    return group_out[ref.name]
                if alias_exprs is not None and ref.name in alias_exprs:
                    return alias_exprs[ref.name]
            phys = scope.physical(ref)
            if phys in group_out.values():
                return phys
            raise BindError(
                f"column {ref.name} must appear in GROUP BY or inside an "
                f"aggregate")

        def agg_hook(fc: A.FuncCall):
            return self._bind_post_expr(fc, scope, aggs, group_out,
                                        extra_cols, alias_exprs)

        return self.to_expr(node, scope, resolver=resolver,
                            agg_hook=agg_hook)

    def _bind_scalar_func(self, node: A.FuncCall, rec) -> E.Expr:
        """Scalar function registry (reference src/core_functions/scalar/)."""
        name, args = node.name, node.args
        def need(k):
            if len(args) != k:
                raise BindError(f"{name}() takes {k} argument(s)")
        if name in ("upper", "ucase", "lower", "lcase", "trim", "ltrim",
                    "rtrim"):
            need(1)
            op = {"ucase": "upper", "lcase": "lower"}.get(name, name)
            return E.StrMap(rec(args[0]), op)
        if name in ("length", "len", "char_length"):
            need(1)
            return E.StrLen(rec(args[0]))
        if name == "concat":
            if len(args) < 2:
                raise BindError("concat() takes 2+ arguments")
            out = rec(args[0])
            for a in args[1:]:
                out = E.Concat(out, rec(a))
            return out
        if name in ("sqrt", "abs", "floor", "ceil", "ceiling"):
            need(1)
            op = "ceil" if name == "ceiling" else name
            return E.MathFn(op, rec(args[0]))
        if name == "round":
            digits = 0
            if len(args) == 2:
                d = args[1]
                if not isinstance(d, A.Literal) or not isinstance(d.value,
                                                                  int):
                    raise BindError("round() digits must be an int literal")
                digits = d.value
            elif len(args) != 1:
                raise BindError("round() takes 1-2 arguments")
            return E.MathFn("round", rec(args[0]), digits)
        if name == "date_part":
            need(2)
            f = args[0]
            if not isinstance(f, A.Literal) or f.value not in (
                    "year", "month", "day"):
                raise BindError("date_part field must be "
                                "'year'|'month'|'day'")
            if f.value == "year":
                return rec(args[1]).year()
            return E.ExtractField(f.value, rec(args[1]))
        if name in ("year", "month", "day"):
            need(1)
            if name == "year":
                return rec(args[0]).year()
            return E.ExtractField(name, rec(args[0]))
        if name in ("exp", "ln", "log", "log2", "log10", "sin", "cos",
                    "tan"):
            need(1)
            return E.MathFn(name, rec(args[0]))
        if name in ("power", "pow"):
            need(2)
            return E.MathFn("power", rec(args[0]), other=rec(args[1]))
        if name == "mod":
            need(2)
            return E.Arith("%", rec(args[0]), rec(args[1]))
        if name == "coalesce":
            if len(args) < 2:
                raise BindError("coalesce() takes 2+ arguments")
            out = rec(args[-1])
            for a in reversed(args[:-1]):
                e = rec(a)
                out = E.Case(~E.IsNull(e), e, out)
            return out
        if name == "nullif":
            need(2)
            a, b = rec(args[0]), rec(args[1])
            return E.ValidIf(a, ~(a == b))
        if name in ("greatest", "least"):
            # NULL-aware fold (Postgres semantics): NULL arguments are
            # ignored, so greatest(1, NULL) = 1; result is NULL only when
            # every argument is NULL
            if len(args) < 2:
                raise BindError(f"{name}() takes 2+ arguments")
            out = rec(args[0])
            for a in args[1:]:
                e = rec(a)
                cond = (out > e) if name == "greatest" else (out < e)
                picked = E.Case(cond, out, e)
                picked = E.Case(E.IsNull(out), e, picked)
                out = E.Case(E.IsNull(e), out, picked)
            return out
        raise BindError(f"unknown function {name}")

    def _order_limit(self, stmt, plan, out_names):
        if stmt.order_by:
            keys = []
            hidden: dict[str, E.Expr] = {}
            for oi in stmt.order_by:
                if isinstance(oi.expr, A.ColumnRef) \
                        and oi.expr.name in out_names:
                    keys.append((oi.expr.name, oi.descending))
                elif isinstance(oi.expr, A.Literal) \
                        and isinstance(oi.expr.value, int):
                    keys.append((list(out_names)[oi.expr.value - 1],
                                 oi.descending))
                else:
                    # ORDER BY <expression over output columns>: compute a
                    # hidden sort column, drop it after the sort
                    def resolver(ref, _names=out_names):
                        if ref.name in _names:
                            return ref.name
                        raise BindError(
                            f"ORDER BY expression references {ref.name}, "
                            f"which is not an output column")
                    e = self.to_expr(oi.expr, Scope([], None),
                                     resolver=resolver)
                    h = self._gen("ob")
                    hidden[h] = e
                    keys.append((h, oi.descending))
            if hidden:
                plan = P.Project(plan, hidden, keep_input=True)
            plan = P.OrderBy(plan, keys, limit=stmt.limit)
            if hidden:
                plan = P.Project(plan, {n: n for n in out_names})
            return plan
        if stmt.limit is not None:
            return P.Limit(plan, stmt.limit)
        return plan

    # ------------------------------------------------------- expressions
    def to_expr(self, node, scope: Scope, resolver=None,
                agg_hook=None) -> E.Expr:
        """Bind an AST expression to an engine expression.

        `resolver` overrides ColumnRef -> physical-name resolution;
        `agg_hook` intercepts aggregate FuncCalls (post-aggregate binding).
        """
        if isinstance(node, str):
            # convenience: bare physical column name
            return E.Col(node)
        rec = lambda n: self.to_expr(n, scope, resolver, agg_hook)  # noqa: E731
        if isinstance(node, A.ColumnRef):
            if resolver is not None:
                out = resolver(node)
                return out if isinstance(out, E.Expr) else E.Col(out)
            return E.Col(scope.physical(node))
        if isinstance(node, A.Literal):
            if node.type_hint == "date":
                return E.date_lit(node.value)
            if node.type_hint == "string":
                return E.Lit(node.value)
            if node.type_hint == "decimal":
                return _dec_lit_norm(node.value)
            if node.value is None:
                # bare NULL literal: value 0, valid nowhere
                return E.ValidIf(E.Lit(0), E.Lit(False))
            return E.Lit(node.value)
        if isinstance(node, A.IntervalLit):
            raise BindError("interval outside date arithmetic")
        if isinstance(node, A.FuncCall):
            # port-only {
            if node.name in port_aggs.NAMES:
                if agg_hook is not None:
                    return agg_hook(node)
                raise BindError(f"aggregate {node.name}() outside "
                                f"SELECT/HAVING")
            # port-only }
            if node.name in _AGG_FUNCS or node.name in _STAT_AGGS:
                if agg_hook is not None:
                    return agg_hook(node)
                raise BindError(f"aggregate {node.name}() outside "
                                f"SELECT/HAVING")
            return self._bind_scalar_func(node, rec)
        if isinstance(node, A.BinaryOp):
            folded = _fold_date_arith(node)
            if folded is not None:
                return folded
            if node.op == "||":
                return E.Concat(rec(node.left), rec(node.right))
            l, r = rec(node.left), rec(node.right)
            ops = {"+": lambda: l + r, "-": lambda: l - r,
                   "*": lambda: l * r, "/": lambda: l / r,
                   "%": lambda: E.Arith("%", l, r),
                   "and": lambda: l & r, "or": lambda: l | r,
                   "==": lambda: l == r, "!=": lambda: l != r,
                   "<": lambda: l < r, "<=": lambda: l <= r,
                   ">": lambda: l > r, ">=": lambda: l >= r}
            return ops[node.op]()
        if isinstance(node, A.UnaryOp):
            if node.op == "not":
                return ~rec(node.child)
            return E.Lit(0) - rec(node.child)
        if isinstance(node, A.BetweenExpr):
            e = rec(node.expr)
            b = e.between(rec(node.low), rec(node.high))
            return ~b if node.negated else b
        if isinstance(node, A.InExpr):
            if isinstance(node.values, A.SelectStmt):
                raise BindError("IN (SELECT) must be a top-level conjunct")
            e = rec(node.expr)
            vals = []
            for v in node.values:
                folded = _fold_const_ast(v)
                if folded is None:
                    raise BindError("IN list must contain constants")
                vals.append(folded)
            r = e.isin(vals)
            return ~r if node.negated else r
        if isinstance(node, A.LikeExpr):
            e = rec(node.expr)
            return e.not_like(node.pattern) if node.negated \
                else e.like(node.pattern)
        if isinstance(node, A.IsNullExpr):
            e = E.IsNull(rec(node.expr))
            return ~e if node.negated else e
        if isinstance(node, A.CaseExpr):
            default = rec(node.default) if node.default is not None \
                else E.Lit(0)
            out = default
            for cond, res in reversed(node.whens):
                out = E.Case(rec(cond), rec(res), out)
            return out
        if isinstance(node, A.ExtractExpr):
            if node.field not in ("year", "month", "day"):
                raise BindError(f"extract({node.field}) unsupported")
            if node.field == "year":
                return rec(node.child).year()
            return E.ExtractField(node.field, rec(node.child))
        if isinstance(node, A.SubstringExpr):
            return E.Substr(rec(node.child),
                            int(node.start.value), int(node.length.value))
        if isinstance(node, A.CastExpr):
            if node.target == "date":
                if isinstance(node.child, A.Literal):
                    return E.date_lit(node.child.value)
                raise BindError("CAST(expr AS date) on non-literal")
            e = rec(node.child)
            if node.target in ("double", "float", "real", "float8"):
                return e.cast_double()
            if node.target in ("integer", "int", "int4", "bigint", "int8",
                               "smallint", "tinyint", "hugeint"):
                return E.CastInt(e)
            return e
        if isinstance(node, A.SubqueryExpr):
            gen = getattr(self, "_sq_cols", {}).get(id(node))
            if gen is not None:
                return E.Col(gen)
            raise BindError("scalar subquery must be a comparison operand "
                            "in WHERE/HAVING")
        if isinstance(node, A.ExistsExpr):
            raise BindError("EXISTS must be a top-level conjunct")
        raise BindError(f"cannot bind expression {node!r}")
