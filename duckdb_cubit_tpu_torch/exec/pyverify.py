"""Row-by-row pure-Python verification executor (verification leg 4).

Counterpart of `duckdb_cubit_tpu/exec/pyverify.py`, nearly line for line:
an implementation independent of legs 1-3 that shares no torch operation,
no dictionary code space and no device tensor with them.  Strings are
compared as Python bytes, decimals as scaled Python ints, dates through
datetime.  A table's columns come from their host mirrors (`Column.host`,
`nulls_host`); a column without one, and `Table.deleted`, are copied to the
host (`.cpu().numpy()`), the only torch calls here.  So a fault in a torch
kernel shared by legs 1-3 cannot confirm itself.

Scope: the common operator core (scan/filter/project/hash join incl.
outer/semi/anti + found columns/group aggregate/order/limit/broadcast
scalar) and the common expression set.  `supports(plan)` reports coverage;
the executor runs this leg only for small inputs (config.pyverify_max_rows)
on the UNOPTIMIZED plan, so index rewrites are out of the picture too.
"""

from __future__ import annotations

import math
import re

import numpy as np

from ..ops import expressions as E
from ..plan import physical as P
from ..types import TypeId, days_to_date


class Unsupported(Exception):
    pass


# value representation: (value | None, kind, scale)
# kind: int | dec | float | str | char | date | bool
def _kind_of(dtype) -> tuple[str, int]:
    k = {TypeId.INT32: "int", TypeId.INT64: "int", TypeId.DECIMAL: "dec",
         TypeId.DOUBLE: "float", TypeId.VARCHAR: "str", TypeId.CHAR1: "char",
         TypeId.DATE: "date", TypeId.BOOL: "bool"}.get(dtype.id)
    if k is None:
        raise Unsupported(f"dtype {dtype}")
    return k, dtype.scale if dtype.id == TypeId.DECIMAL else 0


def _tab(catalog, name):
    t = catalog.table(name)
    cols = {}
    for cname, c in t.columns.items():
        kind, scale = _kind_of(c.dtype)
        host = c.host if c.host is not None else \
            c.data[: t.num_rows].cpu().numpy()
        host = np.asarray(host[: t.num_rows])
        if c.dtype.id == TypeId.VARCHAR:
            vals = [c.dictionary[int(v)] for v in host]
        elif c.dtype.id == TypeId.CHAR1:
            vals = [chr(int(v)) for v in host]
        elif c.dtype.id == TypeId.DOUBLE:
            vals = [float(v) for v in host]
        elif c.dtype.id == TypeId.BOOL:
            vals = [bool(v) for v in host]
        else:
            vals = [int(v) for v in host]
        cols[cname] = (vals, kind, scale)
    deleted = t.deleted
    alive = [True] * t.num_rows
    if deleted is not None:
        dm = deleted[: t.num_rows].cpu().numpy()
        alive = [not bool(d) for d in dm]
    nulls = {}
    for cname, c in t.columns.items():
        nh = getattr(c, "nulls_host", None)
        if nh is not None:
            nulls[cname] = nh
    rows = []
    names = list(cols.keys())
    for i in range(t.num_rows):
        if alive[i]:
            rows.append({
                n: ((None, cols[n][1], cols[n][2])
                    if n in nulls and bool(nulls[n][i])
                    else (cols[n][0][i], cols[n][1], cols[n][2]))
                for n in names})
    return rows


# ------------------------------------------------------------ expressions
def _num(v):
    val, kind, scale = v
    if val is None:
        return None
    if kind == "dec":
        return val / (10 ** scale)
    if kind in ("int", "date"):
        return val
    if kind == "float":
        return val
    if kind == "bool":
        return 1 if val else 0
    raise Unsupported(f"numeric use of {kind}")


def _rescale(v, scale):
    val, kind, s = v
    if val is None:
        return (None, "dec", scale)
    if kind in ("int", "date", "bool"):
        return (int(val) * 10 ** scale, "dec", scale)
    assert kind == "dec" and scale >= s
    return (val * 10 ** (scale - s), "dec", scale)


def ev(node, row):  # noqa: C901 - a case per node type, deliberately flat
    if isinstance(node, E.Col):
        if node.name not in row:
            raise Unsupported(f"column {node.name}")
        return row[node.name]
    if isinstance(node, E.Lit):
        v, dt = node.value, node.dtype
        if dt is not None:
            kind, scale = _kind_of(dt)
            if kind == "str" and isinstance(v, str):
                v = v.encode()
            return (v, kind, scale)
        if isinstance(v, bool):
            return (v, "bool", 0)
        if isinstance(v, int):
            return (v, "int", 0)
        if isinstance(v, float):
            return (v, "float", 0)
        if isinstance(v, str):
            return (v.encode(), "str", 0)
        raise Unsupported(f"literal {v!r}")
    if isinstance(node, E.Arith):
        lt, rt = ev(node.left, row), ev(node.right, row)
        if lt[0] is None or rt[0] is None:
            return (None, "float", 0)
        if node.op == "%":
            if "float" in (lt[1], rt[1]) or "dec" in (lt[1], rt[1]):
                return (math.fmod(_num(lt), _num(rt)), "float", 0)
            la, ra = int(lt[0]), int(rt[0])
            sign = -1 if la < 0 else 1
            return (sign * (abs(la) % abs(ra)), "int", 0)
        if node.op == "/" or "float" in (lt[1], rt[1]):
            la, ra = _num(lt), _num(rt)
            out = {"+": la + ra, "-": la - ra, "*": la * ra,
                   "/": la / ra if ra else float("inf")}[
                       node.op if node.op in "+-*/" else node.op]
            return (out, "float", 0)
        ls, rs = lt[2], rt[2]
        if node.op == "*":
            return (int(lt[0]) * int(rt[0]),
                    "dec" if ls + rs else "int", ls + rs)
        s = max(ls, rs)
        la = _rescale(lt, s)[0] if (ls != s or lt[1] == "dec") else lt[0]
        ra = _rescale(rt, s)[0] if (rs != s or rt[1] == "dec") else rt[0]
        out = la + ra if node.op == "+" else la - ra
        if s:
            return (out, "dec", s)
        if "date" in (lt[1], rt[1]) and node.op in "+-":
            return (out, "date", 0)
        return (out, "int", 0)
    if isinstance(node, E.Compare):
        lt, rt = ev(node.left, row), ev(node.right, row)
        if lt[0] is None or rt[0] is None:
            return (None, "bool", 0)
        if "str" in (lt[1], rt[1]):
            la = lt[0] if isinstance(lt[0], bytes) else str(lt[0]).encode()
            ra = rt[0] if isinstance(rt[0], bytes) else str(rt[0]).encode()
        elif "char" in (lt[1], rt[1]):
            la, ra = str(lt[0]), str(rt[0])
        elif lt[2] or rt[2]:
            s = max(lt[2], rt[2])
            la, ra = _rescale(lt, s)[0], _rescale(rt, s)[0]
        else:
            la, ra = _num(lt), _num(rt)
        out = {"==": la == ra, "!=": la != ra, "<": la < ra,
               "<=": la <= ra, ">": la > ra, ">=": la >= ra}[node.op]
        return (out, "bool", 0)
    if isinstance(node, E.BoolOp):
        lt, rt = ev(node.left, row), ev(node.right, row)
        lv, rv = lt[0], rt[0]
        if node.op == "and":
            if lv is False or rv is False:
                return (False, "bool", 0)
            if lv is None or rv is None:
                return (None, "bool", 0)
            return (bool(lv and rv), "bool", 0)
        if lv is True or rv is True:
            return (True, "bool", 0)
        if lv is None or rv is None:
            return (None, "bool", 0)
        return (bool(lv or rv), "bool", 0)
    if isinstance(node, E.NotOp):
        t = ev(node.child, row)
        return (None if t[0] is None else not t[0], "bool", 0)
    if isinstance(node, E.InList):
        t = ev(node.child, row)
        if t[0] is None:
            return (None, "bool", 0)
        vals = node.values
        if t[1] == "str":
            targets = {v.encode() if isinstance(v, str) else v
                       for v in vals}
            return (t[0] in targets, "bool", 0)
        if t[1] == "char":
            return (str(t[0]) in {str(v) for v in vals}, "bool", 0)
        return (any(_num(t) == v for v in vals), "bool", 0)
    if isinstance(node, E.Like):
        t = ev(node.child, row)
        if t[0] is None:
            return (None, "bool", 0)
        rx = re.compile(E.like_to_regex(node.pattern).encode())
        return (rx.match(t[0]) is not None, "bool", 0)
    if isinstance(node, E.Substr):
        t = ev(node.child, row)
        if t[0] is None:
            return (None, "str", 0)
        return (t[0][node.start - 1: node.start - 1 + node.length],
                "str", 0)
    if isinstance(node, (E.ExtractYear, E.ExtractField)):
        t = ev(node.child, row)
        if t[0] is None:
            return (None, "int", 0)
        d = days_to_date(int(t[0]))
        field = "year" if isinstance(node, E.ExtractYear) else node.field
        return ({"year": d.year, "month": d.month, "day": d.day}[field],
                "int", 0)
    if isinstance(node, E.CastDouble):
        t = ev(node.child, row)
        return (None if t[0] is None else float(_num(t)), "float", 0)
    if isinstance(node, E.Case):
        c = ev(node.cond, row)
        take_then = c[0] is True
        return ev(node.then if take_then else node.other, row)
    if isinstance(node, E.IsNull):
        t = ev(node.child, row)
        return (t[0] is None, "bool", 0)
    if isinstance(node, E.ValidIf):
        t = ev(node.child, row)
        c = ev(node.cond, row)
        if c[0] is not True:
            return (None, t[1], t[2])
        return t
    if isinstance(node, E.StrMap):
        t = ev(node.child, row)
        if t[0] is None:
            return t
        fns = {"upper": bytes.upper, "lower": bytes.lower,
               "trim": bytes.strip, "ltrim": bytes.lstrip,
               "rtrim": bytes.rstrip}
        if t[1] == "char":
            s = getattr(str(t[0]), node.op if node.op != "trim"
                        else "strip")()
            return (s if s else "\x00", "char", 0)
        return (fns[node.op](t[0]), "str", 0)
    if isinstance(node, E.StrLen):
        t = ev(node.child, row)
        if t[0] is None:
            return (None, "int", 0)
        return (1 if t[1] == "char" else len(t[0]), "int", 0)
    if isinstance(node, E.Concat):
        lt, rt = ev(node.left, row), ev(node.right, row)
        if lt[0] is None or rt[0] is None:
            return (None, "str", 0)
        def b(t):
            if t[1] == "char":
                return str(t[0]).encode()
            return t[0] if isinstance(t[0], bytes) else str(t[0]).encode()
        return (b(lt) + b(rt), "str", 0)
    if isinstance(node, E.MathFn):
        t = ev(node.child, row)
        if t[0] is None:
            return (None, "float", 0)
        if node.op == "abs":
            if t[1] in ("int", "dec"):
                return (abs(t[0]), t[1], t[2])
            return (abs(_num(t)), "float", 0)
        x = _num(t)
        fns = {"sqrt": math.sqrt, "exp": math.exp, "ln": math.log,
               "log": math.log10, "log10": math.log10, "log2": math.log2,
               "sin": math.sin, "cos": math.cos, "tan": math.tan,
               "floor": math.floor, "ceil": math.ceil}
        if node.op in fns:
            out = fns[node.op](x)
            if node.op in ("floor", "ceil"):
                return (float(out), "float", 0)
            return (out, "float", 0)
        if node.op == "power":
            o = ev(node.other, row)
            if o[0] is None:
                return (None, "float", 0)
            return (x ** _num(o), "float", 0)
        if node.op == "round":
            if t[1] == "dec" and node.digits <= t[2]:
                drop = t[2] - node.digits
                if drop == 0:
                    return t
                p = 10 ** drop
                a = int(t[0])
                half = p // 2 if a >= 0 else -(p // 2)
                return ((a + half) // p, "dec", node.digits)
            f = 10.0 ** node.digits
            return (float(np.round(x * f) / f), "float", 0)
        raise Unsupported(f"mathfn {node.op}")
    raise Unsupported(type(node).__name__)


# -------------------------------------------------------------- operators
def run(plan, catalog):
    """Execute `plan` row-by-row -> (names, rows of tagged values)."""
    if isinstance(plan, P.TableScan):
        if getattr(plan, "index_filters", None):
            raise Unsupported("index filters (run the unoptimized plan)")
        rows = _tab(catalog, plan.table_name)
        for f in plan.filters:
            rows = [r for r in rows if ev(f, r)[0] is True]
        return rows
    if isinstance(plan, P.Filter):
        rows = run(plan.children[0], catalog)
        return [r for r in rows if ev(plan.expr, r)[0] is True]
    if isinstance(plan, P.Project):
        rows = run(plan.children[0], catalog)
        out = []
        for r in rows:
            nr = dict(r) if plan.keep_input else {}
            for name, e in plan.exprs.items():
                nr[name] = r[e] if isinstance(e, str) else ev(e, r)
            out.append(nr)
        return out
    if isinstance(plan, P.Limit):
        return run(plan.children[0], catalog)[: plan.limit]
    if isinstance(plan, P.OrderBy):
        rows = run(plan.children[0], catalog)

        def key(r):
            ks = []
            for name, desc in plan.keys:
                v = r[name]
                isnull = v[0] is None
                if v[0] is None:
                    kv = 0
                elif v[1] in ("str",):
                    kv = v[0]
                elif v[1] == "char":
                    kv = str(v[0])
                else:
                    kv = _num(v)
                if desc and not isinstance(kv, (bytes, str)):
                    kv = -kv
                ks.append((isnull, kv, desc))
            return ks

        # bytes/str can't be negated: sort stable per key from last to first
        for name, desc in reversed(plan.keys):
            def k1(r, name=name, desc=desc):
                v = r[name]
                return (v[0] is None,
                        v[0] if v[1] in ("str", "char") and v[0] is not None
                        else (_num(v) if v[0] is not None else 0))
            rows = sorted(rows, key=k1, reverse=desc)
            # NULLS LAST regardless of direction
            rows = sorted(rows, key=lambda r, name=name: r[name][0] is None)
        if plan.limit is not None:
            rows = rows[: plan.limit]
        return rows
    if isinstance(plan, P.HashJoin):
        return _join(plan, catalog)
    if isinstance(plan, P.GroupAggregate):
        return _group(plan, catalog)
    if isinstance(plan, P.BroadcastScalar):
        rows = run(plan.children[0], catalog)
        sub = run(plan.children[1], catalog)
        if len(sub) != 1:
            raise Unsupported(f"broadcast of {len(sub)} rows")
        add = {out: sub[0][src] for out, src in plan.names.items()}
        return [{**r, **add} for r in rows]
    raise Unsupported(type(plan).__name__)


def _key_val(r, name):
    v = r[name]
    if v[0] is None:
        return None
    if v[1] in ("str", "char"):
        return v[0]
    if v[1] == "dec":
        return ("d", v[0], v[2])
    return _num(v)


def _join(op, catalog):
    probe = run(op.children[0], catalog)
    build = run(op.children[1], catalog)
    ht: dict = {}
    for bi, br in enumerate(build):
        k = tuple(_key_val(br, n) for n in op.build_keys)
        if any(x is None for x in k):
            continue
        ht.setdefault(k, []).append(bi)
    out = []
    matched_build: set = set()
    jt = op.join_type
    for pr in probe:
        k = tuple(_key_val(pr, n) for n in op.probe_keys)
        matches = [] if any(x is None for x in k) else ht.get(k, [])
        if jt == "semi":
            if matches:
                out.append(pr)
            continue
        if jt == "anti":
            if not matches:
                out.append(pr)
            continue
        if matches:
            for bi in matches:
                nr = dict(pr)
                for n, v in build[bi].items():
                    cn = op.build_prefix + n
                    if cn not in nr:
                        nr[cn] = v
                if op.found_column:
                    nr[op.found_column] = (True, "bool", 0)
                out.append(nr)
                matched_build.add(bi)
        elif jt in ("left", "full"):
            nr = dict(pr)
            for n, v in (build[0].items() if build else []):
                cn = op.build_prefix + n
                if cn not in nr:
                    nr[cn] = (None, v[1], v[2])
            if op.found_column:
                nr[op.found_column] = (False, "bool", 0)
            out.append(nr)
    if jt == "full":
        for bi, br in enumerate(build):
            if bi not in matched_build:
                nr = {n: (None, v[1], v[2])
                      for n, v in (probe[0].items() if probe else [])}
                for n, v in br.items():
                    nr[op.build_prefix + n] = v
                out.append(nr)
    return out


def _group(op, catalog):
    rows = run(op.children[0], catalog)
    groups: dict = {}
    for r in rows:
        k = tuple(_key_val(r, n) for n in op.keys)
        groups.setdefault(k, []).append(r)
    if not op.keys and not groups:
        groups[()] = []
    out = []
    for k, members in groups.items():
        nr = {}
        for name in op.keys:
            nr[name] = members[0][name] if members else (None, "int", 0)
        for name in op.carry:
            nr[name] = members[0][name] if members else (None, "int", 0)
        for a in op.aggregates:
            vals = []
            kinds = ("int", 0)
            for m in members:
                if a.expr is None:
                    vals.append((1, "int", 0))
                else:
                    v = ev(a.expr, m)
                    kinds = (v[1], v[2])
                    if v[0] is not None:
                        vals.append(v)
            if a.kind == "count":
                nr[a.name] = (len(vals), "int", 0)
            elif a.kind in ("sum", "sum_double"):
                if not vals:
                    nr[a.name] = (None, kinds[0], kinds[1])
                elif kinds[0] == "float" or a.kind == "sum_double":
                    nr[a.name] = (sum(_num(v) for v in vals), "float", 0)
                else:
                    s = max(v[2] for v in vals)
                    nr[a.name] = (sum(_rescale(v, s)[0] for v in vals),
                                  "dec" if s else "int", s)
            elif a.kind == "avg":
                if not vals:
                    nr[a.name] = (None, "float", 0)
                else:
                    nr[a.name] = (sum(_num(v) for v in vals) / len(vals),
                                  "float", 0)
            elif a.kind in ("min", "max"):
                if not vals:
                    nr[a.name] = (None, kinds[0], kinds[1])
                elif kinds[0] in ("str", "char"):
                    pick = (min if a.kind == "min" else max)(
                        v[0] for v in vals)
                    nr[a.name] = (pick, kinds[0], 0)
                else:
                    s = max(v[2] for v in vals)
                    scaled = [_rescale(v, s)[0] if s else _num(v)
                              for v in vals]
                    pick = (min if a.kind == "min" else max)(scaled)
                    nr[a.name] = (pick, "dec" if s else kinds[0], s)
            elif a.kind == "quantile_cont":
                if not vals:
                    nr[a.name] = (None, "float", 0)
                else:
                    xs = sorted(_num(v) for v in vals)
                    pos = (len(xs) - 1) * a.param
                    lo, hi = math.floor(pos), math.ceil(pos)
                    nr[a.name] = (xs[lo] + (pos - lo) * (xs[hi] - xs[lo]),
                                  "float", 0)
            else:
                raise Unsupported(f"aggregate {a.kind}")
        out.append(nr)
    return out


# ------------------------------------------------------------- comparison
def supports(plan) -> bool:
    try:
        for op in plan.walk():
            if not isinstance(op, (P.TableScan, P.Filter, P.Project,
                                   P.Limit, P.OrderBy, P.HashJoin,
                                   P.GroupAggregate, P.BroadcastScalar)):
                return False
    except Exception:  # noqa: BLE001
        return False
    return True


def render(v) -> str:
    """Tagged value -> display string matching exec/result.py conventions."""
    val, kind, scale = v
    if val is None:
        return "NULL"
    if kind == "dec":
        from .result import format_decimal
        return format_decimal(val, scale)
    if kind == "date":
        return days_to_date(int(val)).isoformat()
    if kind == "str":
        return val.decode("latin-1") if isinstance(val, bytes) else str(val)
    if kind == "char":
        return str(val)
    if kind == "float":
        return repr(float(val))
    if kind == "bool":
        return "true" if val else "false"
    return str(int(val))


def compare_to_strings(py_rows, names, leg_strings) -> str | None:
    """Order-insensitive comparison of leg-4 rows vs a to_strings result.
    Returns a description of the first difference, or None when equal.
    Floats compare with 1e-9 relative tolerance (summation order differs
    legitimately between a python sum and the device reduction tree)."""
    if len(py_rows) != len(leg_strings):
        return (f"row count: pyverify {len(py_rows)} vs engine "
                f"{len(leg_strings)}")

    def canon_py(r):
        out = []
        for n in names:
            v = r[n]
            if v[0] is not None and v[1] == "float":
                out.append(("f", round(float(v[0]), 6)))
            else:
                out.append(("s", render(v)))
        return out

    def canon_engine(cells):
        out = []
        for c in cells:
            try:
                f = float(c)
                if ("." in c or "e" in c or "inf" in c) and c != "NULL":
                    out.append(("f", round(f, 6)))
                    continue
            except ValueError:
                pass
            out.append(("s", c))
        return out

    a = sorted(map(canon_py, py_rows))
    b = sorted(map(canon_engine, leg_strings))
    for i, (x, y) in enumerate(zip(a, b)):
        if len(x) != len(y):
            return f"column count differs at row {i}"
        for cx, cy in zip(x, y):
            if cx[0] == "f" or cy[0] == "f":
                try:
                    fx = float(cx[1]) if cx[0] == "s" else cx[1]
                    fy = float(cy[1]) if cy[0] == "s" else cy[1]
                except ValueError:
                    return f"row {i}: {cx} vs {cy}"
                if not math.isclose(fx, fy, rel_tol=1e-9, abs_tol=1e-6):
                    return f"row {i}: {fx} vs {fy}"
            elif cx[1] != cy[1]:
                return f"row {i}: {cx[1]!r} vs {cy[1]!r}"
    return None
