"""Vectorized expression evaluation over columnar batches.

Counterpart of `duckdb_cubit_tpu/ops/expressions.py` for the expressions a
single-table WHERE/SELECT binds to: column refs, literals, exact DECIMAL
arithmetic (DuckDB's scale rules: add/sub align scales, mul adds scales, div
promotes to DOUBLE), comparisons (string literals resolve against the
column's sorted dictionary on the host, then compare int codes on the
device), three-valued AND/OR/NOT, IN lists, casts, CASE and IS NULL.

Stored columns are narrowed (int8/int16/int32, `storage/table.py`), and
torch keeps a narrow tensor's type against a Python scalar (an int8 column
times 100 stays int8).  So every integer tensor is widened to int64 before
any arithmetic, comparison or `where`; this is what the reference's
promotion through int64 does implicitly.

Expression classes that later slices port (LIKE, substring, date parts,
string functions, math functions, ...) exist by name so the shared binder
can refer to them, and raise NotImplementedError when constructed.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..types import (BOOL, DATE, DOUBLE, INT64, VARCHAR, DataType, TypeId,
                     date_to_days, decimal_to_int)


@dataclasses.dataclass
class ColMeta:
    """Bind-time metadata of a bound column."""
    dtype: DataType
    dictionary: np.ndarray | None = None
    # sorted distinct values (host) for small-domain columns
    domain: np.ndarray | None = None


class EvalContext:
    """A batch: named device tensors + column metadata."""

    def __init__(self, arrays: dict[str, torch.Tensor],
                 meta: dict[str, ColMeta],
                 valids: dict[str, Any] | None = None):
        self.arrays = arrays
        self.meta = meta
        # per-column NULL validity (None = all valid)
        self.valids = valids or {}


@dataclasses.dataclass(frozen=True)
class Typed:
    array: Any  # torch tensor, or a host scalar for constants
    dtype: DataType
    dictionary: np.ndarray | None = None
    # bool tensor marking non-NULL slots; None = all valid
    valid: Any = None
    # sorted distinct values (host metadata), when known small
    domain: np.ndarray | None = None


def and_valid(a, b):
    """Combine two validity arrays (None = all valid)."""
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def as_mask(t: Typed):
    """Boolean expression -> WHERE-mask semantics: NULL counts as false."""
    if t.valid is None:
        return t.array
    return t.array & t.valid


_NARROW_INTS = (torch.int8, torch.int16, torch.int32, torch.uint8)


def _wide(x):
    """Widen a narrow integer tensor to int64; anything else unchanged."""
    if isinstance(x, torch.Tensor) and x.dtype in _NARROW_INTS:
        return x.to(torch.int64)
    return x


def _is_host_scalar(x) -> bool:
    return isinstance(x, (int, float, bool, np.integer, np.floating))


def _as_tensor(x, device) -> torch.Tensor:
    """A value operand as a tensor: narrow ints widened, host scalars as
    0-d tensors of the engine's 64-bit types (never torch's float32
    default)."""
    if isinstance(x, torch.Tensor):
        return _wide(x)
    if isinstance(x, (bool, np.bool_)):
        return torch.tensor(bool(x), device=device)
    if isinstance(x, (int, np.integer)):
        return torch.tensor(int(x), dtype=torch.int64, device=device)
    return torch.tensor(float(x), dtype=torch.float64, device=device)


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


class Expr:
    def eval(self, ctx: EvalContext) -> Typed:
        raise NotImplementedError

    # sugar ---------------------------------------------------------------
    def __add__(self, o): return Arith("+", self, wrap(o))
    def __radd__(self, o): return Arith("+", wrap(o), self)
    def __sub__(self, o): return Arith("-", self, wrap(o))
    def __rsub__(self, o): return Arith("-", wrap(o), self)
    def __mul__(self, o): return Arith("*", self, wrap(o))
    def __rmul__(self, o): return Arith("*", wrap(o), self)
    def __truediv__(self, o): return Arith("/", self, wrap(o))
    def __rtruediv__(self, o): return Arith("/", wrap(o), self)
    def __eq__(self, o): return Compare("==", self, wrap(o))  # type: ignore
    def __ne__(self, o): return Compare("!=", self, wrap(o))  # type: ignore
    def __lt__(self, o): return Compare("<", self, wrap(o))
    def __le__(self, o): return Compare("<=", self, wrap(o))
    def __gt__(self, o): return Compare(">", self, wrap(o))
    def __ge__(self, o): return Compare(">=", self, wrap(o))
    def __and__(self, o): return BoolOp("and", self, wrap(o))
    def __or__(self, o): return BoolOp("or", self, wrap(o))
    def __invert__(self): return NotOp(self)
    def __hash__(self):  # Expr __eq__ builds nodes, so hash by identity
        return id(self)

    def between(self, lo, hi):
        return (self >= wrap(lo)) & (self <= wrap(hi))

    def isin(self, values):
        return InList(self, list(values))

    def like(self, pattern: str):
        return Like(self, pattern)

    def not_like(self, pattern: str):
        return NotOp(Like(self, pattern))

    def year(self):
        return ExtractYear(self)

    def cast_double(self):
        return CastDouble(self)


def wrap(v) -> "Expr":
    return v if isinstance(v, Expr) else Lit(v)


@dataclasses.dataclass(eq=False)
class Col(Expr):
    name: str

    def eval(self, ctx):
        m = ctx.meta[self.name]
        return Typed(ctx.arrays[self.name], m.dtype, m.dictionary,
                     ctx.valids.get(self.name), domain=m.domain)


@dataclasses.dataclass(eq=False)
class Lit(Expr):
    value: Any
    dtype: DataType | None = None

    def eval(self, ctx):
        v, dt = self.value, self.dtype
        if dt is None:
            if isinstance(v, bool):
                dt = BOOL
            elif isinstance(v, int):
                dt = INT64
            elif isinstance(v, float):
                dt = DOUBLE
            elif isinstance(v, str):
                dt = VARCHAR
            else:
                raise TypeError(f"cannot infer literal type of {v!r}")
        return Typed(v, dt, None)


def date_lit(s: str) -> Lit:
    return Lit(date_to_days(s), DATE)


def dec_lit(v, scale: int = 2) -> Lit:
    return Lit(decimal_to_int(v, scale), DataType(TypeId.DECIMAL, scale))


# -------------------------------------------------------------- arithmetic

def _rescale(t: Typed, scale: int) -> Typed:
    cur = t.dtype.scale if t.dtype.id == TypeId.DECIMAL else 0
    if cur == scale:
        return t
    assert scale > cur, "decimal downscale requires explicit rounding"
    factor = 10 ** (scale - cur)
    return Typed(_wide(t.array) * factor, DataType(TypeId.DECIMAL, scale),
                 None)


def _as_double(t: Typed):
    arr = t.array
    scale = t.dtype.scale if t.dtype.id == TypeId.DECIMAL else 0
    if t.dtype.id == TypeId.DOUBLE:
        return arr
    if _is_host_scalar(arr):
        return float(arr) / (10 ** scale)
    return arr.to(torch.float64) / (10 ** scale)


_DECIMALISH = (TypeId.INT32, TypeId.INT64, TypeId.DECIMAL, TypeId.DATE)


@dataclasses.dataclass(eq=False)
class Arith(Expr):
    op: str
    left: Expr
    right: Expr

    def eval(self, ctx):
        lt, rt = self.left.eval(ctx), self.right.eval(ctx)
        v = and_valid(lt.valid, rt.valid)
        if self.op == "%":
            # SQL mod: integer when both sides integer, else double fmod
            dev = _device_of(lt.array, rt.array)
            if TypeId.DOUBLE in (lt.dtype.id, rt.dtype.id) or \
                    TypeId.DECIMAL in (lt.dtype.id, rt.dtype.id):
                return Typed(torch.fmod(_as_tensor(_as_double(lt), dev),
                                        _as_tensor(_as_double(rt), dev)),
                             DOUBLE, None, v)
            la = _as_tensor(lt.array, dev).to(torch.int64)
            ra = _as_tensor(rt.array, dev).to(torch.int64)
            # SQL mod takes the DIVIDEND's sign (C semantics)
            rem = torch.sign(la) * (torch.abs(la) % torch.abs(ra))
            return Typed(rem, INT64, None, v)
        if self.op == "/" or TypeId.DOUBLE in (lt.dtype.id, rt.dtype.id):
            la, ra = _as_double(lt), _as_double(rt)
            out = {"+": lambda: la + ra, "-": lambda: la - ra,
                   "*": lambda: la * ra, "/": lambda: la / ra}[self.op]()
            return Typed(out, DOUBLE, None, v)
        assert lt.dtype.id in _DECIMALISH and rt.dtype.id in _DECIMALISH
        ls = lt.dtype.scale if lt.dtype.id == TypeId.DECIMAL else 0
        rs = rt.dtype.scale if rt.dtype.id == TypeId.DECIMAL else 0
        if self.op == "*":
            out_scale = ls + rs
            out = _wide(lt.array) * _wide(rt.array)
        else:
            out_scale = max(ls, rs)
            la = _wide(_rescale(lt, out_scale).array)
            ra = _wide(_rescale(rt, out_scale).array)
            out = la + ra if self.op == "+" else la - ra
        dt = DataType(TypeId.DECIMAL, out_scale) if out_scale else (
            DATE if DATE in (lt.dtype, rt.dtype) and self.op in "+-" else INT64)
        return Typed(out, dt, None, v)


# -------------------------------------------------------------- comparison

def _resolve_string_lit(col: Typed, lit_value: str):
    """Map a string literal to dictionary-code space for ordered compares.

    Returns (code, present): `code` is the insertion point of the literal in
    the sorted dictionary; `present` says whether it is an exact member.
    """
    d = col.dictionary
    assert d is not None, "string comparison on non-dictionary column"
    b = lit_value.encode() if isinstance(lit_value, str) else lit_value
    idx = int(np.searchsorted(d, b))
    present = idx < len(d) and d[idx] == b
    return idx, present


@dataclasses.dataclass(eq=False)
class Compare(Expr):
    op: str
    left: Expr
    right: Expr

    def eval(self, ctx):
        lt, rt = self.left.eval(ctx), self.right.eval(ctx)
        v = and_valid(lt.valid, rt.valid)
        # string column vs string literal -> code comparison
        if lt.dtype.id == TypeId.VARCHAR and isinstance(rt.array, str):
            return Typed(self._varchar_cmp(lt, rt.array), BOOL, None, v)
        if rt.dtype.id == TypeId.VARCHAR and isinstance(lt.array, str):
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}
            return Typed(
                Compare(flip[self.op], self.right, self.left)._varchar_cmp(rt, lt.array),
                BOOL, None, v)
        if lt.dtype.id == TypeId.CHAR1 and isinstance(rt.array, str):
            return Typed(self._num_cmp(lt.array, ord(rt.array)), BOOL, None, v)
        la, ra = lt, rt
        if TypeId.DOUBLE in (lt.dtype.id, rt.dtype.id):
            return Typed(self._num_cmp(_as_double(lt), _as_double(rt)), BOOL,
                         None, v)
        ls = lt.dtype.scale if lt.dtype.id == TypeId.DECIMAL else 0
        rs = rt.dtype.scale if rt.dtype.id == TypeId.DECIMAL else 0
        s = max(ls, rs)
        if ls != s:
            la = _rescale(lt, s)
        if rs != s:
            ra = _rescale(rt, s)
        return Typed(self._num_cmp(la.array, ra.array), BOOL, None, v)

    def _num_cmp(self, la, ra):
        la, ra = _wide(la), _wide(ra)
        return {"==": lambda: la == ra, "!=": lambda: la != ra,
                "<": lambda: la < ra, "<=": lambda: la <= ra,
                ">": lambda: la > ra, ">=": lambda: la >= ra}[self.op]()

    def _varchar_cmp(self, col: Typed, lit_value: str):
        idx, present = _resolve_string_lit(col, lit_value)
        codes = _wide(col.array)
        if self.op == "==":
            if not present:
                return torch.zeros(codes.shape, dtype=torch.bool,
                                   device=codes.device)
            return codes == idx
        if self.op == "!=":
            if not present:
                return torch.ones(codes.shape, dtype=torch.bool,
                                  device=codes.device)
            return codes != idx
        # ordered comparisons against the insertion point
        if self.op == "<":
            return codes < idx
        if self.op == ">=":
            return codes >= idx
        if self.op == "<=":
            return codes <= idx if present else codes < idx
        if self.op == ">":
            return codes > idx if present else codes >= idx
        raise ValueError(self.op)


@dataclasses.dataclass(eq=False)
class BoolOp(Expr):
    """AND/OR with SQL three-valued (Kleene) logic when NULLs are present.

    Values at unknown slots are forced to false so garbage in padding can
    never leak through an OR.
    """
    op: str
    left: Expr
    right: Expr

    def eval(self, ctx):
        lt, rt = self.left.eval(ctx), self.right.eval(ctx)
        if lt.valid is None and rt.valid is None:
            la, ra = lt.array, rt.array
            return Typed(la & ra if self.op == "and" else la | ra, BOOL, None)
        lk = lt.valid if lt.valid is not None else torch.ones_like(lt.array)
        rk = rt.valid if rt.valid is not None else torch.ones_like(rt.array)
        lv = lt.array & lk
        rv = rt.array & rk
        if self.op == "and":
            value = lv & rv
            known = (lk & rk) | (lk & ~lv) | (rk & ~rv)
        else:
            value = lv | rv
            known = (lk & rk) | lv | rv
        return Typed(value, BOOL, None, known)


@dataclasses.dataclass(eq=False)
class NotOp(Expr):
    child: Expr

    def eval(self, ctx):
        t = self.child.eval(ctx)
        if t.valid is None:
            return Typed(~t.array, BOOL, None)
        return Typed(~t.array & t.valid, BOOL, None, t.valid)


def _code_truth_table(col: Typed, match_fn) -> torch.Tensor:
    """Host-evaluate a predicate over the dictionary; gather per row.

    Evaluated per call (no cache keyed on dictionary identity, which can
    serve a stale table after a drop and re-create)."""
    d = col.dictionary
    assert d is not None
    codes = col.array
    table = torch.as_tensor(np.asarray(match_fn(d), dtype=np.bool_),
                            device=codes.device)
    return table[codes.to(torch.int64)]


@dataclasses.dataclass(eq=False)
class InList(Expr):
    child: Expr
    values: list

    def eval(self, ctx):
        ct = self.child.eval(ctx)
        if ct.dtype.id == TypeId.VARCHAR:
            targets = set(v.encode() if isinstance(v, str) else v for v in self.values)
            return Typed(
                _code_truth_table(ct, lambda d: np.isin(d, list(targets))),
                BOOL, None, ct.valid)
        values = self.values
        if ct.dtype.id == TypeId.CHAR1:
            # one-character strings against the stored byte codes (the
            # reference compares the bytes with the strings themselves and
            # so matches no row)
            values = [ord(v) if isinstance(v, str) else v for v in values]
        arr = _wide(ct.array)
        if _is_host_scalar(arr):
            return Typed(any(arr == v for v in values), BOOL, None, ct.valid)
        out = torch.zeros(arr.shape, dtype=torch.bool, device=arr.device)
        for v in values:
            out = out | (arr == v)
        return Typed(out, BOOL, None, ct.valid)


@dataclasses.dataclass(eq=False)
class CastDouble(Expr):
    child: Expr

    def eval(self, ctx):
        t = self.child.eval(ctx)
        return Typed(_as_double(t), DOUBLE, None, t.valid)


@dataclasses.dataclass(eq=False)
class CastInt(Expr):
    """CAST(x AS INTEGER/BIGINT): truncation toward zero (SQL semantics)
    for doubles and decimals; integers pass through."""
    child: Expr

    def eval(self, ctx):
        t = self.child.eval(ctx)
        if t.dtype.id == TypeId.DOUBLE:
            a = t.array
            if _is_host_scalar(a):
                return Typed(int(a), INT64, None, t.valid)
            return Typed(torch.trunc(a).to(torch.int64), INT64, None,
                         t.valid)
        if t.dtype.id == TypeId.DECIMAL:
            p = 10 ** t.dtype.scale
            a = t.array
            if _is_host_scalar(a):
                q = int(a) // p if a >= 0 else -((-int(a)) // p)
                return Typed(q, INT64, None, t.valid)
            a = a.to(torch.int64)
            q = torch.where(a >= 0, a // p, -((-a) // p))
            return Typed(q, INT64, None, t.valid)
        return Typed(t.array, t.dtype if t.dtype.id in
                     (TypeId.INT32, TypeId.INT64, TypeId.DATE)
                     else INT64, None, t.valid)


@dataclasses.dataclass(eq=False)
class Case(Expr):
    """CASE WHEN cond THEN a ELSE b END (single branch, vectorized where)."""
    cond: Expr
    then: Expr
    other: Expr

    def eval(self, ctx):
        ct = self.cond.eval(ctx)
        c = as_mask(ct)  # NULL condition selects the ELSE branch (SQL)
        t, o = self.then.eval(ctx), self.other.eval(ctx)
        dev = _device_of(c, t.array, o.array)
        c = _as_tensor(c, dev)
        v = None
        if t.valid is not None or o.valid is not None:
            tv = t.valid if t.valid is not None else torch.ones_like(c)
            ov = o.valid if o.valid is not None else torch.ones_like(c)
            v = torch.where(c, tv, ov)
        if TypeId.DOUBLE in (t.dtype.id, o.dtype.id):
            return Typed(torch.where(c, _as_tensor(_as_double(t), dev),
                                     _as_tensor(_as_double(o), dev)),
                         DOUBLE, None, v)
        ts = t.dtype.scale if t.dtype.id == TypeId.DECIMAL else 0
        os_ = o.dtype.scale if o.dtype.id == TypeId.DECIMAL else 0
        s = max(ts, os_)
        ta = _rescale(t, s).array if ts != s else t.array
        oa = _rescale(o, s).array if os_ != s else o.array
        dt = DataType(TypeId.DECIMAL, s) if s else t.dtype
        return Typed(torch.where(c, _as_tensor(ta, dev), _as_tensor(oa, dev)),
                     dt, None, v)


@dataclasses.dataclass(eq=False)
class IsNull(Expr):
    """IS NULL: true where the child's validity mask is unset.  The result
    itself is never NULL (three-valued logic collapses here)."""
    child: Expr

    def eval(self, ctx):
        t = self.child.eval(ctx)
        if t.valid is None:
            arr = t.array
            if not isinstance(arr, torch.Tensor) or arr.ndim == 0:
                return Typed(False, BOOL, None)
            return Typed(torch.zeros(arr.shape[0], dtype=torch.bool,
                                     device=arr.device), BOOL, None)
        return Typed(~t.valid, BOOL, None)


# ------------------------------------------------- not ported in this slice

class _NotPorted(Expr):
    """An expression the binder can emit but this port does not run yet:
    constructing it raises, so a query that needs it fails by name."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{type(self).__name__}: not ported yet")


class Like(_NotPorted): pass
class Substr(_NotPorted): pass
class ExtractYear(_NotPorted): pass
class ValidIf(_NotPorted): pass
class ExtractField(_NotPorted): pass
class StrMap(_NotPorted): pass
class StrLen(_NotPorted): pass
class Concat(_NotPorted): pass
class MathFn(_NotPorted): pass


class ExpressionError(ValueError):
    """A value-dependent expression failure (as in the reference)."""
