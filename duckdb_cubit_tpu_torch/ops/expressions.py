"""Vectorized expression evaluation over columnar batches.

Counterpart of `duckdb_cubit_tpu/ops/expressions.py` for the expressions a
single-table WHERE/SELECT binds to: column refs, literals, exact DECIMAL
arithmetic (DuckDB's scale rules: add/sub align scales, mul adds scales, div
promotes to DOUBLE), comparisons (string literals resolve against the
column's sorted dictionary on the host, then compare int codes on the
device), three-valued AND/OR/NOT, IN lists, LIKE (matched over the
dictionary's bytes on the column's device, `ops/dict_like.py`) and
substring (over the dictionary on the host), each then a gather by code on
the device, year(date), casts, CASE and IS NULL.

Stored columns are narrowed (int8/int16/int32, `storage/table.py`), and
torch keeps a narrow tensor's type against a Python scalar (an int8 column
times 100 stays int8).  So every integer tensor is widened to int64 before
any arithmetic, comparison or `where`; this is what the reference's
promotion through int64 does implicitly.

Date parts (`ExtractField`), the per-dictionary string functions
(`StrMap`, `StrLen`, `Concat`), scalar math (`MathFn`) and `ValidIf` follow
the same pattern: host work per dictionary entry, device work per row.
Each evaluation over a dictionary is a `db.dict.<expression>` span
(`exec/profiler.py`) and adds its entries to `dict_entries`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import torch

from ..exec import profiler as PROF
from ..types import (BOOL, DATE, DOUBLE, INT64, VARCHAR, DataType, TypeId,
                     date_to_days, days_to_date, decimal_to_int)
from . import dict_like as DL

# dictionary entries evaluated (LIKE on the device; IN truth tables,
# substring, the string maps and concat's products on the host)
PROF.declare("dict_entries")


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
        # the arrays are one rank's row block of a relation on a mesh: a
        # dictionary built from the values seen would differ between ranks
        self.sharded = False


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
            # SQL mod takes the DIVIDEND's sign (C semantics); x % 0 is 0,
            # as in the reference (torch raises on the CPU and returns
            # garbage on the card, and padding slots may hold a 0 divisor)
            zero = ra == 0
            rem = torch.sign(la) * torch.where(
                zero, 0, torch.abs(la) % torch.where(zero, 1, torch.abs(ra)))
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


def _walked(n: int) -> int:
    """Count `n` dictionary entries walked on the host (`dict_entries`)."""
    PROF.count("dict_entries", n)
    return n


def _code_truth_table(col: Typed, match_fn, expr: str) -> torch.Tensor:
    """Host-evaluate a predicate over the dictionary; gather per row.

    Evaluated per call (no cache keyed on dictionary identity, which can
    serve a stale table after a drop and re-create)."""
    d = col.dictionary
    assert d is not None
    codes = col.array
    with PROF.dict_walk(expr, _walked(len(d))):
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
                _code_truth_table(ct, lambda d: np.isin(d, list(targets)),
                                  "InList"),
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


def like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


@dataclasses.dataclass(eq=False)
class Like(Expr):
    """LIKE on a dictionary column: the pattern is matched against every
    dictionary entry on the column's device (`ops/dict_like.py`: K6 on a
    card, over the dictionary's device copy), and the rows index that truth
    table by their codes there.  Computed on every call."""
    child: Expr
    pattern: str

    def eval(self, ctx):
        ct = self.child.eval(ctx)
        assert ct.dtype.id == TypeId.VARCHAR, "LIKE requires a varchar column"
        d = ct.dictionary
        assert d is not None
        codes = ct.array
        with PROF.dict_walk("Like", _walked(len(d))):
            table = DL.like_table(DL.dictionary_bytes(d, codes.device),
                                  self.pattern)
            return Typed(table[codes.to(torch.int64)], BOOL, None, ct.valid)


@dataclasses.dataclass(eq=False)
class Substr(Expr):
    """substring(col, start, length) on a dictionary column.

    Each dictionary entry maps to its substring on the host; the distinct
    substrings become a new sorted dictionary, and the device work is one
    int32 gather through the code remap table.
    """
    child: Expr
    start: int  # 1-based (SQL semantics)
    length: int

    def eval(self, ctx):
        ct = self.child.eval(ctx)
        assert ct.dtype.id == TypeId.VARCHAR and ct.dictionary is not None
        with PROF.dict_walk("Substr", _walked(len(ct.dictionary))):
            subs = np.array([s[self.start - 1: self.start - 1 + self.length]
                             for s in ct.dictionary])
            new_dict, remap = np.unique(subs, return_inverse=True)
            codes = torch.as_tensor(remap.astype(np.int32),
                                    device=ct.array.device)[_wide(ct.array)]
        return Typed(codes, VARCHAR, new_dict, ct.valid)


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


@dataclasses.dataclass(eq=False)
class ExtractYear(Expr):
    """year(date), through `_civil_from_days`."""
    child: Expr

    def eval(self, ctx):
        ct = self.child.eval(ctx)
        assert ct.dtype.id == TypeId.DATE
        y = _civil_from_days(ct.array)[0]
        return Typed(y, INT64, None, ct.valid, domain=_year_domain(ct.domain))


def _year_domain(day_domain):
    """Host: distinct civil years covered by a DATE column's day domain."""
    if day_domain is None:
        return None
    lo = days_to_date(int(day_domain[0])).year
    hi = days_to_date(int(day_domain[-1])).year
    return np.arange(lo, hi + 1, dtype=np.int64)


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
        if c.dtype != torch.bool:
            # a numeric condition (CASE WHEN 1 ...): nonzero is true
            c = c != 0
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


@dataclasses.dataclass(eq=False)
class ValidIf(Expr):
    """The child's values, NULL wherever `cond` is not true.  The binder
    gives aggregate rewrites exact NULL semantics with it (stddev over
    n <= 1 rows is NULL, not NaN)."""
    child: Expr
    cond: Expr

    def eval(self, ctx):
        t = self.child.eval(ctx)
        m = as_mask(self.cond.eval(ctx))
        v = m if t.valid is None else (t.valid & m)
        return Typed(t.array, t.dtype, t.dictionary, v)


def _civil_from_days(days: torch.Tensor):
    """days since the epoch -> (year, month, day): Hinnant's civil-from-days
    in int64 with floor division (days before 1970 are negative)."""
    z = days.to(torch.int64) + 719468
    era = _floor_div(z, 146097)
    doe = z - era * 146097
    yoe = _floor_div(doe - _floor_div(doe, 1460) + _floor_div(doe, 36524)
                     - _floor_div(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floor_div(yoe, 4) - _floor_div(yoe, 100))
    mp = _floor_div(5 * doy + 2, 153)
    d = doy - _floor_div(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


@dataclasses.dataclass(eq=False)
class ExtractField(Expr):
    """extract(year|month|day FROM date) and its date_part forms."""
    field: str
    child: Expr

    def eval(self, ctx):
        ct = self.child.eval(ctx)
        assert ct.dtype.id == TypeId.DATE
        host = _is_host_scalar(ct.array)
        y, m, d = _civil_from_days(torch.tensor(int(ct.array)) if host
                                   else ct.array)
        out = {"year": y, "month": m, "day": d}[self.field]
        if host:
            out = int(out)
        if self.field == "year":
            dom = _year_domain(ct.domain)
        else:
            dom = np.arange(1, 13 if self.field == "month" else 32,
                            dtype=np.int64)
        return Typed(out, INT64, None, ct.valid, domain=dom)


def _dict_strs(d) -> list[str]:
    """Dictionary entries as Python str (dictionaries are stored as |S)."""
    return [s.decode("utf-8", "replace") if isinstance(s, bytes) else str(s)
            for s in d]


def _gather_codes(table: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """table[codes] on the codes' device: a host lut applied per row."""
    return torch.as_tensor(table, device=codes.device)[_wide(codes)]


@dataclasses.dataclass(eq=False)
class StrMap(Expr):
    """Per-dictionary-entry string transform (upper/lower/trim/ltrim/rtrim):
    the entries map on the host, and the device work is one int32 gather
    through the code remap."""
    child: Expr
    op: str

    _FNS = {"upper": str.upper, "lower": str.lower, "trim": str.strip,
            "ltrim": str.lstrip, "rtrim": str.rstrip}

    def eval(self, ctx):
        ct = self.child.eval(ctx)
        fn = self._FNS[self.op]
        if ct.dtype.id == TypeId.CHAR1:
            # 256-entry byte lut
            lut = np.arange(256, dtype=np.int32)
            for b in range(256):
                s = fn(chr(b))
                lut[b] = ord(s) if len(s) == 1 else (0 if not s else b)
            return Typed(_gather_codes(lut, ct.array).to(ct.array.dtype),
                         ct.dtype, None, ct.valid)
        assert ct.dtype.id == TypeId.VARCHAR and ct.dictionary is not None, \
            f"{self.op}() needs a dictionary-encoded varchar"
        with PROF.dict_walk("StrMap", _walked(len(ct.dictionary))):
            mapped = np.array([fn(s) for s in _dict_strs(ct.dictionary)],
                              dtype="S")
            new_dict, remap = np.unique(mapped, return_inverse=True)
            codes = _gather_codes(remap.astype(np.int32), ct.array)
        return Typed(codes, VARCHAR, new_dict, ct.valid)


@dataclasses.dataclass(eq=False)
class StrLen(Expr):
    """length(varchar) through a per-code length table."""
    child: Expr

    def eval(self, ctx):
        ct = self.child.eval(ctx)
        if ct.dtype.id == TypeId.CHAR1:
            return Typed(torch.ones_like(ct.array, dtype=torch.int64), INT64,
                         None, ct.valid)
        assert ct.dtype.id == TypeId.VARCHAR and ct.dictionary is not None
        with PROF.dict_walk("StrLen", _walked(len(ct.dictionary))):
            lens = np.array([len(s) for s in _dict_strs(ct.dictionary)],
                            np.int64)
            out = _gather_codes(lens, ct.array)
        return Typed(out, INT64, None, ct.valid)


class ExpressionError(ValueError):
    """A value-dependent expression failure (as in the reference)."""


@dataclasses.dataclass(eq=False)
class Concat(Expr):
    """String concatenation (a || b) as a dictionary product: every pair of
    entries on the host, then one gather by (left code, right code).

    The product is bounded by a budget; past it the entries are built only
    for the code pairs that occur (one host pass over the codes), and a
    literal operand past it raises."""
    left: Expr
    right: Expr
    MAX_DICT = 1 << 20

    def eval(self, ctx):
        lt, rt = self.left.eval(ctx), self.right.eval(ctx)
        ld, lc = self._as_literal_or_col(lt)
        rd, rc = self._as_literal_or_col(rt)
        if len(ld) * len(rd) > self.MAX_DICT:
            if getattr(ctx, "sharded", False):
                raise NotImplementedError(
                    "concat past its dictionary budget builds its dictionary "
                    "from the rows it sees, which differ between the ranks "
                    "of a mesh")
            if lc is None or rc is None:
                raise ExpressionError(
                    f"concat dictionary would have {len(ld) * len(rd)} "
                    f"entries (budget {self.MAX_DICT}); reduce operand "
                    f"cardinality")
            return self._observed_pairs(lt, rt, ld, rd, lc, rc)
        with PROF.dict_walk("Concat", _walked(len(ld) * len(rd))):
            pairs = np.array([a + b for a in ld for b in rd], dtype="S")
            new_dict, remap = np.unique(pairs, return_inverse=True)
        remap = remap.reshape(len(ld), len(rd)).astype(np.int32)
        if lc is None and rc is None:
            return Typed(int(remap[0, 0]), VARCHAR, new_dict, None)
        if lc is None:
            codes = _gather_codes(remap[0], rc)
        elif rc is None:
            codes = _gather_codes(remap[:, 0], lc)
        else:
            codes = torch.as_tensor(remap, device=lc.device)[_wide(lc),
                                                             _wide(rc)]
        return Typed(codes, VARCHAR, new_dict, and_valid(lt.valid, rt.valid))

    def _observed_pairs(self, lt, rt, ld, rd, lc, rc):
        """Dictionary entries only for the code pairs that occur."""
        pair = (_wide(lc) * len(rd) + _wide(rc)).cpu().numpy()
        upairs, inverse = np.unique(pair, return_inverse=True)
        if len(upairs) > self.MAX_DICT:
            raise ExpressionError(
                f"concat produces {len(upairs)} distinct strings "
                f"(budget {self.MAX_DICT})")
        with PROF.dict_walk("Concat", _walked(len(upairs))):
            entries = np.array(
                [ld[int(p) // len(rd)] + rd[int(p) % len(rd)]
                 for p in upairs], dtype="S")
            new_dict, remap = np.unique(entries, return_inverse=True)
        codes = torch.as_tensor(remap.astype(np.int32)[inverse],
                                device=lc.device)
        return Typed(codes, VARCHAR, new_dict, and_valid(lt.valid, rt.valid))

    @classmethod
    def _as_literal_or_col(cls, t: Typed):
        if t.dtype.id == TypeId.VARCHAR and t.dictionary is not None:
            return _dict_strs(t.dictionary), t.array
        if t.dtype.id == TypeId.CHAR1:
            return [chr(b) for b in range(256)], t.array.to(torch.int32)
        # a string literal evaluates to a host str
        if isinstance(getattr(t, "array", None), str):
            return [t.array], None
        raise AssertionError("concat needs varchar/char operands")


def _math(torch_fn, np_fn, *xs):
    """A float function over tensors, or over host scalars (literal
    operands stay host values, as the other expressions keep them)."""
    if all(_is_host_scalar(x) for x in xs):
        with np.errstate(all="ignore"):
            return float(np_fn(*(np.float64(x) for x in xs)))
    dev = _device_of(*xs)
    return torch_fn(*(_as_tensor(x, dev) for x in xs))


@dataclasses.dataclass(eq=False)
class MathFn(Expr):
    """sqrt/abs/floor/ceil/round/exp/ln/log*/trig/power: scalar math, in
    float64 except abs of integers and round of decimals, which stay exact.
    round of a DOUBLE rounds half to even."""
    op: str
    child: Expr
    digits: int = 0
    other: Expr | None = None   # power(x, y)'s second operand

    _UNARY = {"exp": (torch.exp, np.exp), "ln": (torch.log, np.log),
              "log": (torch.log10, np.log10), "log2": (torch.log2, np.log2),
              "log10": (torch.log10, np.log10), "sin": (torch.sin, np.sin),
              "cos": (torch.cos, np.cos), "tan": (torch.tan, np.tan),
              "sqrt": (torch.sqrt, np.sqrt), "floor": (torch.floor, np.floor),
              "ceil": (torch.ceil, np.ceil)}

    def eval(self, ctx):
        t = self.child.eval(ctx)
        if self.op == "abs":
            if t.dtype.id in (TypeId.INT32, TypeId.INT64, TypeId.DECIMAL):
                a = t.array
                return Typed(abs(a) if _is_host_scalar(a)
                             else torch.abs(_wide(a)), t.dtype, None, t.valid)
            return Typed(_math(torch.abs, np.abs, _as_double(t)), DOUBLE,
                         None, t.valid)
        x = _as_double(t)
        if self.op in self._UNARY:
            return Typed(_math(*self._UNARY[self.op], x), DOUBLE, None,
                         t.valid)
        if self.op == "power":
            o = self.other.eval(ctx)
            return Typed(_math(torch.pow, np.power, x, _as_double(o)),
                         DOUBLE, None, and_valid(t.valid, o.valid))
        if self.op == "round":
            if t.dtype.id == TypeId.DECIMAL and self.digits <= t.dtype.scale:
                # a decimal stays exact: rescale in int64, adding half of
                # the dropped unit with the value's sign, then flooring
                drop = t.dtype.scale - self.digits
                if drop == 0:
                    return t
                p = 10 ** drop
                a = t.array
                if _is_host_scalar(a):
                    out = (int(a) + (p // 2 if a >= 0 else -(p // 2))) // p
                else:
                    a = _wide(a)
                    half = torch.where(a >= 0, p // 2, -(p // 2))
                    out = _floor_div(a + half, p)
                return Typed(out, DataType(TypeId.DECIMAL, self.digits),
                             None, t.valid)
            f = 10.0 ** self.digits
            return Typed(_math(lambda v: torch.round(v * f) / f,
                               lambda v: np.round(v * f) / f, x),
                         DOUBLE, None, t.valid)
        raise ValueError(self.op)
