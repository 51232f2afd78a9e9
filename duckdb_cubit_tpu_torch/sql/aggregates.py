"""Aggregates the port binds and the JAX package does not.

`sql/binder.py` is a copy of the reference's binder; the few lines that
hand these names here are marked there as the port's own.

- `median(x)` and `quantile_cont(x, p)`, p a constant in [0, 1]: one
  holistic aggregate, `Aggregate("quantile_cont", x, name, param=p)`
  (median is p = 0.5), computed by `GroupAggregate` from the group's sorted
  values with DuckDB's continuous rule (position (n - 1) p, linear
  interpolation between its floor and its ceiling).  NULLs are ignored; a
  group with no value gives NULL; the result is a DOUBLE.
- `corr(y, x)`: lowered, as the variance family is, to exact per-group
  sums over the rows where both are non-NULL (n, Σx, Σy, Σxy, Σx², Σy²):
  the population covariance over the product of the population standard
  deviations, (n Σxy - Σx Σy) / sqrt((n Σx² - (Σx)²) (n Σy² - (Σy)²)).  As
  the SQL standard's CORR, it is NULL where either variance is zero, which
  takes in a group of one row and a group with no pair.
"""

from __future__ import annotations

from ..ops import expressions as E
from ..plan import physical as P
from . import ast as A

QUANTILES = ("median", "quantile_cont")
NAMES = QUANTILES + ("corr",)


def _error(msg: str):
    from .binder import BindError
    return BindError(msg)


def _fraction(node: A.FuncCall) -> float:
    """quantile_cont's p: a numeric literal in [0, 1]."""
    if node.name == "median":
        if len(node.args) != 1:
            raise _error("median() takes 1 argument")
        return 0.5
    if len(node.args) != 2:
        raise _error("quantile_cont() takes 2 arguments")
    p = node.args[1]
    if not isinstance(p, A.Literal) or isinstance(p.value, bool) or \
            not isinstance(p.value, (int, float)) or not 0 <= p.value <= 1:
        raise _error("quantile_cont()'s fraction must be a constant in "
                     "[0, 1]")
    return float(p.value)


def bind(binder, node: A.FuncCall, scope, aggs: list) -> E.Expr:
    """One call of `NAMES` over the aggregate's input: its `Aggregate`
    specs appended to `aggs`, and the expression over their outputs."""
    if node.distinct or node.star:
        raise _error(f"{node.name}(DISTINCT / *) unsupported")
    if node.name in QUANTILES:
        p = _fraction(node)
        gen = binder._gen("a")
        aggs.append(P.Aggregate("quantile_cont",
                                binder.to_expr(node.args[0], scope), gen,
                                param=p))
        return E.Col(gen)
    if len(node.args) != 2:
        raise _error("corr() takes 2 arguments")
    y, x = (binder.to_expr(a, scope).cast_double() for a in node.args)
    # a pair counts where both are non-NULL
    y = E.ValidIf(y, ~E.IsNull(x))
    x = E.ValidIf(x, ~E.IsNull(y))
    sums = {}
    for key, expr in (("x", x), ("y", y), ("xy", x * y), ("xx", x * x),
                      ("yy", y * y)):
        sums[key] = E.Col(binder._gen("a"))
        aggs.append(P.Aggregate("sum_double", expr, sums[key].name))
    n = E.Col(binder._gen("a"))
    aggs.append(P.Aggregate("count", x, n.name))
    var_x = n * sums["xx"] - sums["x"] * sums["x"]
    var_y = n * sums["yy"] - sums["y"] * sums["y"]
    cov = n * sums["xy"] - sums["x"] * sums["y"]
    return E.ValidIf(cov / E.MathFn("sqrt", var_x * var_y),
                     (var_x > E.Lit(0.0)) & (var_y > E.Lit(0.0)))
