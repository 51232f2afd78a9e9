"""Non-equi joins: the torch port's RangeJoin against the JAX package's, on
the CPU.

The twin of `tests/test_range_join.py`.  Both operators read the same
numpy-seeded relations through the source operators of
`tests/test_torch_hashjoin.py` and must give the same rows as `to_strings`
renders them, in order (both sort the build side stably, so the pairs come
out in the same order): each op (< <= > >= ==), residual conditions, SEMI /
ANTI / LEFT, the cross product, NULL condition values, DOUBLE conditions,
band joins over disjoint and overlapping bands, and a too-small
`out_capacity` that the port's executor regrows.  Then the
binder's non-equi joins through SQL on both packages at SF0.01.

One case is a fault of the reference, marked: a DECIMAL side against an
INTEGER side is compared there on the raw scaled integers, so `x >= lo`
with x = 1.50 and lo = 1 fails; the port compares at one scale and returns
SQL's rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_cubit_tpu import types as RT
from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu.ops.expressions import Col as RCol
from duckdb_cubit_tpu.plan import physical as RP
from duckdb_cubit_tpu_torch import types as PT
from duckdb_cubit_tpu_torch.api import Connection, connect
from duckdb_cubit_tpu_torch.exec import result as PR
from duckdb_cubit_tpu_torch.exec.executor import Executor
from duckdb_cubit_tpu_torch.ops.expressions import Col as PCol
from duckdb_cubit_tpu_torch.plan import physical as P
from duckdb_cubit_tpu_torch.storage.table import Catalog

from test_torch_hashjoin import PortGiven, RefGiven


def side(seed, n, key_range, names, masked=0.1, nulls=None, floats=False):
    rng = np.random.default_rng(seed)
    cols = {}
    for name in names:
        cols[name] = (np.round(rng.normal(size=n) * 10, 2) if floats
                      else rng.integers(0, key_range, n).astype(np.int64))
    mask = rng.random(n) >= masked
    valid = None if nulls is None else {
        nulls: rng.random(n) >= 0.2}
    return cols, mask, valid


def ref_rel(s):
    cols, mask, valid = s
    out = {}
    for n, a in cols.items():
        v = None if valid is None or n not in valid else jnp.asarray(valid[n])
        dt = RT.DOUBLE if a.dtype.kind == "f" else RT.INT64
        out[n] = RP.RelColumn(jnp.asarray(a), dt, valid=v)
    return RP.Relation(out, jnp.asarray(mask), len(mask))


def port_rel(s):
    cols, mask, valid = s
    out = {}
    for n, a in cols.items():
        v = None if valid is None or n not in valid else \
            torch.as_tensor(valid[n])
        dt = PT.DOUBLE if a.dtype.kind == "f" else PT.INT64
        out[n] = P.RelColumn(torch.as_tensor(a), dt, valid=v)
    return P.Relation(out, torch.as_tensor(mask), len(mask))


def conds(pairs, col):
    return [(col(p) if isinstance(p, str) else p(col), op,
             col(b) if isinstance(b, str) else b(col)) for p, op, b in pairs]


def run_both(probe, build, pairs, ref_cap=8192, **kwargs):
    """-> (port rows, reference rows, the port's executor)."""
    rj = RP.RangeJoin(RefGiven(ref_rel(probe)), RefGiven(ref_rel(build)),
                      conds(pairs, RCol), out_capacity=ref_cap,
                      **{k: v for k, v in kwargs.items()
                         if k != "out_capacity"})
    want = RR.to_strings(rj.execute(RP.ExecContext(None)))
    pj = P.RangeJoin(PortGiven(port_rel(probe)), PortGiven(port_rel(build)),
                     conds(pairs, PCol), **kwargs)
    ex = Executor(Catalog())
    got = PR.to_strings(ex.execute(pj, optimize=False))
    return got, want, ex


PROBE = side(0, 40, 50, ["x", "x2"], nulls="x")
BUILD = side(1, 30, 50, ["y", "y2"], nulls="y2")


@pytest.mark.parametrize("op,fn", [
    ("<", np.less), ("<=", np.less_equal),
    (">", np.greater), (">=", np.greater_equal), ("==", np.equal)])
def test_each_op_matches_reference_and_oracle(op, fn):
    got, want, _ = run_both(PROBE, BUILD, [("x", op, "y")],
                            out_capacity=8192)
    assert got == want
    (px, pm, pv), (by, bm, _) = PROBE, BUILD
    a_ok = pm & pv["x"]
    pairs = fn(px["x"][:, None], by["y"][None, :]) & a_ok[:, None] & \
        bm[None, :]
    assert len(got) == int(pairs.sum())


@pytest.mark.parametrize("pairs", [
    [("x", "<", "y"), (lambda c: c("x") + c("x"), ">", "y")],
    [("x", ">=", "y"), ("x2", "<", "y2"), ("x2", "!=", "y")],
    [("x", "==", "y"), ("x2", "<=", "y2")],
], ids=["iejoin_shape", "two_residuals_null_build", "equi_first"])
def test_residual_conditions(pairs):
    pairs = [(p, "<" if op == "!=" else op, b) for p, op, b in pairs]
    got, want, _ = run_both(PROBE, BUILD, pairs, out_capacity=8192)
    assert got == want and got


@pytest.mark.parametrize("join_type", ["semi", "anti", "left"])
@pytest.mark.parametrize("op", ["<", ">=", "=="])
def test_semi_anti_left(join_type, op):
    got, want, _ = run_both(PROBE, BUILD, [("x", op, "y")],
                            join_type=join_type, out_capacity=8192)
    assert got == want


def test_semi_anti_with_residual():
    pairs = [("x", "<", "y"), ("x2", ">", "y2")]
    for jt in ("semi", "anti"):
        got, want, _ = run_both(PROBE, BUILD, pairs, join_type=jt,
                                out_capacity=8192)
        assert got == want


def test_cross_product():
    got, want, _ = run_both(PROBE, BUILD, [], out_capacity=8192)
    assert got == want
    assert len(got) == int(PROBE[1].sum()) * int(BUILD[1].sum())


def test_double_conditions():
    probe = side(2, 35, 0, ["x", "x2"], floats=True)
    build = side(3, 25, 0, ["y", "y2"], floats=True)
    for op in ("<", ">="):
        got, want, _ = run_both(probe, build, [("x", op, "y"),
                                               ("x2", "<", "y2")],
                                out_capacity=8192)
        assert got == want and got


def test_small_capacity_regrows_through_the_executor():
    """An `out_capacity` far below the pair count fails the recoverable
    `expansion` check; the executor doubles it until the pairs fit."""
    probe = side(4, 300, 50, ["x", "x2"])
    build = side(5, 200, 50, ["y", "y2"])
    got, want, ex = run_both(probe, build, [("x", "<", "y")],
                             ref_cap=65536, out_capacity=16)
    assert got == want
    assert ex.retry_count >= 2


def bands(seed, n, overlapping):
    rng = np.random.default_rng(seed)
    lo = (rng.integers(0, 400, n) if overlapping
          else rng.permutation(n) * 10).astype(np.int64)
    width = rng.integers(1, 60, n) if overlapping else np.full(n, 10)
    return {"lo": lo, "hi": lo + width.astype(np.int64),
            "tag": np.arange(n, dtype=np.int64)}, rng.random(n) >= 0.1, None


@pytest.mark.parametrize("overlapping", [False, True],
                         ids=["disjoint_bands", "overlapping_bands"])
def test_band_join(overlapping):
    """x >= lo AND x < hi (AND x2 < hi).  Disjoint bands: `hi` ascends in
    the order sorted by `lo`, so the port intersects the two ranges and
    expands one pair a probe row; a capacity that holds only those pairs
    needs no retry.  Overlapping bands take the plain range and the
    residual re-check."""
    probe = side(6, 500, 400, ["x", "x2"], nulls="x2")
    build = bands(7, 40, overlapping)
    pairs = [("x", ">=", "lo"), ("x", "<", "hi"), ("x2", "<", "hi")]
    got, want, ex = run_both(probe, build, pairs, ref_cap=65536,
                             out_capacity=None if overlapping else 512)
    assert got == want and got
    assert ex.retry_count == 0


# ------------------------------------------------------------------ SQL
@pytest.fixture(scope="module")
def conns():
    return ref_connect(sf=0.01), connect(0.01, device="cpu")


@pytest.mark.parametrize("sql", [
    "SELECT count(*) AS c FROM nation n1, nation n2 "
    "WHERE n1.n_nationkey < n2.n_nationkey",
    "SELECT count(*) AS c FROM region, nation",
    "SELECT count(*) AS c FROM nation n1, nation n2 "
    "WHERE n1.n_nationkey < n2.n_nationkey "
    "AND n1.n_regionkey > n2.n_regionkey",
    "SELECT count(*) AS c FROM nation n, region r "
    "WHERE n.n_regionkey = r.r_regionkey AND n.n_nationkey > r.r_regionkey",
    "SELECT count(*) AS c FROM supplier s, nation n "
    "WHERE s.s_nationkey < n.n_nationkey",
    "SELECT n1.n_name, n2.n_name AS m FROM nation n1, nation n2 "
    "WHERE n1.n_nationkey + 20 <= n2.n_nationkey "
    "ORDER BY n1.n_name, m",
    "SELECT o_orderpriority, count(*) AS c FROM orders o, nation n "
    "WHERE o.o_totalprice >= n.n_nationkey * 10000.25 "
    "AND o.o_totalprice < n.n_nationkey * 10000.25 + 5000.25 "
    "GROUP BY o_orderpriority ORDER BY o_orderpriority",
])
def test_sql_matches_reference(conns, sql):
    ref, port = conns
    assert port.sql(sql).strings() == ref.sql(sql).strings()


def test_sql_oracle_counts(conns):
    _, port = conns
    assert port.sql("SELECT count(*) AS c FROM nation n1, nation n2 "
                    "WHERE n1.n_nationkey < n2.n_nationkey"
                    ).strings() == [[str(25 * 24 // 2)]]
    assert port.sql("SELECT count(*) AS c FROM region, nation"
                    ).strings() == [["125"]]


def test_decimal_against_integer_follows_sql():
    """The reference's fault (marked): DECIMAL x against INTEGER lo / hi is
    compared on the raw scaled integers there, and the band join returns
    nothing; the port brings both sides to one scale."""
    sql = ("SELECT x, lo FROM a, b WHERE a.x >= b.lo AND a.x < b.hi "
           "ORDER BY x")
    out = []
    for c in (RefConnection(), Connection(device="cpu")):
        c.sql("CREATE TABLE a (x DECIMAL(12,2))")
        c.sql("INSERT INTO a VALUES (1.50), (2.50), (3.00)")
        c.sql("CREATE TABLE b (lo INTEGER, hi INTEGER)")
        c.sql("INSERT INTO b VALUES (1, 2), (2, 3), (3, 4)")
        out.append(c.sql(sql).strings())
        # a plain filter scales correctly in both
        assert c.sql("SELECT count(*) AS n FROM a WHERE x >= 2").strings() \
            == [["2"]]
    ref_rows, port_rows = out
    assert ref_rows == []                      # the reference's fault
    assert port_rows == [["1.50", "1"], ["2.50", "2"], ["3.00", "3"]]


def test_decimal_band_against_integer_bounds_at_sf001(conns):
    """The same fault on TPC-H columns: the port's band join equals a numpy
    oracle over the DECIMAL o_totalprice and INTEGER bounds."""
    _, port = conns
    got = port.sql("SELECT count(*) AS c FROM orders o, nation n "
                   "WHERE o.o_totalprice >= n.n_nationkey * 10000 "
                   "AND o.o_totalprice < n.n_nationkey * 10000 + 5000"
                   ).strings()
    orders = port.catalog.table("orders")
    price = orders.columns["o_totalprice"].host[:orders.num_rows] / 100.0
    keys = np.arange(25)
    want = int(((price[:, None] >= keys * 10000)
                & (price[:, None] < keys * 10000 + 5000)).sum())
    assert got == [[str(want)]]
