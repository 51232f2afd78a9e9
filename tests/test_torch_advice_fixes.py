"""The advisor-finding regressions on the torch port, against the JAX
package: the twin of `tests/test_advice_fixes.py`.

Float order / partition / group / join keys are exact; stddev of a tiny
group is NULL; windows without ORDER BY treat the partition as one peer
group; last_value under a ROWS frame is the current row; small integer
domains through extract(year) group exactly; statistics refresh after DML;
a concatenation past the dictionary budget takes the observed pairs (run
profiled, `sql(..., profile=True)`); greatest / least ignore NULLs; DESC
sorts hold at the int64 extremes.  Each query runs on both packages over
the same numpy inputs (made from a seed where random); the port's rows
must equal the reference's (its eager path) and the reference test's
literal rows.
"""

import datetime

import numpy as np
import pytest

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu.ops import expressions as RE
from duckdb_cubit_tpu.types import DATE as REF_DATE
from duckdb_cubit_tpu_torch.api import Connection
from duckdb_cubit_tpu_torch.ops import expressions as E
from duckdb_cubit_tpu_torch.types import DATE
from test_torch_staged import one_intra_op_thread  # noqa: F401


def pair(tables: dict, schema=None):
    """A reference and a port connection over the same numpy tables."""
    ref, port = RefConnection(), Connection(device="cpu")
    for name, cols in tables.items():
        ref.register_numpy(name, cols, None if schema is None
                           else {k: REF_DATE for k in schema})
        port.register_numpy(name, cols, None if schema is None
                            else {k: DATE for k in schema})
    return ref, port


def both(conns, sql):
    """The port's rows, held equal to the reference's eager rows."""
    ref, port = conns
    got = port.sql(sql).strings()
    want = RR.to_strings(ref.executor.execute(ref.binder.bind_sql(sql),
                                              compiled=False))
    assert got == want, (got, want)
    return got


T = {"t": {"y": np.array([2.5, 2.4, 1.1, 2.0], np.float64),
           "g": np.array([1, 1, 2, 2], np.int64),
           "v": np.array([10, 20, 30, 40], np.int64)}}


@pytest.fixture(scope="module")
def conns():
    return pair(T)


def test_window_float_order_key(conns):
    rows = both(conns, "SELECT y, row_number() OVER (ORDER BY y) AS r "
                       "FROM t ORDER BY y")
    assert [r[1] for r in rows] == ["1", "2", "3", "4"]
    assert [r[0] for r in rows] == ["1.1", "2.0", "2.4", "2.5"]


def test_window_float_order_key_desc(conns):
    rows = both(conns, "SELECT y, row_number() OVER (ORDER BY y DESC) AS r "
                       "FROM t ORDER BY y")
    assert [r[1] for r in rows] == ["4", "3", "2", "1"]


def test_order_by_negative_floats():
    rows = both(pair({"t": {"y": np.array([-2.5, 3.0, -0.5, 0.0, -2.4])}}),
                "SELECT y, rank() OVER (ORDER BY y) AS r FROM t ORDER BY y")
    assert [r[1] for r in rows] == ["1", "2", "3", "4", "5"]
    assert rows[0][0] == "-2.5" and rows[1][0] == "-2.4"


def test_group_by_float_key(conns):
    rows = both(conns, "SELECT y, count(*) AS c FROM t GROUP BY y "
                       "ORDER BY y")
    assert len(rows) == 4 and all(r[1] == "1" for r in rows)


def test_min_max_double(conns):
    rows = both(conns, "SELECT g, min(y) AS lo, max(y) AS hi FROM t "
                       "GROUP BY g ORDER BY g")
    assert rows[0][1:] == ["2.4", "2.5"] and rows[1][1:] == ["1.1", "2.0"]


def test_ungrouped_min_max_double(conns):
    assert both(conns, "SELECT min(y) AS lo, max(y) AS hi FROM t") == \
        [["1.1", "2.5"]]


def test_join_on_double_key_including_two():
    c = pair({"a": {"k": np.array([2.0, 1.5, 7.25]),
                    "va": np.array([1, 2, 3], np.int64)},
              "b": {"k": np.array([2.0, 7.25, 9.0]),
                    "vb": np.array([10, 20, 30], np.int64)}})
    assert both(c, "SELECT a.va, b.vb FROM a, b WHERE a.k = b.k "
                   "ORDER BY a.va") == [["1", "10"], ["3", "20"]]


def test_range_join_double_condition():
    c = pair({"a": {"x": np.array([1.5, 2.05, 3.5]),
                    "ia": np.array([0, 1, 2], np.int64)},
              "b": {"y": np.array([2.0, 2.1]),
                    "ib": np.array([0, 1], np.int64)}})
    assert both(c, "SELECT ia, ib FROM a, b WHERE a.x < b.y "
                   "ORDER BY ia, ib") == [["0", "0"], ["0", "1"], ["1", "1"]]


def test_stddev_single_row_is_null():
    c = pair({"t": {"y": np.array([4.2]), "g": np.array([1], np.int64)}})
    assert both(c, "SELECT stddev(y) AS s, var_samp(y) AS v FROM t") == \
        [["NULL", "NULL"]]


def test_stddev_groups(conns):
    rows = both(conns, "SELECT g, stddev(v) AS s FROM t GROUP BY g "
                       "ORDER BY g")
    assert rows[0][1].startswith("7.07106781")
    assert rows[1][1].startswith("7.07106781")


def test_var_pop_zero_rows_vs_one():
    c = pair({"t": {"y": np.array([4.2])}})
    assert both(c, "SELECT var_pop(y) AS v FROM t") == [["0.0"]]


def test_rank_no_order_by(conns):
    rows = both(conns, "SELECT g, rank() OVER (PARTITION BY g) AS r, "
                       "dense_rank() OVER (PARTITION BY g) AS d FROM t "
                       "ORDER BY g, r")
    assert all(r[1] == "1" and r[2] == "1" for r in rows)


def test_last_value_rows_frame():
    c = pair({"t": {"o": np.array([1, 1, 2], np.int64),
                    "v": np.array([10, 20, 30], np.int64)}})
    rows = both(c, "SELECT v, last_value(v) OVER (ORDER BY o ROWS BETWEEN "
                   "UNBOUNDED PRECEDING AND CURRENT ROW) AS lv FROM t "
                   "ORDER BY v")
    assert [r[0] for r in rows] == [r[1] for r in rows]


def test_dense_domain_grouping_by_year():
    rng = np.random.default_rng(0)
    days = rng.integers(8400, 10650, 50_000)        # ~1993-1999
    vals = rng.integers(0, 100, 50_000)
    rows = both(pair({"o": {"d": days, "v": vals}}, schema=["d"]),
                "SELECT y, count(*) AS n, sum(v) AS s FROM "
                "(SELECT extract(year FROM d) AS y, v FROM o) AS t "
                "GROUP BY y ORDER BY y")
    years = np.array([(datetime.date(1970, 1, 1)
                       + datetime.timedelta(days=int(d))).year
                      for d in days])
    assert [int(r[0]) for r in rows] == sorted(set(years.tolist()))
    for r in rows:
        sel = years == int(r[0])
        assert int(r[1]) == int(sel.sum())
        assert int(r[2]) == int(vals[sel].sum())


def test_stale_stats_after_dml():
    c = pair({"t": {"v": np.array([1, 2, 3], np.int64)}})
    q = "SELECT count(*) AS c FROM t WHERE v > 100"
    assert both(c, q) == [["0"]]
    for stmt, want in (("INSERT INTO t VALUES (200)", "1"),
                       ("UPDATE t SET v = 500 WHERE v = 2", "2"),
                       ("DELETE FROM t WHERE v = 500", "1")):
        for conn in c:
            conn.sql(stmt)
        assert both(c, q) == [[want]]


def test_concat_large_dict_observed_pairs(monkeypatch):
    """300 x 300 strings would make a 90,000-entry product dictionary; a
    budget of 1,000 takes the observed-pairs path.  The port's query runs
    profiled, as the reference test runs it."""
    strs = np.array([f"s{i:03d}" for i in range(300)], dtype="U8")
    rng = np.random.default_rng(0)
    a = strs[rng.integers(0, 300, 64)]
    b = strs[rng.integers(0, 300, 64)]
    ref, port = pair({"t": {"a": a, "b": b}})
    monkeypatch.setattr(E.Concat, "MAX_DICT", 1000)
    monkeypatch.setattr(RE.Concat, "MAX_DICT", 1000)
    got = port.sql("SELECT a || b AS ab FROM t", profile=True).strings()
    assert port.executor.profiler is not None
    want = ref.sql("SELECT a || b AS ab FROM t", profile=True).strings()
    assert [r[0] for r in got] == [r[0] for r in want] == \
        [x + y for x, y in zip(a, b)]


def test_greatest_least_ignore_nulls():
    ref, port = RefConnection(), Connection(device="cpu")
    for conn in (ref, port):
        conn.sql("CREATE TABLE gn (a INTEGER, b INTEGER)")
        conn.sql("INSERT INTO gn VALUES (1, 0), (0, 5), (0, 0), (3, 2)")
    assert both((ref, port),
                "SELECT greatest(nullif(a, 0), nullif(b, 0)) AS g, "
                "least(nullif(a, 0), nullif(b, 0)) AS l FROM gn") == \
        [["1", "1"], ["5", "5"], ["NULL", "NULL"], ["3", "2"]]
    assert both((ref, port), "SELECT greatest(a, NULL) AS g FROM gn "
                             "WHERE a = 3") == [["3"]]


@pytest.mark.parametrize("desc", [True, False])
def test_desc_sort_extreme_int64(desc):
    vals = np.array([-(2**63), 2**63 - 1, 0, 2**62, -(2**62), 7],
                    dtype=np.int64)
    rows = both(pair({"ext": {"v": vals}}),
                f"SELECT v FROM ext ORDER BY v{' DESC' if desc else ''}")
    assert [r[0] for r in rows] == [str(v) for v in
                                    sorted(vals.tolist(), reverse=desc)]
