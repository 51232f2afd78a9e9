"""Scalar and statistical functions: the torch port's SQL path against the
JAX package's, on the CPU.

The twin of `tests/test_functions.py` without its window tests: string
transforms on dictionary and CHAR(1) columns, concatenation, date parts,
stddev / variance grouped and ungrouped, math.  Added here: dates before
1970 (floor division on negative day counts), half-way rounding (DOUBLE
half to even, DECIMAL exact), sqrt / ln of negatives, and concatenation
past its dictionary budget.  Rows must match the reference as `to_strings`
renders them; DOUBLE cells within the 1e-9 relative tolerance of
`tpch/answers.cells_equal`.
"""

import numpy as np
import pytest

from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.types import DATE as REF_DATE
from duckdb_cubit_tpu_torch.api import Connection
from duckdb_cubit_tpu_torch.ops import expressions as PE
from duckdb_cubit_tpu_torch.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.types import DATE, date_to_days

COLUMNS = {
    "s": np.array(["  Foo ", "bar", "BAZ", "bar"], dtype="U8"),
    "d": np.array([9496, 9527, 9558, 9586], np.int64),  # 1996-01..04
    "v": np.array([2.0, 4.0, 4.0, 6.0], np.float64),
    "g": np.array([1, 1, 2, 2], np.int64),
    "o": np.array([10, 20, 5, 1], np.int64),
    "x": np.array([5, 7, 10, 20], np.int64),
}
# dates on both sides of the epoch, month ends and a leap day
OLD_DAYS = [date_to_days(s) for s in (
    "1969-12-31", "1969-01-01", "1900-02-28", "1600-02-29", "0001-01-01",
    "1970-01-01", "2000-02-29", "1999-12-31")]


@pytest.fixture(scope="module")
def conns():
    ref, port = RefConnection(), Connection(device="cpu")
    ref.register_numpy("t", COLUMNS, schema={"d": REF_DATE})
    port.register_numpy("t", COLUMNS, schema={"d": DATE})
    old = {"d": np.array(OLD_DAYS, np.int64),
           "h": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 0.125, -1.25, 7.0]),
           "c": np.frombuffer(b"aZ z9_Qm", np.uint8).copy()}
    ref.register_numpy("old", old, schema={"d": REF_DATE})
    port.register_numpy("old", old, schema={"d": DATE})
    for c in (ref, port):
        c.sql("CREATE TABLE dec (p DECIMAL(12,2), q DECIMAL(12,3))")
        c.sql("INSERT INTO dec VALUES (1.25, 0.125), (-1.25, -0.125), "
              "(2.35, 2.345), (-0.05, -2.355), (0.00, 9.995)")
    return ref, port


def assert_same(conns, sql):
    ref, port = conns
    got, want = port.sql(sql).strings(), ref.sql(sql).strings()
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(cells_equal(a, b)
                                        for a, b in zip(g, w)), (g, w)
    return got


def test_string_functions(conns):
    rows = assert_same(conns, "SELECT upper(s) AS u, lower(s) AS lo, "
                       "trim(s) AS tr, length(s) AS l, s || '_x' AS cx "
                       "FROM t")
    assert rows[0] == ["  FOO ", "  foo ", "Foo", "6", "  Foo _x"]
    assert rows[1] == ["BAR", "bar", "bar", "3", "bar_x"]
    assert rows[2] == ["BAZ", "baz", "BAZ", "3", "BAZ_x"]


def test_ltrim_rtrim_and_literal_concat(conns):
    rows = assert_same(conns, "SELECT ltrim(s) AS a, rtrim(s) AS b, "
                       "'<' || s AS c, 'a' || 'b' AS d FROM t")
    assert rows[0] == ["Foo ", "  Foo", "<  Foo ", "ab"]


def test_concat_col_col(conns):
    rows = assert_same(conns, "SELECT trim(s) || trim(s) AS ss FROM t")
    assert [r[0] for r in rows] == ["FooFoo", "barbar", "BAZBAZ", "barbar"]


def test_char1_string_functions(conns):
    rows = assert_same(conns, "SELECT upper(c) AS u, lower(c) AS lo, "
                       "length(c) AS l FROM old")
    assert [r[0] for r in rows] == list("AZ Z9_QM")
    assert {r[2] for r in rows} == {"1"}


def test_concat_past_its_budget_builds_the_observed_pairs(conns,
                                                          monkeypatch):
    """Past MAX_DICT (3 x 3 entries against 4) the port builds entries only
    for the 3 code pairs that occur, and gives the rows of the full
    product; a literal operand past the budget raises."""
    _, port = conns
    sql = "SELECT s || trim(s) AS ss FROM t"
    want = port.sql(sql).strings()
    monkeypatch.setattr(PE.Concat, "MAX_DICT", 4)
    assert port.sql(sql).strings() == want
    monkeypatch.setattr(PE.Concat, "MAX_DICT", 2)
    with pytest.raises(PE.ExpressionError, match="budget"):
        port.sql("SELECT s || 'x' AS sx FROM t")


def test_date_parts(conns):
    rows = assert_same(conns, "SELECT extract(month FROM d) AS m, "
                       "date_part('day', d) AS dd, "
                       "extract(year FROM d) AS y FROM t")
    assert [r[0] for r in rows] == ["1", "2", "3", "3"]
    assert rows[0] == ["1", "1", "1996"]
    assert rows[3] == ["3", "31", "1996"]


def test_date_parts_before_1970(conns):
    rows = assert_same(conns, "SELECT extract(year FROM d) AS y, "
                       "extract(month FROM d) AS m, extract(day FROM d) AS dd "
                       "FROM old")
    assert rows == [["1969", "12", "31"], ["1969", "1", "1"],
                    ["1900", "2", "28"], ["1600", "2", "29"], ["1", "1", "1"],
                    ["1970", "1", "1"], ["2000", "2", "29"],
                    ["1999", "12", "31"]]


def test_date_part_of_a_literal(conns):
    """A date literal's part stays a host value (the reference calls
    `.astype` on the Python int and raises, so only the port is held)."""
    _, port = conns
    assert port.sql("SELECT extract(month FROM DATE '1965-03-04') AS m, "
                    "extract(day FROM DATE '1965-03-04') AS d").strings() \
        == [["3", "4"]]


def test_date_part_grouping(conns):
    """Month parts carry their 1..12 domain: dense grouping."""
    assert_same(conns, "SELECT m, count(*) AS n FROM (SELECT extract(month "
                "FROM d) AS m FROM old) AS s GROUP BY m ORDER BY m")


def test_stddev_variance(conns):
    rows = assert_same(conns, "SELECT stddev(v) AS sd, var_pop(v) AS vp, "
                       "var_samp(v) AS vs FROM t")
    sd, vp, vs = map(float, rows[0])
    assert abs(vs - 8.0 / 3) < 1e-9          # var of [2,4,4,6], ddof=1
    assert abs(vp - 2.0) < 1e-9
    assert abs(sd - (8.0 / 3) ** 0.5) < 1e-9


def test_stddev_grouped(conns):
    rows = assert_same(conns, "SELECT g, round(stddev(v), 3) AS sd FROM t "
                       "GROUP BY g ORDER BY g")
    assert rows == [["1", "1.414"], ["2", "1.414"]]


def test_stddev_of_one_row_is_null(conns):
    """ValidIf: stddev_samp over n <= 1 rows is NULL, not NaN."""
    rows = assert_same(conns, "SELECT o, stddev(v) AS sd, stddev_pop(v) AS "
                       "sp FROM t GROUP BY o ORDER BY o")
    assert {r[1] for r in rows} == {"NULL"}


def test_math_functions(conns):
    rows = assert_same(conns, "SELECT sqrt(v) AS q, abs(0 - v) AS a, "
                       "floor(v / 4) AS f, ceil(v / 4) AS c FROM t")
    # torch's CPU sqrt may be one ulp off the correctly rounded value
    assert all(cells_equal(g, w) for g, w in zip(
        rows[0], ["1.4142135623730951", "2.0", "0.0", "1.0"]))


def test_more_math(conns):
    assert_same(conns, "SELECT exp(v) AS e, ln(v) AS l, log10(v) AS l10, "
                "log2(v) AS l2, sin(v) AS s, cos(v) AS c, tan(v) AS t, "
                "power(v, 3) AS p, abs(0 - x) AS ax FROM t")


def test_sqrt_and_ln_of_negatives(conns):
    rows = assert_same(conns, "SELECT sqrt(0 - v) AS q, ln(0 - v) AS l, "
                       "ln(v - v) AS z FROM t")
    assert rows[0][:2] == ["nan", "nan"] and rows[0][2] == "-inf"


def test_double_rounding_is_half_to_even(conns):
    rows = assert_same(conns, "SELECT round(h) AS r0, round(h, 1) AS r1, "
                       "round(h, 2) AS r2 FROM old")
    assert [r[0] for r in rows] == ["0.0", "2.0", "2.0", "-0.0", "-2.0",
                                    "0.0", "-1.0", "7.0"]
    assert rows[5][2] == "0.12" and rows[6][1] == "-1.2"


def test_decimal_rounding_stays_exact(conns):
    rows = assert_same(conns, "SELECT round(p, 1) AS a, round(q, 2) AS b, "
                       "round(p, 2) AS c, round(q, 0) AS d FROM dec")
    assert rows[0][:2] == ["1.3", "0.13"]


def test_math_of_literals(conns):
    assert_same(conns, "SELECT sqrt(16) AS a, round(2.5) AS b, abs(-3) AS c, "
                "power(2, 10) AS d, ln(0) AS e")


def test_valid_if_keeps_nulls(conns):
    assert_same(conns, "SELECT g, var_samp(v) AS vs, var_pop(x) AS vp "
                "FROM t WHERE o > 4 GROUP BY g ORDER BY g")
