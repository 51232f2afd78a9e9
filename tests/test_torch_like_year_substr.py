"""LIKE, substring and year(date): the torch port's expressions against the
JAX package's on the same numpy-seeded columns, on the CPU.

LIKE and substring evaluate over the dictionary and gather by code on the
device: the truth values, the new codes and the new dictionary must equal
the reference's.  LIKE's truth table comes from `ops/dict_like.py`, whose
plain segment matcher (the body CPU tensors take) is also held to Python's
`re.fullmatch` on seeded random bytes; its device copy of a dictionary
must go with the dictionary, and a LIKE after an INSERT that merges a new
string must see it, and after ROLLBACK must not.  year(date) must equal the
reference's and Python's calendar, pre-1970 and leap days included.
"""

import datetime
import gc
import re
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_cubit_tpu import types as RT
from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.ops import expressions as RE
from duckdb_cubit_tpu_torch import types as PT
from duckdb_cubit_tpu_torch.api import Connection, connect
from duckdb_cubit_tpu_torch.ops import dict_like as DL
from duckdb_cubit_tpu_torch.ops import expressions as PE
from duckdb_cubit_tpu_torch.tpch.load import load_catalog

WORDS = [b"", b"a", b"abc", b"a.c", b"a+c", b"(x)", b"[ab]", b"a^b$",
         b"50%", b"x_y", b"back\\slash", b"green apple", b"forest green",
         b"PROMO BRUSHED", b"MEDIUM POLISHED TIN", b"ab*", b"a|b", b"{2}",
         b"Customer Complaints", b"special requests"]
DICT = np.array(sorted(WORDS), dtype="S")


def _codes(seed=0, n=500):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, len(DICT), n).astype(np.int32)
    valid = rng.random(n) >= 0.1
    return codes, valid


def _eval_both(make, dtype_name, dictionary, arr, valid=None):
    """Evaluate one expression, built by make(module), in both packages on
    the column `s`."""
    rdt, pdt = getattr(RT, dtype_name), getattr(PT, dtype_name)
    rctx = RE.EvalContext({"s": jnp.asarray(arr)},
                          {"s": RE.ColMeta(rdt, dictionary)},
                          {} if valid is None else {"s": jnp.asarray(valid)})
    pctx = PE.EvalContext({"s": torch.as_tensor(arr)},
                          {"s": PE.ColMeta(pdt, dictionary)},
                          {} if valid is None else
                          {"s": torch.as_tensor(valid)})
    return make(RE).eval(rctx), make(PE).eval(pctx)


PATTERNS = [
    "%", "", "a", "a%", "%c", "a_c", "_", "__", "%.%", "a.c", "a+c", "(x)",
    "[ab]", "a^b$", "50%", "%\\%", "x_y", "%green%", "forest%", "%BRUSHED",
    "PROMO%", "%Customer%Complaints%", "%special%requests%", "ab*", "a|b",
    "{2}", "%_%"]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("negated", [False, True, "table"])
def test_like_matches_reference(pattern, negated):
    """`negated` False / True: the port's LIKE / NOT LIKE over coded rows;
    "table": the plain matcher's truth table over the whole dictionary."""
    codes, valid = _codes()
    if negated == "table":
        codes, valid = np.arange(len(DICT), dtype=np.int32), None
        table = DL.like_table(DL.dictionary_bytes(DICT, "cpu"), pattern)
        ref, _ = _eval_both(lambda E: E.Col("s").like(pattern), "VARCHAR",
                            DICT, codes)
        assert table.numpy().tolist() == np.asarray(ref.array).tolist()
        return

    def make(E):
        e = E.Col("s")
        return e.not_like(pattern) if negated else e.like(pattern)
    ref, port = _eval_both(make, "VARCHAR", DICT, codes, valid)
    assert (port.array.numpy() == np.asarray(ref.array)).all()
    assert (port.valid.numpy() == np.asarray(ref.valid)).all()


# patterns over the random dictionaries' alphabet: `%%`, leading and
# trailing `_`, repeated segments, a segment in several places
RANDOM_PATTERNS = ["%", "%%", "", "a", "_", "__", "_a%", "%b_", "_%_",
                   "%ab%ab%", "%a%a%a%", "a%b%c", "%a_b%", "ab%ba", "abc",
                   "%_a_%", "c%", "%\\%", "%x%_%", "a\\%", "%ba_%_ab%"]


def _random_dictionary(rng, n, w, full):
    """n entries (duplicates allowed) of at most w bytes over a small
    alphabet (backslash, `%` and `_` included); `full` draws every length
    as w, else lengths 0..w (empty entries included)."""
    alphabet = list(b"abcx\\%_")
    lengths = np.full(n, w) if full else rng.integers(0, w + 1, n)
    vals = [bytes(rng.choice(alphabet, k)) for k in lengths]
    return np.array(vals, dtype=f"S{w}")


@pytest.mark.parametrize("n,w,full", [
    (0, 4, False), (1, 1, True), (1, 6, False), (300, 1, False),
    (300, 5, True), (300, 7, False), (200, 23, False), (200, 64, True)])
def test_like_table_matches_fullmatch(n, w, full):
    """The plain matcher against `re.fullmatch(..., re.DOTALL)` of the
    pattern's regex on seeded random bytes, patterns longer than the width
    included."""
    rng = np.random.default_rng(n * 131 + w)
    d = _random_dictionary(rng, n, w, full)
    entries = DL.dictionary_bytes(d, "cpu")
    assert tuple(entries.shape) == (n, w)
    for pattern in RANDOM_PATTERNS + ["a" * (w + 1), "%" + "_" * (w + 1),
                                      "%" + "b" * w + "%"]:
        rx = re.compile(PE.like_to_regex(pattern).encode(), re.DOTALL)
        want = [rx.fullmatch(s) is not None for s in d]
        got = DL.like_table(entries, pattern).tolist()
        assert got == want, pattern


def test_like_pattern_limits_of_the_kernel():
    """A pattern past the kernel's segments or bytes is refused before a
    launch; the plain matcher has no limit."""
    long = "%".join(["ab"] * (DL.MAX_SEGMENTS + 1))
    with pytest.raises(ValueError):
        DL._launch_args(DL.compile_pattern(long))
    with pytest.raises(ValueError):
        DL._launch_args(DL.compile_pattern("a" * (DL.MAX_PATTERN_BYTES + 1)))
    DL._launch_args(DL.compile_pattern("a" * DL.MAX_PATTERN_BYTES))
    entries = DL.dictionary_bytes(np.array([b"ab" * 70], "S140"), "cpu")
    assert DL.like_table(entries, long).tolist() == [True]


def test_device_copy_goes_with_its_dictionary():
    """The device copy is made once per dictionary object and device, found
    again by identity, never by equal contents, and freed when the
    dictionary dies ("meta" stands in for a card: no bytes move)."""
    d = np.array([b"ab", b"abc"], dtype="S3")
    held = len(DL._COPIES)
    copy = DL.dictionary_bytes(d, "meta")
    assert copy.device.type == "meta" and tuple(copy.shape) == (2, 3)
    assert DL.dictionary_bytes(d, "meta") is copy
    assert len(DL._COPIES) == held + 1
    twin = d.copy()
    assert DL.dictionary_bytes(twin, "meta") is not copy
    assert len(DL._COPIES) == held + 2
    gone = weakref.ref(copy)
    del copy, d, twin
    gc.collect()
    assert len(DL._COPIES) == held
    assert gone() is None
    # the CPU path is a view of the array and holds nothing
    d = np.array([b"x"], dtype="S1")
    assert DL.dictionary_bytes(d, "cpu").numpy().base is not None
    assert len(DL._COPIES) == held


def test_like_metacharacters_are_literal():
    """Regex metacharacters in a pattern match themselves only."""
    codes = np.arange(len(DICT), dtype=np.int32)
    for pattern, word in [("a.c", b"a.c"), ("a+c", b"a+c"), ("(x)", b"(x)"),
                          ("[ab]", b"[ab]"), ("a|b", b"a|b"),
                          ("ab*", b"ab*"), ("{2}", b"{2}")]:
        _, port = _eval_both(lambda E: E.Col("s").like(pattern), "VARCHAR",
                             DICT, codes)
        assert DICT[port.array.numpy()].tolist() == [word], pattern


@pytest.mark.parametrize("start,length", [(1, 2), (2, 3), (1, 0), (5, 10),
                                          (30, 2), (1, 100)])
def test_substr_matches_reference(start, length):
    codes, valid = _codes(1)
    ref, port = _eval_both(lambda E: E.Substr(E.Col("s"), start, length),
                           "VARCHAR", DICT, codes, valid)
    assert port.dictionary.tolist() == ref.dictionary.tolist()
    assert (port.array.numpy() == np.asarray(ref.array)).all()
    got = port.dictionary[port.array.numpy()]
    want = [w[start - 1: start - 1 + length] for w in DICT[codes]]
    assert got.tolist() == want


DATES = ["2000-02-29", "2000-03-01", "1999-12-31", "2000-01-01",
         "1900-02-28", "1900-03-01", "1904-02-29", "1600-02-29",
         "1969-12-31", "1970-01-01", "1968-02-29", "1583-01-01",
         "1992-01-01", "1998-12-31", "2024-02-29", "2100-03-01",
         "0400-02-29", "0001-01-01", "9999-12-31"]


def _days(s: str) -> int:
    return (datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days


def test_year_on_edge_dates():
    days = np.array([_days(s) for s in DATES], np.int32)
    ref, port = _eval_both(lambda E: E.ExtractYear(E.Col("s")), "DATE",
                           None, days)
    want = [int(s[:4]) for s in DATES]
    assert port.array.numpy().tolist() == want
    assert np.asarray(ref.array).tolist() == want
    assert port.array.dtype == torch.int64


def test_year_on_random_days_matches_reference():
    rng = np.random.default_rng(3)
    days = rng.integers(_days("0001-01-01"), _days("9999-12-31"),
                        20000).astype(np.int32)
    ref, port = _eval_both(lambda E: E.Col("s").year(), "DATE", None, days)
    assert (port.array.numpy() == np.asarray(ref.array)).all()
    step = days[::997]
    want = [(datetime.date(1970, 1, 1) + datetime.timedelta(int(d))).year
            for d in step]
    assert port.array.numpy()[::997].tolist() == want


def test_year_domain_follows_the_day_domain():
    dom = np.array([_days("1992-01-01"), _days("1998-08-02")], np.int64)
    days = np.array(dom, np.int32)
    rctx = RE.EvalContext({"s": jnp.asarray(days)},
                          {"s": RE.ColMeta(RT.DATE, None, dom)})
    pctx = PE.EvalContext({"s": torch.as_tensor(days)},
                          {"s": PE.ColMeta(PT.DATE, None, dom)})
    ref = RE.ExtractYear(RE.Col("s")).eval(rctx)
    port = PE.ExtractYear(PE.Col("s")).eval(pctx)
    assert port.domain.tolist() == ref.domain.tolist() == list(range(1992,
                                                                     1999))


def test_like_sees_an_inserted_string_until_rollback():
    """An INSERT that merges a new string into o_comment's dictionary: LIKE
    finds the new row inside the transaction and not after ROLLBACK (the
    dictionary is a new object while the row lives, the old one after)."""
    conn = Connection(load_catalog(0.01, device="cpu", cache=False),
                      device="cpu")
    count = ("SELECT count(*) AS n FROM orders "
             "WHERE o_comment LIKE '%zzyzx%requests%'")
    col = lambda: conn.catalog.table("orders").columns["o_comment"]
    before = col().dictionary
    assert conn.sql(count).strings() == [["0"]]
    key = int(conn.sql("SELECT max(o_orderkey) AS k FROM orders")
              .strings()[0][0]) + 1
    conn.sql("BEGIN")
    conn.sql(f"INSERT INTO orders VALUES ({key}, 1, 'O', 1.00, "
             "DATE '1998-08-02', '1-URGENT', 'Clerk#000000001', 0, "
             "'quick zzyzx requests')")
    assert col().dictionary is not before
    assert conn.sql(count).strings() == [["1"]]
    conn.sql("ROLLBACK")
    assert col().dictionary is before
    assert conn.sql(count).strings() == [["0"]]


@pytest.fixture(scope="module")
def conns():
    return ref_connect(sf=0.01), connect(sf=0.01, device="cpu")


@pytest.mark.parametrize("sql", [
    "SELECT count(*) AS c FROM orders "
    "WHERE o_comment NOT LIKE '%special%requests%'",
    "SELECT cc, count(*) AS n FROM (SELECT substring(c_phone, 1, 2) AS cc "
    "FROM customer) t GROUP BY cc ORDER BY cc",
    "SELECT count(*) AS n FROM customer "
    "WHERE substring(c_phone, 1, 2) IN ('13', '31', '23')",
    "SELECT y, count(*) AS n FROM (SELECT extract(year FROM o_orderdate) "
    "AS y FROM orders) t GROUP BY y ORDER BY y",
    "SELECT y, sum(q) AS q FROM (SELECT extract(year FROM l_shipdate) AS y, "
    "l_quantity AS q FROM lineitem WHERE l_shipmode LIKE 'A%') t "
    "GROUP BY y ORDER BY y",
])
def test_sql_matches_reference(conns, sql):
    ref, port = conns
    assert port.sql(sql).strings() == ref.sql(sql).strings()
