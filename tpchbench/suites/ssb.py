"""The Star Schema Benchmark: the suite of the configurations that name
`"suite": "ssb"`.

O'Neil, O'Neil, Chen and Revilak, "The Star Schema Benchmark and Augmented
Fact Table Indexing" (TPCTC 2009; specification revision 3): one fact
table, `lineorder` (about 6,000,000 x SF rows, 17 columns), and four
dimensions, `customer` (30,000 x SF), `supplier` (2,000 x SF), `part`
(200,000 x floor(1 + log2 SF)) and the date table, one row a day from
1992-01-01.  The 13 queries run in four flights with the specification's
constants.

- **Data** (`tables`): generated with NumPy by the specification's
  population rules, from the run's `--seed`.  `run.py` hands the seed to
  `traffic`, not to `tables`; so `tables` returns an empty holder and
  `traffic` fills it (neither is timed).  A holder read before any
  `traffic` call raises.  The data is made anew every run; nothing is
  cached on disk.
- **Names**: the engine's frontend reads `date` as a keyword and has no
  quoted identifiers, so the date table is registered as `ddate`.
- **Connect**: `connect(None)`, `register_numpy` for each table, then the
  configuration's indexes through `conn.sql` (`INDEXES`).
- **Reference** (`answer`): plain NumPy over the suite's own arrays,
  importing nothing of the engine: dense key-to-row gathers, `np.unique`
  codes, exact int64 sums a group.  `verify` holds every answer of the window to
  it; every SSB measure is an integer, so `wrong_cells` decides.  The
  control sums in float32.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import weakref
from collections.abc import Mapping

import numpy as np

from tpchbench import check
from tpchbench.reference.queries import Answer

_DISTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "dists.json")

FIRST_DAY = datetime.date(1992, 1, 1)
DATE_ROWS = 2556          # 1992-01-01 .. 1998-12-30, as ssb-dbgen writes it
ORDER_DAYS = 2406         # order dates 1992-01-01 .. 1998-08-02
MONTHS = ["January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December"]
WEEKDAYS = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
            "Saturday", "Sunday"]
HOLIDAYS = {(1, 1), (7, 4), (11, 11), (12, 24), (12, 25), (12, 31)}
# the region of each of TPC-H's 25 nations, in its order (clause 4.2.3)
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                 4, 2, 3, 3, 1]

INDEXES = (
    "CREATE UNIQUE INDEX ON ddate(d_datekey)",
    "CREATE UNIQUE INDEX ON customer(c_custkey)",
    "CREATE UNIQUE INDEX ON supplier(s_suppkey)",
    "CREATE UNIQUE INDEX ON part(p_partkey)",
    "CREATE CUBIT INDEX ON lineorder(lo_discount) WITH (bins=11)",
    "CREATE CUBIT INDEX ON lineorder(lo_quantity) WITH (bins=50)",
    "CREATE CUBIT INDEX ON ddate(d_year)",
    "CREATE CUBIT INDEX ON ddate(d_yearmonthnum)",
    "CREATE CUBIT INDEX ON ddate(d_yearmonth)",
    "CREATE CUBIT INDEX ON ddate(d_weeknuminyear)",
    "CREATE CUBIT INDEX ON part(p_mfgr)",
    "CREATE CUBIT INDEX ON part(p_category)",
    "CREATE CUBIT INDEX ON part(p_brand1)",
    "CREATE CUBIT INDEX ON customer(c_region)",
    "CREATE CUBIT INDEX ON customer(c_nation)",
    "CREATE CUBIT INDEX ON customer(c_city)",
    "CREATE CUBIT INDEX ON supplier(s_region)",
    "CREATE CUBIT INDEX ON supplier(s_nation)",
    "CREATE CUBIT INDEX ON supplier(s_city)",
)

# the specification's query texts (section 3), with the date table named
# `ddate`; {} holds nothing: the one substitution set is the spec's own
_LO_DATE = "FROM lineorder, ddate WHERE lo_orderdate = d_datekey"
_Q2 = ("SELECT sum(lo_revenue), d_year, p_brand1 "
       "FROM lineorder, ddate, part, supplier "
       "WHERE lo_orderdate = d_datekey AND lo_partkey = p_partkey "
       "AND lo_suppkey = s_suppkey AND {where} "
       "GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1")
_Q3 = ("SELECT {g}, d_year, sum(lo_revenue) AS revenue "
       "FROM customer, lineorder, supplier, ddate "
       "WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey "
       "AND lo_orderdate = d_datekey AND {where} "
       "GROUP BY {g}, d_year ORDER BY d_year ASC, revenue DESC")
_Q4_FROM = ("FROM ddate, customer, supplier, part, lineorder "
            "WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey "
            "AND lo_partkey = p_partkey AND lo_orderdate = d_datekey")
_KI = ("(c_city = 'UNITED KI1' OR c_city = 'UNITED KI5') "
       "AND (s_city = 'UNITED KI1' OR s_city = 'UNITED KI5')")
TEXTS = {
    11: ("SELECT sum(lo_extendedprice * lo_discount) AS revenue " + _LO_DATE
         + " AND d_year = 1993 AND lo_discount BETWEEN 1 AND 3 "
         "AND lo_quantity < 25"),
    12: ("SELECT sum(lo_extendedprice * lo_discount) AS revenue " + _LO_DATE
         + " AND d_yearmonthnum = 199401 AND lo_discount BETWEEN 4 AND 6 "
         "AND lo_quantity BETWEEN 26 AND 35"),
    13: ("SELECT sum(lo_extendedprice * lo_discount) AS revenue " + _LO_DATE
         + " AND d_weeknuminyear = 6 AND d_year = 1994 "
         "AND lo_discount BETWEEN 5 AND 7 AND lo_quantity BETWEEN 26 AND 35"),
    21: _Q2.format(where="p_category = 'MFGR#12' AND s_region = 'AMERICA'"),
    22: _Q2.format(where="p_brand1 BETWEEN 'MFGR#2221' AND 'MFGR#2228' "
                   "AND s_region = 'ASIA'"),
    23: _Q2.format(where="p_brand1 = 'MFGR#2239' AND s_region = 'EUROPE'"),
    31: _Q3.format(g="c_nation, s_nation",
                   where="c_region = 'ASIA' AND s_region = 'ASIA' "
                   "AND d_year >= 1992 AND d_year <= 1997"),
    32: _Q3.format(g="c_city, s_city",
                   where="c_nation = 'UNITED STATES' "
                   "AND s_nation = 'UNITED STATES' "
                   "AND d_year >= 1992 AND d_year <= 1997"),
    33: _Q3.format(g="c_city, s_city",
                   where=_KI + " AND d_year >= 1992 AND d_year <= 1997"),
    34: _Q3.format(g="c_city, s_city",
                   where=_KI + " AND d_yearmonth = 'Dec1997'"),
    41: ("SELECT d_year, c_nation, sum(lo_revenue - lo_supplycost) AS profit "
         + _Q4_FROM + " AND c_region = 'AMERICA' AND s_region = 'AMERICA' "
         "AND (p_mfgr = 'MFGR#1' OR p_mfgr = 'MFGR#2') "
         "GROUP BY d_year, c_nation ORDER BY d_year, c_nation"),
    42: ("SELECT d_year, s_nation, p_category, "
         "sum(lo_revenue - lo_supplycost) AS profit " + _Q4_FROM
         + " AND c_region = 'AMERICA' AND s_region = 'AMERICA' "
         "AND (d_year = 1997 OR d_year = 1998) "
         "AND (p_mfgr = 'MFGR#1' OR p_mfgr = 'MFGR#2') "
         "GROUP BY d_year, s_nation, p_category "
         "ORDER BY d_year, s_nation, p_category"),
    43: ("SELECT d_year, s_city, p_brand1, "
         "sum(lo_revenue - lo_supplycost) AS profit " + _Q4_FROM
         + " AND c_region = 'AMERICA' AND s_nation = 'UNITED STATES' "
         "AND (d_year = 1997 OR d_year = 1998) AND p_category = 'MFGR#14' "
         "GROUP BY d_year, s_city, p_brand1 "
         "ORDER BY d_year, s_city, p_brand1"),
}


# ------------------------------------------------------------------ data

def _dists() -> dict:
    with open(_DISTS) as f:
        return json.load(f)


def sizes(sf: float) -> dict:
    """Rows a table (lineorder: its orders; the lines are 1-7 an order)."""
    parts = 200_000 * math.floor(1 + math.log2(sf)) if sf >= 1 else \
        max(1, int(200_000 * sf))
    return {"orders": max(1, int(1_500_000 * sf)),
            "customer": max(1, int(30_000 * sf)),
            "supplier": max(1, int(2_000 * sf)), "part": parts}


def _s(values) -> np.ndarray:
    return np.array([v.encode() if isinstance(v, str) else v
                     for v in values], dtype="S")


def _vstrings(rng, n: int, lo: int, hi: int) -> np.ndarray:
    """n random strings of lo..hi characters (letters, digits, ',' '.')."""
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMN"
                             b"OPQRSTUVWXYZ0123456789,. ", dtype=np.uint8)
    m = alphabet[rng.integers(0, len(alphabet), (n, hi))]
    m[np.arange(hi)[None, :] >= rng.integers(lo, hi + 1, n)[:, None]] = 0
    m[:, 0] = alphabet[rng.integers(0, 52, n)]     # no leading blank
    return m.view(f"S{hi}").ravel()


def _numbered(prefix: str, keys: np.ndarray) -> np.ndarray:
    return _s(f"{prefix}#{k:09d}" for k in keys.tolist())


def _phones(rng, nation: np.ndarray) -> np.ndarray:
    a, b, c = (rng.integers(lo, hi, len(nation)) for lo, hi in
               ((100, 1000), (100, 1000), (1000, 10000)))
    return _s(f"{n + 10}-{x}-{y}-{z}" for n, x, y, z in zip(
        nation.tolist(), a.tolist(), b.tolist(), c.tolist()))


def _geography(rng, n: int, d: dict, prefix: str) -> dict:
    """city (the nation's first 9 letters, padded, and a digit 0-9),
    nation, region: one of 25 nations uniformly."""
    names = [x[0] for x in d["nations"]]
    region = [d["regions"][r][0] for r in NATION_REGION]
    cities = _s(f"{nm[:9]:<9}{i}" for nm in names for i in range(10))
    nation = rng.integers(0, 25, n)
    return {f"{prefix}_city": cities[nation * 10 + rng.integers(0, 10, n)],
            f"{prefix}_nation": _s(names)[nation],
            f"{prefix}_region": _s(region)[nation]}, nation


def _customer(rng, n: int, d: dict) -> dict:
    keys = np.arange(1, n + 1, dtype=np.int32)
    geo, nation = _geography(rng, n, d, "c")
    seg = _s(x[0] for x in d["msegmnt"])
    return {"c_custkey": keys, "c_name": _numbered("Customer", keys),
            "c_address": _vstrings(rng, n, 10, 40), **geo,
            "c_phone": _phones(rng, nation),
            "c_mktsegment": seg[rng.integers(0, len(seg), n)]}


def _supplier(rng, n: int, d: dict) -> dict:
    keys = np.arange(1, n + 1, dtype=np.int32)
    geo, nation = _geography(rng, n, d, "s")
    return {"s_suppkey": keys, "s_name": _numbered("Supplier", keys),
            "s_address": _vstrings(rng, n, 10, 40), **geo,
            "s_phone": _phones(rng, nation)}


def retail_cents(partkey: np.ndarray) -> np.ndarray:
    """TPC-H's retail price of a part (clause 4.2.3), in cents (int32)."""
    k = partkey.astype(np.int32)
    return 90_000 + (k // 10) % 20_001 + 100 * (k % 1_000)


def _part(rng, n: int, d: dict) -> dict:
    keys = np.arange(1, n + 1, dtype=np.int32)
    colors = _s(x[0] for x in d["colors"])
    m = rng.integers(1, 6, n)
    c = rng.integers(1, 6, n)
    b = rng.integers(1, 41, n)
    mfgr = _s(f"MFGR#{i}" for i in range(1, 6))
    cat = _s(f"MFGR#{i}{j}" for i in range(1, 6) for j in range(1, 6))
    brand = _s(f"MFGR#{i}{j}{k}" for i in range(1, 6) for j in range(1, 6)
               for k in range(1, 41))
    c1, c2 = (colors[rng.integers(0, len(colors), n)] for _ in range(2))
    types = _s(x[0] for x in d["p_types"])
    cntr = _s(x[0] for x in d["p_cntr"])
    return {"p_partkey": keys,
            "p_name": np.char.add(np.char.add(c1, b" "), c2),
            "p_mfgr": mfgr[m - 1], "p_category": cat[(m - 1) * 5 + c - 1],
            "p_brand1": brand[((m - 1) * 5 + c - 1) * 40 + b - 1],
            "p_color": colors[rng.integers(0, len(colors), n)],
            "p_type": types[rng.integers(0, len(types), n)],
            "p_size": rng.integers(1, 51, n).astype(np.int32),
            "p_container": cntr[rng.integers(0, len(cntr), n)]}


def _calendar(n: int):
    return [FIRST_DAY + datetime.timedelta(days=i) for i in range(n)]


def datekeys(n: int = DATE_ROWS) -> np.ndarray:
    """yyyymmdd of days 0..n-1 from 1992-01-01 (commit dates, at most
    90 days past the last order date, stay inside the date table)."""
    return np.array([x.year * 10_000 + x.month * 100 + x.day
                     for x in _calendar(n)], dtype=np.int32)


def _ddate() -> dict:
    days = _calendar(DATE_ROWS)
    nxt = _calendar(DATE_ROWS + 1)[1:]
    season = {12: "Christmas", 1: "Winter", 2: "Winter", 3: "Spring",
              4: "Spring", 5: "Spring", 6: "Summer", 7: "Summer",
              8: "Summer", 9: "Fall", 10: "Fall", 11: "Fall"}
    i32 = lambda xs: np.array(list(xs), dtype=np.int32)  # noqa: E731
    doy = [x.timetuple().tm_yday for x in days]
    return {
        "d_datekey": datekeys(),
        "d_date": _s(f"{MONTHS[x.month - 1]} {x.day}, {x.year}"
                     for x in days),
        "d_dayofweek": _s(WEEKDAYS[x.weekday()] for x in days),
        "d_month": _s(MONTHS[x.month - 1] for x in days),
        "d_year": i32(x.year for x in days),
        "d_yearmonthnum": i32(x.year * 100 + x.month for x in days),
        "d_yearmonth": _s(f"{MONTHS[x.month - 1][:3]}{x.year}"
                          for x in days),
        "d_daynuminweek": i32((x.weekday() + 1) % 7 + 1 for x in days),
        "d_daynuminmonth": i32(x.day for x in days),
        "d_daynuminyear": i32(doy),
        "d_monthnuminyear": i32(x.month for x in days),
        "d_weeknuminyear": i32((y - 1) // 7 + 1 for y in doy),
        "d_sellingseason": _s(season[x.month] for x in days),
        "d_lastdayinweekfl": i32(x.weekday() == 5 for x in days),
        "d_lastdayinmonthfl": i32(y.month != x.month
                                  for x, y in zip(days, nxt)),
        "d_holidayfl": i32((x.month, x.day) in HOLIDAYS for x in days),
        "d_weekdayfl": i32(x.weekday() < 5 for x in days),
    }


def _lineorder(rng, n: dict, d: dict) -> dict:
    """Orders of 1-7 lines; the order's customer, date and priority on
    every line; per line a part, supplier, quantity, discount, tax and ship
    mode.  Customers are drawn as TPC-H draws them (keys not divisible by
    3)."""
    i32 = np.int32
    no = n["orders"]
    lines = rng.integers(1, 8, no, dtype=i32)
    total = int(lines.sum(dtype=np.int64))
    first = np.cumsum(lines, dtype=np.int64) - lines
    ncust = n["customer"]
    live = np.arange(1, ncust + 1, dtype=i32)
    live = live[live % 3 != 0] if ncust >= 3 else live
    day = rng.integers(0, ORDER_DAYS, no, dtype=np.int16)
    keys = datekeys()
    out = {"lo_orderkey": np.repeat(np.arange(1, no + 1, dtype=i32), lines),
           "lo_linenumber": (np.arange(total, dtype=i32)
                             - np.repeat(first.astype(i32), lines) + 1),
           "lo_custkey": np.repeat(live[rng.integers(0, len(live), no)],
                                   lines)}
    part = rng.integers(1, n["part"] + 1, total, dtype=i32)
    out["lo_partkey"] = part
    out["lo_suppkey"] = rng.integers(1, n["supplier"] + 1, total, dtype=i32)
    out["lo_orderdate"] = np.repeat(keys[day], lines)
    prio = _s(x[0] for x in d["o_oprio"])
    out["lo_orderpriority"] = prio[np.repeat(
        rng.integers(0, len(prio), no, dtype=np.int8), lines)]
    out["lo_shippriority"] = np.zeros(total, dtype=i32)
    qty = rng.integers(1, 51, total, dtype=i32)
    price = retail_cents(np.arange(n["part"] + 1, dtype=i32))[part]
    ext = qty * price
    disc = rng.integers(0, 11, total, dtype=i32)
    tax = rng.integers(0, 9, total, dtype=i32)
    charge = ext.astype(np.int64) * ((100 - disc) * (100 + tax))
    out["lo_quantity"] = qty
    out["lo_extendedprice"] = ext
    out["lo_ordtotalprice"] = np.repeat(
        (np.add.reduceat(charge, first) // 10_000).astype(i32), lines)
    del charge
    out["lo_discount"] = disc
    out["lo_revenue"] = ext * (100 - disc) // 100
    out["lo_supplycost"] = 6 * price // 10
    out["lo_tax"] = tax
    out["lo_commitdate"] = keys[np.repeat(day, lines)
                                + rng.integers(30, 91, total, dtype=np.int16)]
    modes = _s(x[0] for x in d["smode"])
    out["lo_shipmode"] = modes[rng.integers(0, len(modes), total,
                                            dtype=np.int8)]
    return out


def generate(sf: float, seed: int) -> dict:
    """The five tables at `sf`, drawn from `seed`."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x55B])
    d = _dists()
    n = sizes(sf)
    return {"ddate": _ddate(), "customer": _customer(rng, n["customer"], d),
            "supplier": _supplier(rng, n["supplier"], d),
            "part": _part(rng, n["part"], d),
            "lineorder": _lineorder(rng, n, d)}


class Tables(Mapping):
    """`{table: {column: array}}`, filled from the run's seed by `traffic`
    (or, read first, from the seed `traffic` was last given)."""

    def __init__(self, sf: float):
        self.sf = sf
        self._data: dict | None = None

    def fill(self, seed: int):
        if self._data is None:
            self._data = generate(self.sf, seed)

    def _get(self) -> dict:
        if self._data is None:
            if _SEED["seed"] is None:
                raise RuntimeError("the SSB tables are drawn from the run's "
                                   "seed: make the traffic first")
            self.fill(_SEED["seed"])
        return self._data

    def __getitem__(self, name):
        return self._get()[name]

    def __iter__(self):
        return iter(self._get())

    def __len__(self):
        return len(self._get())


_SEED: dict = {"seed": None}
_PENDING: list = []       # weak references to holders not yet filled


def scale(config: dict, sf: float | None = None) -> float:
    return float(config["scale_factor"] if sf is None else sf)


def tables(config: dict, sf: float) -> Tables:
    t = Tables(sf)
    _PENDING.append(weakref.ref(t))
    return t


def connect(config: dict, tables: Mapping, sf: float, device: str):
    """Each table registered, then its indexes; the date table first, so
    an engine that refuses its key-to-row table fails before the fact
    table's load."""
    from duckdb_cubit_tpu_torch.api import connect
    conn = connect(None, device=device)
    for name in ("ddate", "customer", "supplier", "part", "lineorder"):
        conn.register_numpy(name, {c: np.array(a)
                                   for c, a in tables[name].items()})
        for stmt in INDEXES:
            if f" ON {name}(" in stmt:
                conn.sql(stmt)
    return conn


# --------------------------------------------------------------- traffic

class Traffic:
    """One client in a closed loop: the 13 queries in flight order, with
    the specification's constants as the one substitution set."""
    refresh = False

    def __init__(self, mix: dict, sf: float, seed: int):
        self.order = [int(n) for n in mix["order"]]
        self.param_sets = [{n: {} for n in self.order}]
        self.sf = sf

    @staticmethod
    def label(n: int) -> str:
        return f"ssb{n}"

    def params(self, cycle: int) -> dict:
        return self.param_sets[0]

    def warmup(self) -> list:
        return self.cycle(0)

    def cycle(self, c: int) -> list:
        return [("query", n, TEXTS[n]) for n in self.order]


def traffic(config: dict, mix: dict, sf: float, seed: int) -> Traffic:
    _SEED["seed"] = int(seed)
    while _PENDING:
        t = _PENDING.pop()()
        if t is not None and t.sf == sf:
            t.fill(seed)
    return Traffic(mix, sf, seed)


# ------------------------------------------------------------- reference

def reference(config: dict, tables: Mapping, sf: float) -> dict:
    return {"tables": tables, "rows": {}}


def fact_rows(db: dict, fk: str, dim: str, key: str) -> np.ndarray:
    """The dimension row of every lineorder row through a dense key-to-row
    table over [min key, max key]; cached on `db` (the roofline's byte
    rules read it too)."""
    got = db["rows"].get(fk)
    if got is None:
        t = db["tables"]
        keys = t[dim][key].astype(np.int64)
        base = int(keys.min())
        table = np.full(int(keys.max()) - base + 1, -1, dtype=np.int32)
        table[keys - base] = np.arange(len(keys), dtype=np.int32)
        got = db["rows"][fk] = table[t["lineorder"][fk] - np.int32(base)]
        if (got < 0).any():
            raise ValueError(f"{fk}: a key that {dim} does not hold")
    return got


_DIMS = {"d": ("lo_orderdate", "ddate", "d_datekey"),
         "c": ("lo_custkey", "customer", "c_custkey"),
         "s": ("lo_suppkey", "supplier", "s_suppkey"),
         "p": ("lo_partkey", "part", "p_partkey")}


def _codes(db: dict, name: str, m: np.ndarray):
    """A dimension column at the lineorder rows `m` keeps, as codes into
    its sorted distinct values: -> (codes, values)."""
    fk, dim, key = _DIMS[name.split("_")[0]]
    got = db.setdefault("codes", {}).get(name)
    if got is None:
        got = db["codes"][name] = np.unique(db["tables"][dim][name],
                                            return_inverse=True)
    values, inv = got
    return inv[fact_rows(db, fk, dim, key)[m]].astype(np.int64), values


def _eq(col, v):
    return col == (v.encode() if isinstance(v, str) else v)


# per query: the filters ([(column, op, values)]), the group columns, the
# measure and the output order (columns, then ORDER BY keys, descending
# ones marked)
_Q1 = {11: [("d_year", "=", 1993), ("lo_discount", "between", (1, 3)),
            ("lo_quantity", "<", 25)],
       12: [("d_yearmonthnum", "=", 199401),
            ("lo_discount", "between", (4, 6)),
            ("lo_quantity", "between", (26, 35))],
       13: [("d_weeknuminyear", "=", 6), ("d_year", "=", 1994),
            ("lo_discount", "between", (5, 7)),
            ("lo_quantity", "between", (26, 35))]}
_YEARS = ("d_year", "between", (1992, 1997))
_KI_F = [("c_city", "in", ("UNITED KI1", "UNITED KI5")),
         ("s_city", "in", ("UNITED KI1", "UNITED KI5"))]
_GROUPED = {
    21: ([("p_category", "=", "MFGR#12"), ("s_region", "=", "AMERICA")],
         ["d_year", "p_brand1"], "revenue", ["sum", "d_year", "p_brand1"],
         [(1, 1), (2, 1)]),
    22: ([("p_brand1", "between", ("MFGR#2221", "MFGR#2228")),
          ("s_region", "=", "ASIA")],
         ["d_year", "p_brand1"], "revenue", ["sum", "d_year", "p_brand1"],
         [(1, 1), (2, 1)]),
    23: ([("p_brand1", "=", "MFGR#2239"), ("s_region", "=", "EUROPE")],
         ["d_year", "p_brand1"], "revenue", ["sum", "d_year", "p_brand1"],
         [(1, 1), (2, 1)]),
    31: ([("c_region", "=", "ASIA"), ("s_region", "=", "ASIA"), _YEARS],
         ["c_nation", "s_nation", "d_year"], "revenue",
         ["c_nation", "s_nation", "d_year", "sum"], [(2, 1), (3, -1)]),
    32: ([("c_nation", "=", "UNITED STATES"),
          ("s_nation", "=", "UNITED STATES"), _YEARS],
         ["c_city", "s_city", "d_year"], "revenue",
         ["c_city", "s_city", "d_year", "sum"], [(2, 1), (3, -1)]),
    33: (_KI_F + [_YEARS], ["c_city", "s_city", "d_year"], "revenue",
         ["c_city", "s_city", "d_year", "sum"], [(2, 1), (3, -1)]),
    34: (_KI_F + [("d_yearmonth", "=", "Dec1997")],
         ["c_city", "s_city", "d_year"], "revenue",
         ["c_city", "s_city", "d_year", "sum"], [(2, 1), (3, -1)]),
    41: ([("c_region", "=", "AMERICA"), ("s_region", "=", "AMERICA"),
          ("p_mfgr", "in", ("MFGR#1", "MFGR#2"))],
         ["d_year", "c_nation"], "profit", ["d_year", "c_nation", "sum"],
         [(0, 1), (1, 1)]),
    42: ([("c_region", "=", "AMERICA"), ("s_region", "=", "AMERICA"),
          ("d_year", "in", (1997, 1998)),
          ("p_mfgr", "in", ("MFGR#1", "MFGR#2"))],
         ["d_year", "s_nation", "p_category"], "profit",
         ["d_year", "s_nation", "p_category", "sum"],
         [(0, 1), (1, 1), (2, 1)]),
    43: ([("c_region", "=", "AMERICA"), ("s_nation", "=", "UNITED STATES"),
          ("d_year", "in", (1997, 1998)), ("p_category", "=", "MFGR#14")],
         ["d_year", "s_city", "p_brand1"], "profit",
         ["d_year", "s_city", "p_brand1", "sum"], [(0, 1), (1, 1), (2, 1)]),
}


def _test(col: np.ndarray, op: str, v) -> np.ndarray:
    if op == "=":
        return _eq(col, v)
    if op == "<":
        return col < v
    if op == "in":
        f = np.zeros(len(col), dtype=bool)
        for x in v:
            f |= _eq(col, x)
        return f
    lo, hi = (x.encode() if isinstance(x, str) else x for x in v)
    return (col >= lo) & (col <= hi)


def _mask(db: dict, filters: list) -> np.ndarray:
    """The lineorder rows every filter keeps, in order.  A dimension filter
    is evaluated on the dimension, then gathered; each filter after the
    first only at the rows the earlier ones kept."""
    t = db["tables"]
    at = None
    for name, op, v in filters:
        p = name.split("_")[0]
        if p == "lo":
            col = t["lineorder"][name]
            f = _test(col if at is None else col[at], op, v)
        else:
            rows = fact_rows(db, *_DIMS[p])
            f = _test(t[_DIMS[p][1]][name], op, v)[
                rows if at is None else rows[at]]
        at = np.flatnonzero(f) if at is None else at[f]
    return at


def _measure(db: dict, what: str, m: np.ndarray) -> np.ndarray:
    lo = db["tables"]["lineorder"]
    if what == "revenue":
        return lo["lo_revenue"][m].astype(np.int64)
    if what == "profit":
        return (lo["lo_revenue"][m].astype(np.int64)
                - lo["lo_supplycost"][m])
    return (lo["lo_extendedprice"][m].astype(np.int64)
            * lo["lo_discount"][m])


def _text(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def answer(n: int, db: dict, low: bool = False) -> Answer:
    """Query n in NumPy; `low` sums in float32 (the control)."""
    if n in _Q1:
        m = _mask(db, _Q1[n])
        v = _measure(db, "discount_revenue", m)
        if not len(v):
            return Answer([["NULL"]], "x")
        s = int(v.astype(np.float32).sum(dtype=np.float32)) if low else \
            int(v.sum())
        return Answer([[str(s)]], "x")
    filters, groups, what, out, order = _GROUPED[n]
    m = _mask(db, filters)
    v = _measure(db, what, m)
    codes, uniq = zip(*[_codes(db, g, m) for g in groups])
    key = np.zeros(len(v), dtype=np.int64)
    size = 1
    for u, c in zip(uniq, codes):
        key = key * len(u) + c
        size *= len(u)
    # a sum for each point of the group columns' product (at most 1.75M,
    # Q4.3's), kept where a row fell
    sums = np.zeros(size, dtype=np.float32 if low else np.int64)
    np.add.at(sums, key, v.astype(sums.dtype))
    gk = np.flatnonzero(np.bincount(key, minlength=size))
    result = []
    for g, s in zip(gk.tolist(), sums[gk].tolist()):
        vals = []
        for u in reversed(uniq):
            g, r = divmod(g, len(u))
            vals.append(u[r])
        vals.reverse()
        by = dict(zip(groups, vals))
        result.append([str(int(s)) if o == "sum" else _text(by[o])
                       for o in out])
    kinds = "x" * len(out)

    def sort_key(row):
        k = []
        for i, direction in order:
            x = row[i]
            if out[i] in ("sum", "d_year"):
                x = int(x) * direction
            k.append(x)
        return tuple(k)

    result.sort(key=sort_key)
    return Answer(result, kinds, key=tuple(i for i, _ in order))


def verify(db, traffic: Traffic, sf: float, seed: int, cycles: int,
           rows_of: dict, answered: int, refreshes: list) -> dict:
    """Every answer of the window against the reference's."""
    wrong, gap = cycles * len(traffic.order) - answered, 0.0
    refs: dict = {}
    for (s, n), got_list in sorted(rows_of.items()):
        if n not in refs:
            refs[n] = answer(n, db)
        for got in got_list:
            w, g = check.compare(got, refs[n])
            wrong += w
            gap = max(gap, g)
    return {"wrong_cells": wrong, "double_gap": gap}


def control(config: dict, tables: Mapping, traffic: Traffic) -> dict:
    """Per query, the float32 sums held against the exact ones."""
    db = reference(config, tables, traffic.sf)
    out = {}
    for n in traffic.order:
        low = answer(n, db, low=True)
        out[n] = list(check.compare(low.rows, answer(n, db)))
    return out
