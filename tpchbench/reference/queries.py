"""The 22 TPC-H queries in plain NumPy: the benchmark's reference.

Each `qN(db, p, num)` answers query N with substitution parameters `p` over
`db` (a `reference.db.Database`) and returns an `Answer`.  Semantics are
SQL's as DuckDB states them: DECIMAL arithmetic is exact (int64 cents,
products at the summed scale), `avg` and a DECIMAL divided by a DECIMAL are
DOUBLE, a DECIMAL compared with a DOUBLE is read as a DOUBLE, a comparison
with an empty subquery's aggregate (NULL) is not true, and an aggregate
without GROUP BY over no rows gives one row of NULLs.

`num` is the arithmetic: `EXACT` is the configuration's; `LOW` is the next
precision down (DECIMAL in float64 dollars, DOUBLE in float32), which the
benchmark's control runs in the engine's place and which must fail the
comparison.  Seeded by frozen copies of the chip smoke test's numpy
oracles for Q1, Q3, Q6 and Q12.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np

EPOCH = datetime.date(1970, 1, 1)


@dataclass
class Answer:
    """Rows in the query's order.  `kinds` has "x" for a cell compared as
    text (integers, DECIMALs, dates, strings) and "f" for a DOUBLE.  `key`
    holds the ORDER BY columns; rows with equal keys may come in any order.
    With a LIMIT, `rows` runs past it over every row tied with the last one
    kept, and `limit` says how many the engine returns."""
    rows: list
    kinds: str
    key: tuple = ()
    limit: int | None = None


# ------------------------------------------------------------ arithmetic

def format_decimal(v: int, scale: int) -> str:
    v = int(v)
    if scale == 0:
        return str(v)
    sign = "-" if v < 0 else ""
    ip, fp = divmod(abs(v), 10 ** scale)
    return f"{sign}{ip}.{fp:0{scale}d}"


class _Exact:
    """DECIMAL as scaled int64, DOUBLE as float64."""

    def money(self, a):            # a DECIMAL(15,2) column, cents
        return np.asarray(a).astype(np.int64)

    def one_minus(self, d):        # 1 - discount, scale 2
        return 100 - np.asarray(d).astype(np.int64)

    def one_plus(self, t):
        return 100 + np.asarray(t).astype(np.int64)

    def total(self, x):
        return int(np.asarray(x).sum(dtype=np.int64))

    def fmt(self, v, scale: int) -> str:
        return format_decimal(int(v), scale)

    def avg(self, s, n: int, scale: int) -> float:
        return float(s) / n / 10 ** scale

    def div(self, a, b) -> float:  # DECIMAL / DECIMAL at equal scales
        return int(a) / int(b)

    def gsum(self, gids, v, n: int) -> np.ndarray:
        """Exact grouped sums: three 21-bit pieces, each summed exactly in
        float64 by bincount."""
        v = np.asarray(v).astype(np.int64)
        out = np.zeros(n, dtype=np.int64)
        for shift in (0, 21, 42):
            piece = (v >> shift) & 0x1FFFFF if shift < 42 else v >> 42
            out += np.bincount(gids, weights=piece, minlength=n).astype(
                np.int64) << shift
        return out


class _Low(_Exact):
    """The control: DECIMAL in float64 dollars, DOUBLE in float32."""

    def money(self, a):
        return np.asarray(a) / 100.0

    def one_minus(self, d):
        return 1.0 - np.asarray(d) / 100.0

    def one_plus(self, t):
        return 1.0 + np.asarray(t) / 100.0

    def total(self, x):
        return float(np.asarray(x, dtype=np.float64).sum())

    def fmt(self, v, scale: int) -> str:
        return format_decimal(round(float(v) * 10 ** scale), scale)

    def avg(self, s, n: int, scale: int) -> float:
        return float(np.float32(s) / np.float32(n))

    def div(self, a, b) -> float:
        return float(np.float32(a) / np.float32(b))

    def gsum(self, gids, v, n: int) -> np.ndarray:
        return np.bincount(gids, weights=np.asarray(v, dtype=np.float64),
                           minlength=n)


EXACT = _Exact()
LOW = _Low()


# ---------------------------------------------------------------- helpers

def days(d: datetime.date) -> int:
    return (d - EPOCH).days


def iso(d) -> str:
    return (EPOCH + datetime.timedelta(days=int(d))).isoformat()


def add_months(d: datetime.date, k: int) -> datetime.date:
    m = d.month - 1 + k
    return datetime.date(d.year + m // 12, m % 12 + 1, d.day)


def year(d: np.ndarray) -> np.ndarray:
    return np.asarray(d).astype("datetime64[D]").astype(
        "datetime64[Y]").astype(np.int64) + 1970


def text(b) -> str:
    return bytes(b).decode("latin-1")


def enc(s: str) -> bytes:
    return s.encode("latin-1")


def lut(keys: np.ndarray, values, size: int | None = None, fill=-1):
    """A dense lookup table: out[key] = value."""
    keys = np.asarray(keys, dtype=np.int64)
    size = int(keys.max()) + 1 if size is None else size
    values = np.asarray(values)
    out = np.full(size, fill, dtype=values.dtype if values.ndim else
                  np.asarray(fill).dtype)
    out[keys] = values
    return out


def rowlut(keys: np.ndarray, size: int | None = None) -> np.ndarray:
    """Row index of each key, -1 where absent."""
    keys = np.asarray(keys, dtype=np.int64)
    return lut(keys, np.arange(len(keys), dtype=np.int64), size)


def like_contains(col: np.ndarray, *words: str) -> np.ndarray:
    """`col LIKE '%w1%w2%...'`: the words in this order, not overlapping."""
    col = np.asarray(col)
    first = np.char.find(col, enc(words[0])) >= 0
    if len(words) == 1:
        return first
    out = np.zeros(len(col), dtype=bool)
    for i in np.flatnonzero(first):
        s = col[i]
        pos = 0
        for w in words:
            j = s.find(enc(w), pos)
            if j < 0:
                break
            pos = j + len(w)
        else:
            out[i] = True
    return out


def order_rows(keys: list, limit: int | None):
    """Row order for ORDER BY `keys` (each (array, descending)), and the
    rows kept: the first `limit` and every row tied with the last kept."""
    cols = []
    for a, desc in reversed(keys):
        a = np.asarray(a)
        if desc:
            if a.dtype.kind in "iuf":
                a = -a.astype(np.float64 if a.dtype.kind == "f" else np.int64)
            else:                   # descending strings: rank them first
                _, inv = np.unique(a, return_inverse=True)
                a = -inv
        cols.append(a)
    order = np.lexsort(cols) if cols else np.arange(0)
    if limit is None or len(order) <= limit:
        return order
    last = order[limit - 1]
    n = limit
    while n < len(order) and all(
            np.asarray(a)[order[n]] == np.asarray(a)[last] for a, _ in keys):
        n += 1
    return order[:n]


def nation_names(db) -> np.ndarray:
    n = db.table("nation")
    return lut(n["n_nationkey"], np.asarray(n["n_name"]))


def nation_of_region(db, region: str) -> np.ndarray:
    """Boolean by nation key: is the nation in `region`?"""
    n, r = db.table("nation"), db.table("region")
    rkey = int(np.asarray(r["r_regionkey"])[np.asarray(r["r_name"])
                                              == enc(region)][0])
    return lut(n["n_nationkey"], np.asarray(n["n_regionkey"]) == rkey,
               fill=False)


def nation_key(db, name: str) -> int:
    n = db.table("nation")
    return int(np.asarray(n["n_nationkey"])[np.asarray(n["n_name"])
                                            == enc(name)][0])


# ----------------------------------------------------------------- queries

def q1(db, p, num):
    li = db.table("lineitem")
    cut = days(datetime.date(1998, 12, 1)) - p["delta"]
    sel = np.asarray(li["l_shipdate"]) <= cut
    rf = np.asarray(li["l_returnflag"])[sel].astype(np.int64)
    ls = np.asarray(li["l_linestatus"])[sel].astype(np.int64)
    g = rf * 256 + ls
    qty = num.money(np.asarray(li["l_quantity"])[sel])
    price = num.money(np.asarray(li["l_extendedprice"])[sel])
    disc_raw = np.asarray(li["l_discount"])[sel]
    disc = num.money(disc_raw)
    disc_price = price * num.one_minus(disc_raw)
    charge = disc_price * num.one_plus(np.asarray(li["l_tax"])[sel])
    rows = []
    for gid in np.unique(g):
        m = g == gid
        n = int(m.sum())
        s_qty, s_price = num.total(qty[m]), num.total(price[m])
        s_disc = num.total(disc[m])
        rows.append([chr(gid // 256), chr(gid % 256),
                     num.fmt(s_qty, 2), num.fmt(s_price, 2),
                     num.fmt(num.total(disc_price[m]), 4),
                     num.fmt(num.total(charge[m]), 6),
                     num.avg(s_qty, n, 2), num.avg(s_price, n, 2),
                     num.avg(s_disc, n, 2), str(n)])
    return Answer(rows, "xxxxxxfffx", key=(0, 1))


def q2(db, p, num):
    part, ps = db.table("part"), db.table("partsupp")
    sup = db.table("supplier")
    in_region = nation_of_region(db, p["region"])
    s_key = np.asarray(sup["s_suppkey"])
    s_row = rowlut(s_key)
    s_nat = np.asarray(sup["s_nationkey"])
    ps_part = np.asarray(ps["ps_partkey"])
    ps_supp = np.asarray(ps["ps_suppkey"])
    cost = np.asarray(ps["ps_supplycost"])
    ps_in = in_region[s_nat[s_row[ps_supp]]]
    minc = np.full(int(ps_part.max()) + 1, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(minc, ps_part[ps_in], cost[ps_in])
    p_key = np.asarray(part["p_partkey"])
    p_ok = lut(p_key, (np.asarray(part["p_size"]) == p["size"])
               & np.char.endswith(np.asarray(part["p_type"]),
                                  enc(p["type"])), fill=False)
    sel = np.flatnonzero(ps_in & p_ok[ps_part] & (cost == minc[ps_part]))
    sr = s_row[ps_supp[sel]]
    pr = rowlut(p_key)[ps_part[sel]]
    names = nation_names(db)
    acct = np.asarray(sup["s_acctbal"])[sr]
    n_name = names[s_nat[sr]]
    s_name = np.asarray(sup["s_name"])[sr]
    pk = ps_part[sel]
    order = order_rows([(acct, True), (n_name, False), (s_name, False),
                        (pk, False)], 100)
    rows = [[format_decimal(acct[i], 2), text(s_name[i]), text(n_name[i]),
             str(pk[i]), text(part["p_mfgr"][pr[i]]),
             text(sup["s_address"][sr[i]]), text(sup["s_phone"][sr[i]]),
             text(sup["s_comment"][sr[i]])] for i in order]
    return Answer(rows, "xxxxxxxx", key=(0, 1, 2, 3), limit=100)


def q3(db, p, num):
    cu, od, li = db.table("customer"), db.table("orders"), db.table("lineitem")
    cut = days(p["date"])
    in_seg = lut(cu["c_custkey"],
                 np.asarray(cu["c_mktsegment"]) == enc(p["segment"]),
                 fill=False)
    okey = np.asarray(od["o_orderkey"])
    odate = np.asarray(od["o_orderdate"])
    lk = np.asarray(li["l_orderkey"])
    size = int(max(okey.max(), lk.max())) + 1
    order_ok = lut(okey, (odate < cut) & in_seg[np.asarray(od["o_custkey"])],
                   size, fill=False)
    sel = (np.asarray(li["l_shipdate"]) > cut) & order_ok[lk]
    keys = lk[sel]
    rev = (num.money(np.asarray(li["l_extendedprice"])[sel])
           * num.one_minus(np.asarray(li["l_discount"])[sel]))
    uk, inv = np.unique(keys, return_inverse=True)
    sums = num.gsum(inv, rev, len(uk))
    orow = rowlut(okey, size)[uk]
    od_date = odate[orow]
    order = order_rows([(sums, True), (od_date, False)], 10)
    rows = [[str(uk[i]), num.fmt(sums[i], 4), iso(od_date[i]),
             str(np.asarray(od["o_shippriority"])[orow[i]])] for i in order]
    return Answer(rows, "xxxx", key=(1, 2), limit=10)


def q4(db, p, num):
    od, li = db.table("orders"), db.table("lineitem")
    lo, hi = days(p["date"]), days(add_months(p["date"], 3))
    okey = np.asarray(od["o_orderkey"])
    lk = np.asarray(li["l_orderkey"])
    size = int(max(okey.max(), lk.max())) + 1
    late = np.zeros(size, dtype=bool)
    late[lk[np.asarray(li["l_commitdate"])
            < np.asarray(li["l_receiptdate"])]] = True
    odate = np.asarray(od["o_orderdate"])
    sel = (odate >= lo) & (odate < hi) & late[okey]
    prio, counts = np.unique(np.asarray(od["o_orderpriority"])[sel],
                             return_counts=True)
    return Answer([[text(a), str(c)] for a, c in zip(prio, counts)], "xx",
                  key=(0,))


def _supp_nation(db) -> np.ndarray:
    s = db.table("supplier")
    return lut(s["s_suppkey"], np.asarray(s["s_nationkey"]).astype(np.int64))


def _cust_nation(db) -> np.ndarray:
    c = db.table("customer")
    return lut(c["c_custkey"], np.asarray(c["c_nationkey"]).astype(np.int64))


def q5(db, p, num):
    od, li = db.table("orders"), db.table("lineitem")
    lo, hi = days(p["date"]), days(add_months(p["date"], 12))
    okey = np.asarray(od["o_orderkey"])
    lk = np.asarray(li["l_orderkey"])
    size = int(max(okey.max(), lk.max())) + 1
    odate = np.asarray(od["o_orderdate"])
    cnat = _cust_nation(db)[np.asarray(od["o_custkey"])]
    cnat[(odate < lo) | (odate >= hi)] = -1
    onat = lut(okey, cnat, size)[lk]
    snat = _supp_nation(db)[np.asarray(li["l_suppkey"])]
    in_region = nation_of_region(db, p["region"])
    sel = (onat >= 0) & (onat == snat) & in_region[snat]
    rev = (num.money(np.asarray(li["l_extendedprice"])[sel])
           * num.one_minus(np.asarray(li["l_discount"])[sel]))
    nat = snat[sel]
    sums = num.gsum(nat, rev, 25)
    present = np.unique(nat)
    names = nation_names(db)
    order = order_rows([(sums[present], True)], None)
    rows = [[text(names[present[i]]), num.fmt(sums[present[i]], 4)]
            for i in order]
    return Answer(rows, "xx", key=(1,))


def q6(db, p, num):
    li = db.table("lineitem")
    lo, hi = days(p["date"]), days(add_months(p["date"], 12))
    ship = np.asarray(li["l_shipdate"])
    disc = np.asarray(li["l_discount"])
    sel = ((ship >= lo) & (ship < hi) & (disc >= p["discount"] - 1)
           & (disc <= p["discount"] + 1)
           & (np.asarray(li["l_quantity"]) < p["quantity"] * 100))
    if not sel.any():
        return Answer([["NULL"]], "x")
    total = num.total(num.money(np.asarray(li["l_extendedprice"])[sel])
                      * num.money(disc[sel]))
    return Answer([[num.fmt(total, 4)]], "x")


def q7(db, p, num):
    od, li = db.table("orders"), db.table("lineitem")
    n1, n2 = nation_key(db, p["nation1"]), nation_key(db, p["nation2"])
    ship = np.asarray(li["l_shipdate"])
    sel = ((ship >= days(datetime.date(1995, 1, 1)))
           & (ship <= days(datetime.date(1996, 12, 31))))
    snat = _supp_nation(db)[np.asarray(li["l_suppkey"])]
    sel &= (snat == n1) | (snat == n2)
    okey = np.asarray(od["o_orderkey"])
    lk = np.asarray(li["l_orderkey"])
    size = int(max(okey.max(), lk.max())) + 1
    onat = lut(okey, _cust_nation(db)[np.asarray(od["o_custkey"])], size)
    idx = np.flatnonzero(sel)
    cn = onat[lk[idx]]
    sn = snat[idx]
    keep = ((sn == n1) & (cn == n2)) | ((sn == n2) & (cn == n1))
    idx, cn, sn = idx[keep], cn[keep], sn[keep]
    yr = year(ship[idx])
    rev = (num.money(np.asarray(li["l_extendedprice"])[idx])
           * num.one_minus(np.asarray(li["l_discount"])[idx]))
    g = (sn * 25 + cn) * 4000 + yr
    ug, inv = np.unique(g, return_inverse=True)
    sums = num.gsum(inv, rev, len(ug))
    names = nation_names(db)
    gs, gc, gy = ug // 4000 // 25, ug // 4000 % 25, ug % 4000
    order = order_rows([(names[gs], False), (names[gc], False),
                        (gy, False)], None)
    rows = [[text(names[gs[i]]), text(names[gc[i]]), str(gy[i]),
             num.fmt(sums[i], 4)] for i in order]
    return Answer(rows, "xxxx", key=(0, 1, 2))


def q8(db, p, num):
    part, od, li = db.table("part"), db.table("orders"), db.table("lineitem")
    p_ok = lut(part["p_partkey"],
               np.asarray(part["p_type"]) == enc(p["type"]), fill=False)
    lsel = np.flatnonzero(p_ok[np.asarray(li["l_partkey"])])
    okey = np.asarray(od["o_orderkey"])
    lk = np.asarray(li["l_orderkey"])
    size = int(max(okey.max(), lk.max())) + 1
    odate = np.asarray(od["o_orderdate"])
    in_region = nation_of_region(db, p["region"])
    o_ok = ((odate >= days(datetime.date(1995, 1, 1)))
            & (odate <= days(datetime.date(1996, 12, 31)))
            & in_region[_cust_nation(db)[np.asarray(od["o_custkey"])]])
    orow = rowlut(okey, size)[lk[lsel]]
    keep = (orow >= 0)
    keep[keep] &= o_ok[orow[keep]]
    lsel, orow = lsel[keep], orow[keep]
    yr = year(odate[orow])
    vol = (num.money(np.asarray(li["l_extendedprice"])[lsel])
           * num.one_minus(np.asarray(li["l_discount"])[lsel]))
    mine = (_supp_nation(db)[np.asarray(li["l_suppkey"])[lsel]]
            == nation_key(db, p["nation"]))
    rows = []
    for y in np.unique(yr):
        m = yr == y
        a = num.total(vol[m & mine]) if (m & mine).any() else 0
        rows.append([str(y), num.div(a, num.total(vol[m]))])
    return Answer(rows, "xf", key=(0,))


def q9(db, p, num):
    part, ps = db.table("part"), db.table("partsupp")
    od, li = db.table("orders"), db.table("lineitem")
    p_ok = lut(part["p_partkey"],
               like_contains(np.asarray(part["p_name"]), p["color"]),
               fill=False)
    lpart = np.asarray(li["l_partkey"])
    lsel = np.flatnonzero(p_ok[lpart])
    lsupp = np.asarray(li["l_suppkey"])[lsel]
    ps_supp = np.asarray(ps["ps_suppkey"])
    width = int(ps_supp.max()) + 1
    ps_comb = np.asarray(ps["ps_partkey"]) * width + ps_supp
    order = np.argsort(ps_comb)
    at = np.searchsorted(ps_comb[order], lpart[lsel] * width + lsupp)
    cost = np.asarray(ps["ps_supplycost"])[order[at]]
    okey = np.asarray(od["o_orderkey"])
    lk = np.asarray(li["l_orderkey"])
    size = int(max(okey.max(), lk.max())) + 1
    yr = lut(okey, year(np.asarray(od["o_orderdate"])), size)[lk[lsel]]
    nat = _supp_nation(db)[lsupp]
    amount = (num.money(np.asarray(li["l_extendedprice"])[lsel])
              * num.one_minus(np.asarray(li["l_discount"])[lsel])
              - num.money(cost)
              * num.money(np.asarray(li["l_quantity"])[lsel]))
    g = nat * 4000 + yr
    ug, inv = np.unique(g, return_inverse=True)
    sums = num.gsum(inv, amount, len(ug))
    names = nation_names(db)
    gn, gy = ug // 4000, ug % 4000
    order = order_rows([(names[gn], False), (gy, True)], None)
    rows = [[text(names[gn[i]]), str(gy[i]), num.fmt(sums[i], 4)]
            for i in order]
    return Answer(rows, "xxx", key=(0, 1))


def q10(db, p, num):
    cu, od, li = db.table("customer"), db.table("orders"), db.table("lineitem")
    lo, hi = days(p["date"]), days(add_months(p["date"], 3))
    okey = np.asarray(od["o_orderkey"])
    lk = np.asarray(li["l_orderkey"])
    size = int(max(okey.max(), lk.max())) + 1
    odate = np.asarray(od["o_orderdate"])
    ocust = np.asarray(od["o_custkey"]).copy()
    ocust[(odate < lo) | (odate >= hi)] = -1
    lcust = lut(okey, ocust, size)[lk]
    sel = (lcust >= 0) & (np.asarray(li["l_returnflag"]) == ord("R"))
    rev = (num.money(np.asarray(li["l_extendedprice"])[sel])
           * num.one_minus(np.asarray(li["l_discount"])[sel]))
    uc, inv = np.unique(lcust[sel], return_inverse=True)
    sums = num.gsum(inv, rev, len(uc))
    order = order_rows([(sums, True)], 20)
    crow = rowlut(cu["c_custkey"])[uc]
    names = nation_names(db)
    rows = []
    for i in order:
        r = crow[i]
        rows.append([str(uc[i]), text(cu["c_name"][r]), num.fmt(sums[i], 4),
                     format_decimal(cu["c_acctbal"][r], 2),
                     text(names[cu["c_nationkey"][r]]),
                     text(cu["c_address"][r]), text(cu["c_phone"][r]),
                     text(cu["c_comment"][r])])
    return Answer(rows, "xxxxxxxx", key=(2,), limit=20)


def q11(db, p, num):
    ps = db.table("partsupp")
    snat = _supp_nation(db)[np.asarray(ps["ps_suppkey"])]
    sel = snat == nation_key(db, p["nation"])
    value = (num.money(np.asarray(ps["ps_supplycost"])[sel])
             * np.asarray(ps["ps_availqty"])[sel])
    up, inv = np.unique(np.asarray(ps["ps_partkey"])[sel],
                        return_inverse=True)
    sums = num.gsum(inv, value, len(up))
    total = num.total(value)
    if num is EXACT:
        # value > total * fraction, both exact: the fraction has 10 places
        frac = round(p["fraction"] * 10 ** 10)
        keep = sums > (total * frac) // 10 ** 10
    else:
        keep = sums > total * p["fraction"]
    up, sums = up[keep], sums[keep]
    order = order_rows([(sums, True)], None)
    rows = [[str(up[i]), num.fmt(sums[i], 2)] for i in order]
    return Answer(rows, "xx", key=(1,))


def q12(db, p, num):
    od, li = db.table("orders"), db.table("lineitem")
    lo, hi = days(p["date"]), days(add_months(p["date"], 12))
    mode = np.asarray(li["l_shipmode"])
    commit = np.asarray(li["l_commitdate"])
    receipt = np.asarray(li["l_receiptdate"])
    sel = (((mode == enc(p["shipmode1"])) | (mode == enc(p["shipmode2"])))
           & (commit < receipt) & (np.asarray(li["l_shipdate"]) < commit)
           & (receipt >= lo) & (receipt < hi))
    okey = np.asarray(od["o_orderkey"])
    lk = np.asarray(li["l_orderkey"])
    size = int(max(okey.max(), lk.max())) + 1
    prio = np.asarray(od["o_orderpriority"])
    high = lut(okey, (prio == b"1-URGENT") | (prio == b"2-HIGH"), size,
               fill=False)
    known = lut(okey, np.ones(len(okey), bool), size, fill=False)
    idx = np.flatnonzero(sel)
    idx = idx[known[lk[idx]]]
    h = high[lk[idx]]
    rows = []
    for m in sorted({mode[i] for i in idx}):
        mm = mode[idx] == m
        rows.append([text(m), str(int((mm & h).sum())),
                     str(int((mm & ~h).sum()))])
    return Answer(rows, "xxx", key=(0,))


def q13(db, p, num):
    cu, od = db.table("customer"), db.table("orders")
    bad = like_contains(np.asarray(od["o_comment"]), p["word1"], p["word2"])
    ck = np.asarray(cu["c_custkey"])
    size = int(max(ck.max(), np.asarray(od["o_custkey"]).max())) + 1
    per = np.bincount(np.asarray(od["o_custkey"])[~bad], minlength=size)
    c_count = per[ck]
    vals, dist = np.unique(c_count, return_counts=True)
    order = order_rows([(dist, True), (vals, True)], None)
    rows = [[str(vals[i]), str(dist[i])] for i in order]
    return Answer(rows, "xx", key=(1, 0))


def q14(db, p, num):
    part, li = db.table("part"), db.table("lineitem")
    lo, hi = days(p["date"]), days(add_months(p["date"], 1))
    ship = np.asarray(li["l_shipdate"])
    sel = (ship >= lo) & (ship < hi)
    promo = lut(part["p_partkey"],
                np.char.startswith(np.asarray(part["p_type"]), b"PROMO"),
                fill=False)[np.asarray(li["l_partkey"])[sel]]
    rev = (num.money(np.asarray(li["l_extendedprice"])[sel])
           * num.one_minus(np.asarray(li["l_discount"])[sel]))
    if not sel.any():
        return Answer([["NULL"]], "x")
    a = num.total(rev[promo]) if promo.any() else 0
    return Answer([[num.div(100 * a, num.total(rev))]], "f")


def q15(db, p, num):
    sup, li = db.table("supplier"), db.table("lineitem")
    lo, hi = days(p["date"]), days(add_months(p["date"], 3))
    ship = np.asarray(li["l_shipdate"])
    sel = (ship >= lo) & (ship < hi)
    rev = (num.money(np.asarray(li["l_extendedprice"])[sel])
           * num.one_minus(np.asarray(li["l_discount"])[sel]))
    us, inv = np.unique(np.asarray(li["l_suppkey"])[sel], return_inverse=True)
    sums = num.gsum(inv, rev, len(us))
    top = sums == sums.max()
    srow = rowlut(sup["s_suppkey"])
    rows = []
    for k, v in sorted(zip(us[top].tolist(), sums[top].tolist())):
        r = srow[k]
        rows.append([str(k), text(sup["s_name"][r]), text(sup["s_address"][r]),
                     text(sup["s_phone"][r]), num.fmt(v, 4)])
    return Answer(rows, "xxxxx", key=(0,))


def q16(db, p, num):
    part, ps = db.table("part"), db.table("partsupp")
    sup = db.table("supplier")
    bad_s = np.asarray(sup["s_suppkey"])[like_contains(
        np.asarray(sup["s_comment"]), "Customer", "Complaints")]
    brand = np.asarray(part["p_brand"])
    ptype = np.asarray(part["p_type"])
    size = np.asarray(part["p_size"])
    ok = ((brand != enc(p["brand"]))
          & ~np.char.startswith(ptype, enc(p["type"]))
          & np.isin(size, p["sizes"]))
    prow = rowlut(part["p_partkey"])
    ps_part = np.asarray(ps["ps_partkey"])
    ps_supp = np.asarray(ps["ps_suppkey"])
    r = prow[ps_part]
    sel = ok[r] & ~np.isin(ps_supp, bad_s)
    r, s = r[sel], ps_supp[sel]
    _, b = np.unique(brand, return_inverse=True)
    _, t = np.unique(ptype, return_inverse=True)
    g = (b[r].astype(np.int64) * 1000 + t[r]) * 100 + size[r]
    pairs = np.unique(g * (int(s.max()) + 1) + s)
    ug, cnt = np.unique(pairs // (int(s.max()) + 1), return_counts=True)
    first = {}
    for i, gi in zip(r.tolist(), g.tolist()):
        first.setdefault(gi, i)
    rep = np.array([first[x] for x in ug.tolist()], dtype=np.int64)
    order = order_rows([(cnt, True), (brand[rep], False), (ptype[rep], False),
                        (size[rep], False)], None)
    rows = [[text(brand[rep[i]]), text(ptype[rep[i]]), str(size[rep[i]]),
             str(cnt[i])] for i in order]
    return Answer(rows, "xxxx", key=(3, 0, 1, 2))


def q17(db, p, num):
    part, li = db.table("part"), db.table("lineitem")
    p_ok = lut(part["p_partkey"],
               (np.asarray(part["p_brand"]) == enc(p["brand"]))
               & (np.asarray(part["p_container"]) == enc(p["container"])),
               fill=False)
    lpart = np.asarray(li["l_partkey"])
    idx = np.flatnonzero(p_ok[lpart])
    qty = np.asarray(li["l_quantity"])[idx].astype(np.int64)
    up, inv = np.unique(lpart[idx], return_inverse=True)
    s = np.bincount(inv, weights=qty, minlength=len(up))   # exact: < 2**53
    n = np.bincount(inv, minlength=len(up))
    if num is EXACT:
        avg = s / n / 100.0
        keep = qty / 100.0 < 0.2 * avg[inv]
    else:
        avg = s.astype(np.float32) / np.float32(100) / n.astype(np.float32)
        keep = (qty / 100.0).astype(np.float32) < np.float32(0.2) * avg[inv]
    if not keep.any():
        return Answer([["NULL"]], "x")
    total = num.total(num.money(np.asarray(li["l_extendedprice"])[idx][keep]))
    # sum(l_extendedprice) / 7.0, the sum in cents or in dollars
    return Answer([[num.div(total, 700 if num is EXACT else 7)]], "f")


def q18(db, p, num):
    cu, od, li = db.table("customer"), db.table("orders"), db.table("lineitem")
    lk = np.asarray(li["l_orderkey"])
    okey = np.asarray(od["o_orderkey"])
    size = int(max(okey.max(), lk.max())) + 1
    qsum = num.gsum(lk, num.money(np.asarray(li["l_quantity"])), size)
    big = np.flatnonzero(qsum > p["quantity"] * (100 if num is EXACT else 1))
    orow = rowlut(okey, size)[big]
    big, orow = big[orow >= 0], orow[orow >= 0]
    price = np.asarray(od["o_totalprice"])[orow]
    odate = np.asarray(od["o_orderdate"])[orow]
    order = order_rows([(price, True), (odate, False)], 100)
    crow = rowlut(cu["c_custkey"])
    rows = []
    for i in order:
        ck = int(od["o_custkey"][orow[i]])
        rows.append([text(cu["c_name"][crow[ck]]), str(ck), str(big[i]),
                     iso(odate[i]), format_decimal(price[i], 2),
                     num.fmt(qsum[big[i]], 2)])
    return Answer(rows, "xxxxxx", key=(4, 3), limit=100)


Q19_ARMS = ((("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 5),
            (("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10),
            (("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 15))


def q19(db, p, num):
    part, li = db.table("part"), db.table("lineitem")
    mode = np.asarray(li["l_shipmode"])
    pre = np.flatnonzero(((mode == b"AIR") | (mode == b"AIR REG"))
                         & (np.asarray(li["l_shipinstruct"])
                            == b"DELIVER IN PERSON"))
    prow = rowlut(part["p_partkey"])[np.asarray(li["l_partkey"])[pre]]
    brand = np.asarray(part["p_brand"])[prow]
    cont = np.asarray(part["p_container"])[prow]
    size = np.asarray(part["p_size"])[prow]
    qty = np.asarray(li["l_quantity"])[pre]
    sel = np.zeros(len(pre), dtype=bool)
    for i, (conts, smax) in enumerate(Q19_ARMS, 1):
        q = p[f"quantity{i}"] * 100
        sel |= ((brand == enc(p[f"brand{i}"]))
                & np.isin(cont, [enc(c) for c in conts])
                & (qty >= q) & (qty <= q + 1000) & (size >= 1)
                & (size <= smax))
    if not sel.any():
        return Answer([["NULL"]], "x")
    idx = pre[sel]
    rev = (num.money(np.asarray(li["l_extendedprice"])[idx])
           * num.one_minus(np.asarray(li["l_discount"])[idx]))
    return Answer([[num.fmt(num.total(rev), 4)]], "x")


def q20(db, p, num):
    part, ps = db.table("part"), db.table("partsupp")
    sup, li = db.table("supplier"), db.table("lineitem")
    p_ok = lut(part["p_partkey"],
               np.char.startswith(np.asarray(part["p_name"]),
                                  enc(p["color"])), fill=False)
    lo, hi = days(p["date"]), days(add_months(p["date"], 12))
    ship = np.asarray(li["l_shipdate"])
    lpart = np.asarray(li["l_partkey"])
    sel = np.flatnonzero((ship >= lo) & (ship < hi) & p_ok[lpart])
    ps_part = np.asarray(ps["ps_partkey"])
    ps_supp = np.asarray(ps["ps_suppkey"])
    width = int(ps_supp.max()) + 1
    comb = lpart[sel] * width + np.asarray(li["l_suppkey"])[sel]
    uc, inv = np.unique(comb, return_inverse=True)
    qsum = np.bincount(inv, weights=np.asarray(li["l_quantity"])[sel],
                       minlength=len(uc))             # exact: < 2**53
    pss = np.flatnonzero(p_ok[ps_part])
    pcomb = ps_part[pss] * width + ps_supp[pss]
    at = np.clip(np.searchsorted(uc, pcomb), 0, max(len(uc) - 1, 0))
    has = (len(uc) > 0) & (uc[at] == pcomb) if len(uc) else \
        np.zeros(len(pss), dtype=bool)
    avail = np.asarray(ps["ps_availqty"])[pss]
    if num is EXACT:
        # availqty > 0.5 * sum(l_quantity): scale 3 on both sides
        more = avail * 1000 > 5 * qsum[at].astype(np.int64)
    else:
        more = avail > 0.5 * (qsum[at] / 100.0)
    good = np.unique(ps_supp[pss][has & more])
    s_ok = np.isin(np.asarray(sup["s_suppkey"]), good) & (
        np.asarray(sup["s_nationkey"]) == nation_key(db, p["nation"]))
    names = np.asarray(sup["s_name"])[s_ok]
    addr = np.asarray(sup["s_address"])[s_ok]
    order = order_rows([(names, False)], None)
    rows = [[text(names[i]), text(addr[i])] for i in order]
    return Answer(rows, "xx", key=(0,))


def q21(db, p, num):
    sup, od = db.table("supplier"), db.table("orders")
    li = db.table("lineitem")
    lk = np.asarray(li["l_orderkey"])
    ls = np.asarray(li["l_suppkey"])
    okey = np.asarray(od["o_orderkey"])
    size = int(max(okey.max(), lk.max())) + 1
    late = np.asarray(li["l_receiptdate"]) > np.asarray(li["l_commitdate"])
    width = int(ls.max()) + 1
    pairs = np.unique(lk * width + ls)
    n_supp = np.bincount(pairs // width, minlength=size)
    late_pairs = np.unique(lk[late] * width + ls[late])
    n_late = np.bincount(late_pairs // width, minlength=size)
    status_f = lut(okey, np.asarray(od["o_orderstatus"]) == ord("F"), size,
                   fill=False)
    s_nat = _supp_nation(db)
    sel = (late & status_f[lk] & (n_supp[lk] >= 2) & (n_late[lk] == 1)
           & (s_nat[ls] == nation_key(db, p["nation"])))
    us, cnt = np.unique(ls[sel], return_counts=True)
    names = np.asarray(sup["s_name"])[rowlut(sup["s_suppkey"])[us]]
    order = order_rows([(cnt, True), (names, False)], 100)
    rows = [[text(names[i]), str(cnt[i])] for i in order]
    return Answer(rows, "xx", key=(1, 0), limit=100)


def q22(db, p, num):
    cu, od = db.table("customer"), db.table("orders")
    code = np.asarray(cu["c_phone"]).astype("S2")
    in_codes = np.isin(code, [enc(c) for c in p["codes"]])
    bal = np.asarray(cu["c_acctbal"])
    pos = in_codes & (bal > 0)
    avg = num.avg(num.total(num.money(bal[pos])) if num is LOW
                  else int(bal[pos].sum()), int(pos.sum()),
                  0 if num is LOW else 2)
    ck = np.asarray(cu["c_custkey"])
    size = int(max(ck.max(), np.asarray(od["o_custkey"]).max())) + 1
    has_order = np.zeros(size, dtype=bool)
    has_order[np.asarray(od["o_custkey"])] = True
    sel = in_codes & (bal / 100.0 > avg) & ~has_order[ck]
    rows = []
    for c in sorted(set(code[sel].tolist())):
        m = sel & (code == c)
        rows.append([text(c), str(int(m.sum())),
                     num.fmt(num.total(num.money(bal[m])), 2)])
    return Answer(rows, "xxx", key=(0,))


QUERIES = {n: globals()[f"q{n}"] for n in range(1, 23)}


def answer(n: int, db, p: dict, num=EXACT) -> Answer:
    return QUERIES[n](db, p, num)
