"""TPC-H substitution parameters (clause 2.4) and the 22 query texts.

`draw(n, rng, sf)` picks query n's parameters uniformly from the domains of
clause 2.4.n; `text(n, params)` writes the query in DuckDB's form of
`qNN.sql` (dates as CAST literals, interval arithmetic folded), which is
what the engine's parser takes.  The lists come from the benchmark's own
copy of dbgen's distributions, so the domains are the data's.
"""

from __future__ import annotations

import datetime
import functools
import json
import os

import numpy as np

_DISTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                      "dists.json")


@functools.cache
def dist(name: str) -> list[str]:
    """The texts of one of dbgen's distributions."""
    with open(_DISTS) as f:
        return [t for t, _ in json.load(f)[name]]


# N_REGIONKEY of each nation, in nation key order (clause 4.2.3)
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                 4, 2, 3, 3, 1]
Q13_WORD1 = ["special", "pending", "unusual", "express"]
Q13_WORD2 = ["packages", "requests", "accounts", "deposits"]

# Appendix A: the query order of stream 00, the power test's stream
STREAM_00 = [14, 2, 9, 20, 6, 17, 18, 8, 21, 13, 3, 22, 16, 4, 11, 15, 1, 10,
             19, 5, 7, 12]


def _syllables(i: int) -> list[str]:
    """The i-th words of the part types (clause 4.2.2.13)."""
    return sorted({t.split()[i] for t in dist("p_types")})


def _day(y, m, d=1) -> datetime.date:
    return datetime.date(y, m, d)


def _add_months(d: datetime.date, k: int) -> datetime.date:
    m = d.month - 1 + k
    return datetime.date(d.year + m // 12, m % 12 + 1, d.day)


def _month(rng, first: tuple, count: int) -> datetime.date:
    """First day of a month drawn from `count` months starting at `first`."""
    return _add_months(_day(*first), int(rng.integers(0, count)))


def _year_start(rng) -> datetime.date:
    return _day(int(rng.integers(1993, 1998)), 1)


def _pick(rng, items, k=None):
    if k is None:
        return items[int(rng.integers(0, len(items)))]
    return [items[int(i)] for i in rng.choice(len(items), k, replace=False)]


def _brand(rng) -> str:
    return f"Brand#{int(rng.integers(1, 6))}{int(rng.integers(1, 6))}"


def draw(n: int, rng: np.random.Generator, sf: float) -> dict:
    """Query n's substitution parameters (clause 2.4.n)."""
    if n == 1:
        return {"delta": int(rng.integers(60, 121))}
    if n == 2:
        return {"size": int(rng.integers(1, 51)),
                "type": _pick(rng, _syllables(2)),
                "region": _pick(rng, dist("regions"))}
    if n == 3:
        return {"segment": _pick(rng, dist("msegmnt")),
                "date": _day(1995, 3, int(rng.integers(1, 32)))}
    if n == 4:
        return {"date": _month(rng, (1993, 1), 58)}
    if n == 5:
        return {"region": _pick(rng, dist("regions")),
                "date": _year_start(rng)}
    if n == 6:
        return {"date": _year_start(rng),
                "discount": int(rng.integers(2, 10)),   # hundredths
                "quantity": int(rng.integers(24, 26))}
    if n == 7:
        n1, n2 = _pick(rng, dist("nations"), 2)
        return {"nation1": n1, "nation2": n2}
    if n == 8:
        nation = int(rng.integers(0, len(dist("nations"))))
        return {"nation": dist("nations")[nation],
                "region": dist("regions")[NATION_REGION[nation]],
                "type": _pick(rng, dist("p_types"))}
    if n == 9:
        return {"color": _pick(rng, dist("colors"))}
    if n == 10:
        return {"date": _month(rng, (1993, 2), 24)}
    if n == 11:
        return {"nation": _pick(rng, dist("nations")),
                "fraction": 0.0001 / sf}
    if n == 12:
        m1, m2 = _pick(rng, dist("smode"), 2)
        return {"shipmode1": m1, "shipmode2": m2, "date": _year_start(rng)}
    if n == 13:
        return {"word1": _pick(rng, Q13_WORD1),
                "word2": _pick(rng, Q13_WORD2)}
    if n == 14:
        return {"date": _month(rng, (1993, 1), 60)}
    if n == 15:
        return {"date": _month(rng, (1993, 1), 58)}
    if n == 16:
        return {"brand": _brand(rng),
                "type": (f"{_pick(rng, _syllables(0))} "
                         f"{_pick(rng, _syllables(1))}"),
                "sizes": [int(s) + 1
                          for s in rng.choice(50, 8, replace=False)]}
    if n == 17:
        return {"brand": _brand(rng), "container": _pick(rng, dist("p_cntr"))}
    if n == 18:
        return {"quantity": int(rng.integers(312, 316))}
    if n == 19:
        return {"quantity1": int(rng.integers(1, 11)),
                "quantity2": int(rng.integers(10, 21)),
                "quantity3": int(rng.integers(20, 31)),
                "brand1": _brand(rng), "brand2": _brand(rng),
                "brand3": _brand(rng)}
    if n == 20:
        return {"color": _pick(rng, dist("colors")),
                "date": _year_start(rng),
                "nation": _pick(rng, dist("nations"))}
    if n == 21:
        return {"nation": _pick(rng, dist("nations"))}
    if n == 22:
        return {"codes": [str(c + 10) for c in rng.choice(25, 7,
                                                            replace=False)]}
    raise ValueError(f"no TPC-H query {n}")


def draw_set(rng: np.random.Generator, sf: float) -> dict:
    """One substitution set: {query number: parameters}, drawn in query
    order."""
    return {n: draw(n, rng, sf) for n in range(1, 23)}


def _d(x: datetime.date) -> str:
    return f"CAST('{x.isoformat()}' AS date)"


def _q(s: str) -> str:
    return "'" + s.replace("'", "''") + "'"


def _in(items) -> str:
    return ", ".join(_q(s) if isinstance(s, str) else str(s) for s in items)


def text(n: int, p: dict) -> str:
    """Query n's SQL with parameters `p`."""
    if n == 1:
        cut = _day(1998, 12, 1) - datetime.timedelta(days=p["delta"])
        return f"""SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty,
    sum(l_extendedprice) AS sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
    avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
    avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= {_d(cut)}
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus;"""
    if n == 2:
        return f"""SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment
FROM part, supplier, partsupp, nation, region
WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey AND p_size = {p["size"]}
    AND p_type LIKE {_q('%' + p["type"])} AND s_nationkey = n_nationkey
    AND n_regionkey = r_regionkey AND r_name = {_q(p["region"])}
    AND ps_supplycost = (
        SELECT min(ps_supplycost) FROM partsupp, supplier, nation, region
        WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
            AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
            AND r_name = {_q(p["region"])})
ORDER BY s_acctbal DESC, n_name, s_name, p_partkey
LIMIT 100;"""
    if n == 3:
        return f"""SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
    o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = {_q(p["segment"])} AND c_custkey = o_custkey
    AND l_orderkey = o_orderkey AND o_orderdate < {_d(p["date"])}
    AND l_shipdate > {_d(p["date"])}
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate
LIMIT 10;"""
    if n == 4:
        return f"""SELECT o_orderpriority, count(*) AS order_count
FROM orders
WHERE o_orderdate >= {_d(p["date"])}
    AND o_orderdate < {_d(_add_months(p["date"], 3))}
    AND EXISTS (SELECT * FROM lineitem
                WHERE l_orderkey = o_orderkey AND l_commitdate < l_receiptdate)
GROUP BY o_orderpriority
ORDER BY o_orderpriority;"""
    if n == 5:
        return f"""SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM customer, orders, lineitem, supplier, nation, region
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
    AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
    AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
    AND r_name = {_q(p["region"])} AND o_orderdate >= {_d(p["date"])}
    AND o_orderdate < {_d(_add_months(p["date"], 12))}
GROUP BY n_name
ORDER BY revenue DESC;"""
    if n == 6:
        lo, hi = p["discount"] - 1, p["discount"] + 1
        return f"""SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= {_d(p["date"])}
    AND l_shipdate < {_d(_add_months(p["date"], 12))}
    AND l_discount BETWEEN 0.{lo:02d} AND 0.{hi:02d}
    AND l_quantity < {p["quantity"]};"""
    if n == 7:
        a, b = _q(p["nation1"]), _q(p["nation2"])
        return f"""SELECT supp_nation, cust_nation, l_year, sum(volume) AS revenue
FROM (
    SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
        extract(year FROM l_shipdate) AS l_year,
        l_extendedprice * (1 - l_discount) AS volume
    FROM supplier, lineitem, orders, customer, nation n1, nation n2
    WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey
        AND c_custkey = o_custkey AND s_nationkey = n1.n_nationkey
        AND c_nationkey = n2.n_nationkey
        AND ((n1.n_name = {a} AND n2.n_name = {b})
            OR (n1.n_name = {b} AND n2.n_name = {a}))
        AND l_shipdate BETWEEN CAST('1995-01-01' AS date)
        AND CAST('1996-12-31' AS date)) AS shipping
GROUP BY supp_nation, cust_nation, l_year
ORDER BY supp_nation, cust_nation, l_year;"""
    if n == 8:
        return f"""SELECT o_year,
    sum(CASE WHEN nation = {_q(p["nation"])} THEN volume ELSE 0 END)
        / sum(volume) AS mkt_share
FROM (
    SELECT extract(year FROM o_orderdate) AS o_year,
        l_extendedprice * (1 - l_discount) AS volume, n2.n_name AS nation
    FROM part, supplier, lineitem, orders, customer, nation n1, nation n2,
        region
    WHERE p_partkey = l_partkey AND s_suppkey = l_suppkey
        AND l_orderkey = o_orderkey AND o_custkey = c_custkey
        AND c_nationkey = n1.n_nationkey AND n1.n_regionkey = r_regionkey
        AND r_name = {_q(p["region"])} AND s_nationkey = n2.n_nationkey
        AND o_orderdate BETWEEN CAST('1995-01-01' AS date)
        AND CAST('1996-12-31' AS date)
        AND p_type = {_q(p["type"])}) AS all_nations
GROUP BY o_year
ORDER BY o_year;"""
    if n == 9:
        return f"""SELECT nation, o_year, sum(amount) AS sum_profit
FROM (
    SELECT n_name AS nation, extract(year FROM o_orderdate) AS o_year,
        l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity
            AS amount
    FROM part, supplier, lineitem, partsupp, orders, nation
    WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
        AND ps_partkey = l_partkey AND p_partkey = l_partkey
        AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey
        AND p_name LIKE {_q('%' + p["color"] + '%')}) AS profit
GROUP BY nation, o_year
ORDER BY nation, o_year DESC;"""
    if n == 10:
        return f"""SELECT c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) AS revenue,
    c_acctbal, n_name, c_address, c_phone, c_comment
FROM customer, orders, lineitem, nation
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
    AND o_orderdate >= {_d(p["date"])}
    AND o_orderdate < {_d(_add_months(p["date"], 3))}
    AND l_returnflag = 'R' AND c_nationkey = n_nationkey
GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
ORDER BY revenue DESC
LIMIT 20;"""
    if n == 11:
        nat = _q(p["nation"])
        return f"""SELECT ps_partkey, sum(ps_supplycost * ps_availqty) AS value
FROM partsupp, supplier, nation
WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey AND n_name = {nat}
GROUP BY ps_partkey
HAVING sum(ps_supplycost * ps_availqty) > (
    SELECT sum(ps_supplycost * ps_availqty) * {p["fraction"]:.10f}
    FROM partsupp, supplier, nation
    WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
        AND n_name = {nat})
ORDER BY value DESC;"""
    if n == 12:
        return f"""SELECT l_shipmode,
    sum(CASE WHEN o_orderpriority = '1-URGENT' OR o_orderpriority = '2-HIGH'
        THEN 1 ELSE 0 END) AS high_line_count,
    sum(CASE WHEN o_orderpriority <> '1-URGENT'
        AND o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END) AS low_line_count
FROM orders, lineitem
WHERE o_orderkey = l_orderkey
    AND l_shipmode IN ({_in([p["shipmode1"], p["shipmode2"]])})
    AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
    AND l_receiptdate >= {_d(p["date"])}
    AND l_receiptdate < {_d(_add_months(p["date"], 12))}
GROUP BY l_shipmode
ORDER BY l_shipmode;"""
    if n == 13:
        pat = _q(f"%{p['word1']}%{p['word2']}%")
        return f"""SELECT c_count, count(*) AS custdist
FROM (
    SELECT c_custkey, count(o_orderkey)
    FROM customer LEFT OUTER JOIN orders ON c_custkey = o_custkey
        AND o_comment NOT LIKE {pat}
    GROUP BY c_custkey) AS c_orders (c_custkey, c_count)
GROUP BY c_count
ORDER BY custdist DESC, c_count DESC;"""
    if n == 14:
        return f"""SELECT 100.00 * sum(CASE WHEN p_type LIKE 'PROMO%'
        THEN l_extendedprice * (1 - l_discount) ELSE 0 END)
    / sum(l_extendedprice * (1 - l_discount)) AS promo_revenue
FROM lineitem, part
WHERE l_partkey = p_partkey AND l_shipdate >= {_d(p["date"])}
    AND l_shipdate < {_d(_add_months(p["date"], 1))};"""
    if n == 15:
        lo, hi = _d(p["date"]), _d(_add_months(p["date"], 3))
        rev = f"""SELECT l_suppkey AS supplier_no,
            sum(l_extendedprice * (1 - l_discount)) AS total_revenue
        FROM lineitem
        WHERE l_shipdate >= {lo} AND l_shipdate < {hi}
        GROUP BY supplier_no"""
        return f"""SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
FROM supplier, ({rev}) revenue0
WHERE s_suppkey = supplier_no
    AND total_revenue = (SELECT max(total_revenue) FROM ({rev}) revenue1)
ORDER BY s_suppkey;"""
    if n == 16:
        return f"""SELECT p_brand, p_type, p_size, count(DISTINCT ps_suppkey) AS supplier_cnt
FROM partsupp, part
WHERE p_partkey = ps_partkey AND p_brand <> {_q(p["brand"])}
    AND p_type NOT LIKE {_q(p["type"] + '%')}
    AND p_size IN ({_in(p["sizes"])})
    AND ps_suppkey NOT IN (
        SELECT s_suppkey FROM supplier
        WHERE s_comment LIKE '%Customer%Complaints%')
GROUP BY p_brand, p_type, p_size
ORDER BY supplier_cnt DESC, p_brand, p_type, p_size;"""
    if n == 17:
        return f"""SELECT sum(l_extendedprice) / 7.0 AS avg_yearly
FROM lineitem, part
WHERE p_partkey = l_partkey AND p_brand = {_q(p["brand"])}
    AND p_container = {_q(p["container"])}
    AND l_quantity < (SELECT 0.2 * avg(l_quantity) FROM lineitem
                      WHERE l_partkey = p_partkey);"""
    if n == 18:
        return f"""SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
FROM customer, orders, lineitem
WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem GROUP BY l_orderkey
                     HAVING sum(l_quantity) > {p["quantity"]})
    AND c_custkey = o_custkey AND o_orderkey = l_orderkey
GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
ORDER BY o_totalprice DESC, o_orderdate
LIMIT 100;"""
    if n == 19:
        arms = []
        for i, (conts, size) in enumerate(
                ((("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 5),
                 (("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10),
                 (("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 15)), 1):
            q = p[f"quantity{i}"]
            arms.append(f"""(p_partkey = l_partkey
        AND p_brand = {_q(p[f"brand{i}"])}
        AND p_container IN ({_in(conts)})
        AND l_quantity >= {q} AND l_quantity <= {q} + 10
        AND p_size BETWEEN 1 AND {size}
        AND l_shipmode IN ('AIR', 'AIR REG')
        AND l_shipinstruct = 'DELIVER IN PERSON')""")
        return ("SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue\n"
                "FROM lineitem, part\nWHERE " + "\n    OR ".join(arms) + ";")
    if n == 20:
        return f"""SELECT s_name, s_address
FROM supplier, nation
WHERE s_suppkey IN (
        SELECT ps_suppkey FROM partsupp
        WHERE ps_partkey IN (SELECT p_partkey FROM part
                             WHERE p_name LIKE {_q(p["color"] + '%')})
            AND ps_availqty > (
                SELECT 0.5 * sum(l_quantity) FROM lineitem
                WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
                    AND l_shipdate >= {_d(p["date"])}
                    AND l_shipdate < {_d(_add_months(p["date"], 12))}))
    AND s_nationkey = n_nationkey AND n_name = {_q(p["nation"])}
ORDER BY s_name;"""
    if n == 21:
        return f"""SELECT s_name, count(*) AS numwait
FROM supplier, lineitem l1, orders, nation
WHERE s_suppkey = l1.l_suppkey AND o_orderkey = l1.l_orderkey
    AND o_orderstatus = 'F' AND l1.l_receiptdate > l1.l_commitdate
    AND EXISTS (SELECT * FROM lineitem l2
                WHERE l2.l_orderkey = l1.l_orderkey
                    AND l2.l_suppkey <> l1.l_suppkey)
    AND NOT EXISTS (SELECT * FROM lineitem l3
                    WHERE l3.l_orderkey = l1.l_orderkey
                        AND l3.l_suppkey <> l1.l_suppkey
                        AND l3.l_receiptdate > l3.l_commitdate)
    AND s_nationkey = n_nationkey AND n_name = {_q(p["nation"])}
GROUP BY s_name
ORDER BY numwait DESC, s_name
LIMIT 100;"""
    if n == 22:
        codes = _in(p["codes"])
        return f"""SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal
FROM (
    SELECT substring(c_phone FROM 1 FOR 2) AS cntrycode, c_acctbal
    FROM customer
    WHERE substring(c_phone FROM 1 FOR 2) IN ({codes})
        AND c_acctbal > (
            SELECT avg(c_acctbal) FROM customer
            WHERE c_acctbal > 0.00
                AND substring(c_phone FROM 1 FOR 2) IN ({codes}))
        AND NOT EXISTS (SELECT * FROM orders WHERE o_custkey = c_custkey))
    AS custsale
GROUP BY cntrycode
ORDER BY cntrycode;"""
    raise ValueError(f"no TPC-H query {n}")
