"""Analytic SQL over the TPC-H catalog: window functions, a band join and an
ASOF join, at the scale of the whole catalog.

W1 and W2 are windows over lineitem (one partition per order) and orders
(one per customer), R1 a calendar band join of lineitem against a table of
84 monthly bands, A1 each order's previous order by the same customer.
`chip_smoke.py` runs them on the card and the port's tests at SF0.01.
"""

from __future__ import annotations

# lineitem: a partition per order, the running SUM (the default RANGE
# frame), a sliding MAX over ROWS and LAG with a default; one row out
W1 = """
    SELECT count(*) AS n, sum(rn) AS s_rn, sum(rs) AS s_rs, sum(mq) AS s_mq,
           sum(lg) AS s_lg
    FROM (SELECT row_number() OVER (PARTITION BY l_orderkey
                                    ORDER BY l_linenumber) AS rn,
                 sum(l_extendedprice) OVER (PARTITION BY l_orderkey
                                            ORDER BY l_linenumber) AS rs,
                 max(l_quantity) OVER (PARTITION BY l_orderkey
                                       ORDER BY l_linenumber
                                       ROWS BETWEEN 1 PRECEDING
                                       AND 1 FOLLOWING) AS mq,
                 lag(l_quantity, 1, 0) OVER (PARTITION BY l_orderkey
                                             ORDER BY l_linenumber) AS lg
          FROM lineitem) AS w
"""

# orders: a partition per customer, rank() by price and a 90-day RANGE
# frame over the order date
W2 = """
    SELECT o_orderkey, o_custkey, o_totalprice, s90
    FROM (SELECT o_orderkey, o_custkey, o_totalprice,
                 rank() OVER (PARTITION BY o_custkey
                              ORDER BY o_totalprice DESC) AS rk,
                 sum(o_totalprice) OVER (PARTITION BY o_custkey
                                         ORDER BY o_orderdate
                                         RANGE BETWEEN 90 PRECEDING
                                         AND CURRENT ROW) AS s90
          FROM orders) AS w
    WHERE rk = 1
    ORDER BY o_totalprice DESC, o_orderkey
    LIMIT 10
"""


def month_bands() -> list[str]:
    """The statements that make `months(lo, hi, m)`: the 84 months from
    1992-01 to 1998-12 as [lo, hi) date bands."""
    values = []
    for m in range(84):
        y, mo = 1992 + m // 12, m % 12 + 1
        y2, mo2 = (y, mo + 1) if mo < 12 else (y + 1, 1)
        values.append(f"(DATE '{y}-{mo:02d}-01', DATE '{y2}-{mo2:02d}-01', "
                      f"{m})")
    return ["CREATE TABLE months (lo DATE, hi DATE, m INTEGER)",
            "INSERT INTO months VALUES " + ", ".join(values)]


# lineitem against the month bands: two bounds and one residual
R1 = """
    SELECT m, count(*) AS n, sum(l_extendedprice) AS rev
    FROM lineitem, months
    WHERE l_shipdate >= lo AND l_shipdate < hi AND l_commitdate < hi
    GROUP BY m
    ORDER BY m
"""

# each order's previous order by the same customer
A1 = """
    SELECT count(*) AS n, sum(o2.o_totalprice) AS s
    FROM orders o1 ASOF JOIN orders o2
      ON o1.o_custkey = o2.o_custkey AND o1.o_orderdate > o2.o_orderdate
"""
A1_LEFT = """
    SELECT count(*) AS n
    FROM orders o1 ASOF LEFT JOIN orders o2
      ON o1.o_custkey = o2.o_custkey AND o1.o_orderdate > o2.o_orderdate
"""

QUERIES = {"W1": W1, "W2": W2, "R1": R1, "A1": A1, "A1_LEFT": A1_LEFT}
