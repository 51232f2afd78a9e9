"""The 22 TPC-H queries as physical plan builders.

Counterpart of `duckdb_cubit_tpu/tpch/queries.py`.  Each builder mirrors the
SQL under DuckDB's extension/tpch/dbgen/queries/ (q01.sql .. q22.sql).
Plans are built against the engine DSL and then run through the optimizer,
which resolves filter pushdown and CUBIT index matching.

The builders are the reference's, line for line, with one change: q15 reads
its host scalar through `.cpu()`, because `np.asarray` of a CUDA tensor
raises.  So this file is not a byte-identical copy and is not held to the
reference by the frontend drift test; the differential test of all 22
builders holds it instead.  (q11 and q22 read theirs with `int(...)` of one
element, which works on either device.)
"""

from __future__ import annotations

from ..ops.expressions import Case, Col, Lit, Substr, date_lit, dec_lit
from ..plan.physical import (Aggregate, Filter, GroupAggregate, HashJoin,
                             Limit, OrderBy, Project, TableScan)


def multi_phase(fn):
    """Mark a query as needing executor access (host-resolved scalars)."""
    fn.multi_phase = True
    return fn


def col(n):
    return Col(n)


def q1():
    scan = TableScan(
        "lineitem",
        filters=[col("l_shipdate") <= date_lit("1998-09-02")],
        projection=["l_returnflag", "l_linestatus", "l_quantity",
                    "l_extendedprice", "l_discount", "l_tax"],
    )
    disc_price = col("l_extendedprice") * (dec_lit(1) - col("l_discount"))
    charge = disc_price * (dec_lit(1) + col("l_tax"))
    agg = GroupAggregate(scan, ["l_returnflag", "l_linestatus"], [
        Aggregate("sum", col("l_quantity"), "sum_qty"),
        Aggregate("sum", col("l_extendedprice"), "sum_base_price"),
        Aggregate("sum", disc_price, "sum_disc_price"),
        Aggregate("sum", charge, "sum_charge"),
        Aggregate("avg", col("l_quantity"), "avg_qty"),
        Aggregate("avg", col("l_extendedprice"), "avg_price"),
        Aggregate("avg", col("l_discount"), "avg_disc"),
        Aggregate("count", None, "count_order"),
    ])
    return OrderBy(agg, [("l_returnflag", False), ("l_linestatus", False)])


def q6():
    scan = TableScan(
        "lineitem",
        filters=[
            col("l_shipdate") >= date_lit("1994-01-01"),
            col("l_shipdate") < date_lit("1995-01-01"),
            col("l_discount").between(dec_lit("0.05"), dec_lit("0.07")),
            col("l_quantity") < dec_lit(24),
        ],
        projection=["l_extendedprice", "l_discount"],
    )
    return GroupAggregate(scan, [], [
        Aggregate("sum", col("l_extendedprice") * col("l_discount"), "revenue"),
    ])


def _disc_price():
    return Col("l_extendedprice") * (dec_lit(1) - Col("l_discount"))


def q3():
    cust = TableScan("customer",
                     filters=[col("c_mktsegment") == "BUILDING"],
                     projection=["c_custkey"])
    orders = TableScan(
        "orders",
        filters=[col("o_orderdate") < date_lit("1995-03-15")],
        projection=["o_orderkey", "o_orderdate", "o_shippriority", "o_custkey"])
    orders_f = HashJoin(orders, cust, ["o_custkey"], ["c_custkey"], "semi")
    li = TableScan(
        "lineitem",
        filters=[col("l_shipdate") > date_lit("1995-03-15")],
        projection=["l_orderkey", "l_extendedprice", "l_discount"])
    j = HashJoin(li, orders_f, ["l_orderkey"], ["o_orderkey"])
    agg = GroupAggregate(j, ["l_orderkey"],
                         [Aggregate("sum", _disc_price(), "revenue")],
                         carry=["o_orderdate", "o_shippriority"])
    srt = OrderBy(agg, [("revenue", True), ("o_orderdate", False)], limit=10)
    return Project(srt, {"l_orderkey": "l_orderkey", "revenue": "revenue",
                         "o_orderdate": "o_orderdate",
                         "o_shippriority": "o_shippriority"})


def q5():
    li = TableScan("lineitem", projection=[
        "l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"])
    orders = TableScan(
        "orders",
        filters=[col("o_orderdate") >= date_lit("1994-01-01"),
                 col("o_orderdate") < date_lit("1995-01-01")],
        projection=["o_orderkey", "o_custkey"])
    j1 = HashJoin(li, orders, ["l_orderkey"], ["o_orderkey"])
    cust = TableScan("customer", projection=["c_custkey", "c_nationkey"])
    j2 = HashJoin(j1, cust, ["o_custkey"], ["c_custkey"])
    supp = TableScan("supplier", projection=["s_suppkey", "s_nationkey"])
    j3 = HashJoin(j2, supp, ["l_suppkey"], ["s_suppkey"])
    f = Filter(j3, col("c_nationkey") == col("s_nationkey"))
    region = TableScan("region", filters=[col("r_name") == "ASIA"],
                       projection=["r_regionkey"])
    nation = TableScan("nation",
                       projection=["n_nationkey", "n_name", "n_regionkey"])
    nation_f = HashJoin(nation, region, ["n_regionkey"], ["r_regionkey"],
                        "semi")
    j4 = HashJoin(f, nation_f, ["s_nationkey"], ["n_nationkey"])
    agg = GroupAggregate(j4, ["n_name"],
                         [Aggregate("sum", _disc_price(), "revenue")])
    srt = OrderBy(agg, [("revenue", True)])
    return Project(srt, {"n_name": "n_name", "revenue": "revenue"})


def q10():
    li = TableScan("lineitem", filters=[col("l_returnflag") == "R"],
                   projection=["l_orderkey", "l_extendedprice", "l_discount"])
    orders = TableScan(
        "orders",
        filters=[col("o_orderdate") >= date_lit("1993-10-01"),
                 col("o_orderdate") < date_lit("1994-01-01")],
        projection=["o_orderkey", "o_custkey"])
    j1 = HashJoin(li, orders, ["l_orderkey"], ["o_orderkey"])
    cust = TableScan("customer", projection=[
        "c_custkey", "c_name", "c_acctbal", "c_address", "c_phone",
        "c_comment", "c_nationkey"])
    j2 = HashJoin(j1, cust, ["o_custkey"], ["c_custkey"])
    nation = TableScan("nation", projection=["n_nationkey", "n_name"])
    j3 = HashJoin(j2, nation, ["c_nationkey"], ["n_nationkey"])
    agg = GroupAggregate(
        j3, ["c_custkey"], [Aggregate("sum", _disc_price(), "revenue")],
        carry=["c_name", "c_acctbal", "c_phone", "n_name", "c_address",
               "c_comment"])
    srt = OrderBy(agg, [("revenue", True), ("c_custkey", False)], limit=20)
    return Project(srt, {
        "c_custkey": "c_custkey", "c_name": "c_name", "revenue": "revenue",
        "c_acctbal": "c_acctbal", "n_name": "n_name",
        "c_address": "c_address", "c_phone": "c_phone",
        "c_comment": "c_comment"})


def q12():
    li = TableScan(
        "lineitem",
        filters=[
            col("l_shipmode").isin(["MAIL", "SHIP"]),
            col("l_commitdate") < col("l_receiptdate"),
            col("l_shipdate") < col("l_commitdate"),
            col("l_receiptdate") >= date_lit("1994-01-01"),
            col("l_receiptdate") < date_lit("1995-01-01"),
        ],
        projection=["l_orderkey", "l_shipmode"])
    orders = TableScan("orders", projection=["o_orderkey", "o_orderpriority"])
    j = HashJoin(li, orders, ["l_orderkey"], ["o_orderkey"])
    high = Case(col("o_orderpriority").isin(["1-URGENT", "2-HIGH"]),
                Lit(1), Lit(0))
    low = Case(col("o_orderpriority").isin(["1-URGENT", "2-HIGH"]),
               Lit(0), Lit(1))
    agg = GroupAggregate(j, ["l_shipmode"], [
        Aggregate("sum", high, "high_line_count"),
        Aggregate("sum", low, "low_line_count")])
    srt = OrderBy(agg, [("l_shipmode", False)])
    return Project(srt, {"l_shipmode": "l_shipmode",
                         "high_line_count": "high_line_count",
                         "low_line_count": "low_line_count"})


def q14():
    li = TableScan(
        "lineitem",
        filters=[col("l_shipdate") >= date_lit("1995-09-01"),
                 col("l_shipdate") < date_lit("1995-10-01")],
        projection=["l_partkey", "l_extendedprice", "l_discount"])
    part = TableScan("part", projection=["p_partkey", "p_type"])
    j = HashJoin(li, part, ["l_partkey"], ["p_partkey"])
    promo = Case(col("p_type").like("PROMO%"), _disc_price(), dec_lit(0, 4))
    agg = GroupAggregate(j, [], [
        Aggregate("sum", promo, "promo"),
        Aggregate("sum", _disc_price(), "total")])
    return Project(agg, {
        "promo_revenue": (dec_lit("100.00") * col("promo")).cast_double()
        / col("total")})


def q19():
    li = TableScan("lineitem", projection=[
        "l_partkey", "l_quantity", "l_extendedprice", "l_discount",
        "l_shipinstruct", "l_shipmode"])
    part = TableScan("part", projection=[
        "p_partkey", "p_brand", "p_container", "p_size"])
    j = HashJoin(li, part, ["l_partkey"], ["p_partkey"])

    def clause(brand, containers, qlo, qhi, smax):
        return ((col("p_brand") == brand)
                & col("p_container").isin(containers)
                & (col("l_quantity") >= dec_lit(qlo))
                & (col("l_quantity") <= dec_lit(qhi))
                & col("p_size").between(Lit(1), Lit(smax))
                & col("l_shipmode").isin(["AIR", "AIR REG"])
                & (col("l_shipinstruct") == "DELIVER IN PERSON"))

    f = Filter(j, clause("Brand#12", ["SM CASE", "SM BOX", "SM PACK",
                                      "SM PKG"], 1, 11, 5)
               | clause("Brand#23", ["MED BAG", "MED BOX", "MED PKG",
                                     "MED PACK"], 10, 20, 10)
               | clause("Brand#34", ["LG CASE", "LG BOX", "LG PACK",
                                     "LG PKG"], 20, 30, 15))
    agg = GroupAggregate(f, [], [Aggregate("sum", _disc_price(), "revenue")])
    return Project(agg, {"revenue": "revenue"})


def q2():
    region_f = TableScan("region", filters=[col("r_name") == "EUROPE"],
                         projection=["r_regionkey"])
    nation = TableScan("nation", projection=["n_nationkey", "n_name",
                                             "n_regionkey"])
    nation_eu = HashJoin(nation, region_f, ["n_regionkey"], ["r_regionkey"],
                         "semi")
    supp = TableScan("supplier")
    supp_eu = HashJoin(supp, nation_eu, ["s_nationkey"], ["n_nationkey"],
                       "semi")
    ps = TableScan("partsupp",
                   projection=["ps_partkey", "ps_suppkey", "ps_supplycost"])
    ps_eu = HashJoin(ps, supp_eu, ["ps_suppkey"], ["s_suppkey"], "semi")
    agg_min = GroupAggregate(
        ps_eu, ["ps_partkey"],
        [Aggregate("min", col("ps_supplycost"), "min_cost")])
    part_f = TableScan("part",
                       filters=[col("p_size") == 15,
                                col("p_type").like("%BRASS")],
                       projection=["p_partkey", "p_mfgr"])
    ps2 = HashJoin(ps_eu, part_f, ["ps_partkey"], ["p_partkey"])
    j_min = HashJoin(ps2, agg_min, ["ps_partkey"], ["ps_partkey"],
                     build_prefix="m_")
    f = Filter(j_min, col("ps_supplycost") == col("m_min_cost"))
    j_s = HashJoin(f, supp_eu, ["ps_suppkey"], ["s_suppkey"])
    j_n = HashJoin(j_s, nation_eu, ["s_nationkey"], ["n_nationkey"])
    srt = OrderBy(j_n, [("s_acctbal", True), ("n_name", False),
                        ("s_name", False), ("p_partkey", False)], limit=100)
    return Project(srt, {c: c for c in [
        "s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr", "s_address",
        "s_phone", "s_comment"]})


def q4():
    li = TableScan("lineitem",
                   filters=[col("l_commitdate") < col("l_receiptdate")],
                   projection=["l_orderkey"])
    orders = TableScan(
        "orders",
        filters=[col("o_orderdate") >= date_lit("1993-07-01"),
                 col("o_orderdate") < date_lit("1993-10-01")],
        projection=["o_orderkey", "o_orderpriority"])
    sj = HashJoin(orders, li, ["o_orderkey"], ["l_orderkey"], "semi")
    agg = GroupAggregate(sj, ["o_orderpriority"],
                         [Aggregate("count", None, "order_count")])
    srt = OrderBy(agg, [("o_orderpriority", False)])
    return Project(srt, {"o_orderpriority": "o_orderpriority",
                         "order_count": "order_count"})


def q7():
    li = TableScan(
        "lineitem",
        filters=[col("l_shipdate") >= date_lit("1995-01-01"),
                 col("l_shipdate") <= date_lit("1996-12-31")],
        projection=["l_orderkey", "l_suppkey", "l_shipdate",
                    "l_extendedprice", "l_discount"])
    supp = TableScan("supplier", projection=["s_suppkey", "s_nationkey"])
    j1 = HashJoin(li, supp, ["l_suppkey"], ["s_suppkey"])
    orders = TableScan("orders", projection=["o_orderkey", "o_custkey"])
    j2 = HashJoin(j1, orders, ["l_orderkey"], ["o_orderkey"])
    cust = TableScan("customer", projection=["c_custkey", "c_nationkey"])
    j3 = HashJoin(j2, cust, ["o_custkey"], ["c_custkey"])
    nation = TableScan("nation", projection=["n_nationkey", "n_name"])
    j4 = HashJoin(j3, nation, ["s_nationkey"], ["n_nationkey"],
                  build_prefix="n1_")
    j5 = HashJoin(j4, nation, ["c_nationkey"], ["n_nationkey"],
                  build_prefix="n2_")
    f = Filter(j5, ((col("n1_n_name") == "FRANCE")
                    & (col("n2_n_name") == "GERMANY"))
               | ((col("n1_n_name") == "GERMANY")
                  & (col("n2_n_name") == "FRANCE")))
    proj = Project(f, {"supp_nation": "n1_n_name", "cust_nation": "n2_n_name",
                       "l_year": col("l_shipdate").year(),
                       "volume": _disc_price()})
    agg = GroupAggregate(proj, ["supp_nation", "cust_nation", "l_year"],
                         [Aggregate("sum", Col("volume"), "revenue")])
    srt = OrderBy(agg, [("supp_nation", False), ("cust_nation", False),
                        ("l_year", False)])
    return Project(srt, {c: c for c in [
        "supp_nation", "cust_nation", "l_year", "revenue"]})


def q8():
    part_f = TableScan("part",
                       filters=[col("p_type") == "ECONOMY ANODIZED STEEL"],
                       projection=["p_partkey"])
    li = TableScan("lineitem", projection=[
        "l_partkey", "l_orderkey", "l_suppkey", "l_extendedprice",
        "l_discount"])
    j0 = HashJoin(li, part_f, ["l_partkey"], ["p_partkey"])
    orders = TableScan(
        "orders",
        filters=[col("o_orderdate") >= date_lit("1995-01-01"),
                 col("o_orderdate") <= date_lit("1996-12-31")],
        projection=["o_orderkey", "o_custkey", "o_orderdate"])
    j1 = HashJoin(j0, orders, ["l_orderkey"], ["o_orderkey"])
    region_f = TableScan("region", filters=[col("r_name") == "AMERICA"],
                         projection=["r_regionkey"])
    nation = TableScan("nation", projection=["n_nationkey", "n_name",
                                             "n_regionkey"])
    nation_am = HashJoin(nation, region_f, ["n_regionkey"], ["r_regionkey"],
                         "semi")
    cust = TableScan("customer", projection=["c_custkey", "c_nationkey"])
    cust_am = HashJoin(cust, nation_am, ["c_nationkey"], ["n_nationkey"],
                       "semi")
    j2 = HashJoin(j1, cust_am, ["o_custkey"], ["c_custkey"], "semi")
    supp = TableScan("supplier", projection=["s_suppkey", "s_nationkey"])
    j3 = HashJoin(j2, supp, ["l_suppkey"], ["s_suppkey"])
    j4 = HashJoin(j3, nation, ["s_nationkey"], ["n_nationkey"],
                  build_prefix="n2_")
    proj = Project(j4, {
        "o_year": col("o_orderdate").year(),
        "volume": _disc_price(),
        "brazil": Case(col("n2_n_name") == "BRAZIL", _disc_price(),
                       dec_lit(0, 4))})
    agg = GroupAggregate(proj, ["o_year"], [
        Aggregate("sum", Col("brazil"), "br"),
        Aggregate("sum", Col("volume"), "vol")])
    srt = OrderBy(agg, [("o_year", False)])
    return Project(srt, {"o_year": "o_year",
                         "mkt_share": Col("br").cast_double() / Col("vol")})


def q9():
    part_f = TableScan("part", filters=[col("p_name").like("%green%")],
                       projection=["p_partkey"])
    li = TableScan("lineitem", projection=[
        "l_partkey", "l_suppkey", "l_orderkey", "l_quantity",
        "l_extendedprice", "l_discount"])
    j0 = HashJoin(li, part_f, ["l_partkey"], ["p_partkey"])
    supp = TableScan("supplier", projection=["s_suppkey", "s_nationkey"])
    j1 = HashJoin(j0, supp, ["l_suppkey"], ["s_suppkey"])
    ps = TableScan("partsupp",
                   projection=["ps_partkey", "ps_suppkey", "ps_supplycost"])
    j2 = HashJoin(j1, ps, ["l_suppkey", "l_partkey"],
                  ["ps_suppkey", "ps_partkey"])
    orders = TableScan("orders", projection=["o_orderkey", "o_orderdate"])
    j3 = HashJoin(j2, orders, ["l_orderkey"], ["o_orderkey"])
    nation = TableScan("nation", projection=["n_nationkey", "n_name"])
    j4 = HashJoin(j3, nation, ["s_nationkey"], ["n_nationkey"])
    proj = Project(j4, {
        "nation": "n_name",
        "o_year": col("o_orderdate").year(),
        "amount": _disc_price() - col("ps_supplycost") * col("l_quantity")})
    agg = GroupAggregate(proj, ["nation", "o_year"],
                         [Aggregate("sum", Col("amount"), "sum_profit")])
    srt = OrderBy(agg, [("nation", False), ("o_year", True)])
    return Project(srt, {c: c for c in ["nation", "o_year", "sum_profit"]})


@multi_phase
def q11(ex):
    from ..exec import result as R

    def base():
        nation_f = TableScan("nation", filters=[col("n_name") == "GERMANY"],
                             projection=["n_nationkey"])
        supp_de = HashJoin(TableScan("supplier",
                                     projection=["s_suppkey", "s_nationkey"]),
                           nation_f, ["s_nationkey"], ["n_nationkey"], "semi")
        ps = TableScan("partsupp", projection=[
            "ps_partkey", "ps_suppkey", "ps_supplycost", "ps_availqty"])
        return HashJoin(ps, supp_de, ["ps_suppkey"], ["s_suppkey"], "semi")

    value = col("ps_supplycost") * col("ps_availqty")
    total_rel = ex.execute(GroupAggregate(
        base(), [], [Aggregate("sum", value, "total")]))
    total_cents = int(total_rel.columns["total"].array[0])
    threshold = (total_cents / 100.0) * 0.0001
    agg = GroupAggregate(base(), ["ps_partkey"],
                         [Aggregate("sum", value, "value")])
    f = Filter(agg, Col("value").cast_double() > Lit(threshold))
    srt = OrderBy(f, [("value", True)])
    return ex.execute(Project(srt, {"ps_partkey": "ps_partkey",
                                    "value": "value"}))


def q13():
    orders = TableScan(
        "orders",
        filters=[col("o_comment").not_like("%special%requests%")],
        projection=["o_custkey"])
    agg1 = GroupAggregate(orders, ["o_custkey"],
                          [Aggregate("count", None, "cnt")])
    cust = TableScan("customer", projection=["c_custkey"])
    j = HashJoin(cust, agg1, ["c_custkey"], ["o_custkey"], "left",
                 found_column="__join_found__")
    proj = Project(j, {
        "c_count": Case(Col("__join_found__"), Col("cnt"), Lit(0))})
    agg2 = GroupAggregate(proj, ["c_count"],
                          [Aggregate("count", None, "custdist")])
    srt = OrderBy(agg2, [("custdist", True), ("c_count", True)])
    return Project(srt, {"c_count": "c_count", "custdist": "custdist"})


@multi_phase
def q15(ex):
    def revenue_view():
        li = TableScan(
            "lineitem",
            filters=[col("l_shipdate") >= date_lit("1996-01-01"),
                     col("l_shipdate") < date_lit("1996-04-01")],
            projection=["l_suppkey", "l_extendedprice", "l_discount"])
        return GroupAggregate(li, ["l_suppkey"],
                              [Aggregate("sum", _disc_price(),
                                         "total_revenue")])

    rel = ex.execute(revenue_view())
    vals = rel.columns["total_revenue"].array.cpu().numpy()
    mask = rel.mask.cpu().numpy()
    max_rev = int(vals[mask].max())
    f = Filter(revenue_view(),
               Col("total_revenue") == Lit(max_rev, _DEC4))
    supp = TableScan("supplier", projection=[
        "s_suppkey", "s_name", "s_address", "s_phone"])
    j = HashJoin(supp, f, ["s_suppkey"], ["l_suppkey"])
    srt = OrderBy(j, [("s_suppkey", False)])
    return ex.execute(Project(srt, {c: c for c in [
        "s_suppkey", "s_name", "s_address", "s_phone", "total_revenue"]}))


def q16():
    supp_bad = TableScan(
        "supplier",
        filters=[col("s_comment").like("%Customer%Complaints%")],
        projection=["s_suppkey"])
    part_f = TableScan(
        "part",
        filters=[col("p_brand") != "Brand#45",
                 col("p_type").not_like("MEDIUM POLISHED%"),
                 col("p_size").isin([49, 14, 23, 45, 19, 3, 36, 9])],
        projection=["p_partkey", "p_brand", "p_type", "p_size"])
    ps = TableScan("partsupp", projection=["ps_partkey", "ps_suppkey"])
    j = HashJoin(ps, part_f, ["ps_partkey"], ["p_partkey"])
    j2 = HashJoin(j, supp_bad, ["ps_suppkey"], ["s_suppkey"], "anti")
    dedup = GroupAggregate(j2, ["p_brand", "p_type", "p_size", "ps_suppkey"],
                           [])
    agg = GroupAggregate(dedup, ["p_brand", "p_type", "p_size"],
                         [Aggregate("count", None, "supplier_cnt")])
    srt = OrderBy(agg, [("supplier_cnt", True), ("p_brand", False),
                        ("p_type", False), ("p_size", False)])
    return Project(srt, {c: c for c in ["p_brand", "p_type", "p_size",
                                        "supplier_cnt"]})


def q17():
    part_f = TableScan("part",
                       filters=[col("p_brand") == "Brand#23",
                                col("p_container") == "MED BOX"],
                       projection=["p_partkey"])
    li = TableScan("lineitem",
                   projection=["l_partkey", "l_quantity", "l_extendedprice"])
    j = HashJoin(li, part_f, ["l_partkey"], ["p_partkey"])
    agg1 = GroupAggregate(j, ["l_partkey"], [
        Aggregate("sum", col("l_quantity"), "sq"),
        Aggregate("count", None, "cq")])
    j2 = HashJoin(j, agg1, ["l_partkey"], ["l_partkey"], build_prefix="a_")
    f = Filter(j2, (col("l_quantity") * Lit(5) * Col("a_cq")) < Col("a_sq"))
    agg2 = GroupAggregate(f, [], [
        Aggregate("sum", col("l_extendedprice"), "s")])
    return Project(agg2, {"avg_yearly": Col("s").cast_double() / Lit(7.0)})


def q18():
    li = TableScan("lineitem", projection=["l_orderkey", "l_quantity"])
    agg1 = GroupAggregate(li, ["l_orderkey"],
                          [Aggregate("sum", col("l_quantity"), "sum")])
    f = Filter(agg1, Col("sum") > dec_lit(300))
    orders = TableScan("orders", projection=[
        "o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"])
    j1 = HashJoin(f, orders, ["l_orderkey"], ["o_orderkey"])
    cust = TableScan("customer", projection=["c_custkey", "c_name"])
    j2 = HashJoin(j1, cust, ["o_custkey"], ["c_custkey"])
    srt = OrderBy(j2, [("o_totalprice", True), ("o_orderdate", False)],
                  limit=100)
    return Project(srt, {"c_name": "c_name", "c_custkey": "c_custkey",
                         "o_orderkey": "l_orderkey",
                         "o_orderdate": "o_orderdate",
                         "o_totalprice": "o_totalprice", "sum": "sum"})


def q20():
    part_f = TableScan("part", filters=[col("p_name").like("forest%")],
                       projection=["p_partkey"])
    ps = TableScan("partsupp",
                   projection=["ps_partkey", "ps_suppkey", "ps_availqty"])
    ps_f = HashJoin(ps, part_f, ["ps_partkey"], ["p_partkey"], "semi")
    li94 = TableScan(
        "lineitem",
        filters=[col("l_shipdate") >= date_lit("1994-01-01"),
                 col("l_shipdate") < date_lit("1995-01-01")],
        projection=["l_partkey", "l_suppkey", "l_quantity"])
    agg = GroupAggregate(li94, ["l_partkey", "l_suppkey"],
                         [Aggregate("sum", col("l_quantity"), "sq")])
    j = HashJoin(ps_f, agg, ["ps_partkey", "ps_suppkey"],
                 ["l_partkey", "l_suppkey"], "left",
                 found_column="__join_found__")
    f = Filter(j, Col("__join_found__")
               & ((col("ps_availqty") * Lit(200)) > Col("sq")))
    nation_f = TableScan("nation", filters=[col("n_name") == "CANADA"],
                         projection=["n_nationkey"])
    supp = TableScan("supplier",
                     projection=["s_suppkey", "s_name", "s_address",
                                 "s_nationkey"])
    supp_ca = HashJoin(supp, nation_f, ["s_nationkey"], ["n_nationkey"],
                       "semi")
    supp_ok = HashJoin(supp_ca, f, ["s_suppkey"], ["ps_suppkey"], "semi")
    srt = OrderBy(supp_ok, [("s_name", False)])
    return Project(srt, {"s_name": "s_name", "s_address": "s_address"})


def q21():
    li_late = TableScan(
        "lineitem",
        filters=[col("l_receiptdate") > col("l_commitdate")],
        projection=["l_orderkey", "l_suppkey"])
    li_all = TableScan("lineitem", projection=["l_orderkey", "l_suppkey"])
    dedup_all = GroupAggregate(li_all, ["l_orderkey", "l_suppkey"], [])
    cnt_all = GroupAggregate(dedup_all, ["l_orderkey"],
                             [Aggregate("count", None, "n_supp")])
    dedup_late = GroupAggregate(li_late, ["l_orderkey", "l_suppkey"], [])
    cnt_late = GroupAggregate(dedup_late, ["l_orderkey"],
                              [Aggregate("count", None, "n_late")])
    orders_f = TableScan("orders", filters=[col("o_orderstatus") == "F"],
                         projection=["o_orderkey"])
    j1 = HashJoin(li_late, orders_f, ["l_orderkey"], ["o_orderkey"], "semi")
    supp = TableScan("supplier",
                     projection=["s_suppkey", "s_name", "s_nationkey"])
    j2 = HashJoin(j1, supp, ["l_suppkey"], ["s_suppkey"])
    nation_f = TableScan("nation",
                         filters=[col("n_name") == "SAUDI ARABIA"],
                         projection=["n_nationkey"])
    j3 = HashJoin(j2, nation_f, ["s_nationkey"], ["n_nationkey"], "semi")
    j4 = HashJoin(j3, cnt_all, ["l_orderkey"], ["l_orderkey"],
                  build_prefix="a_")
    j5 = HashJoin(j4, cnt_late, ["l_orderkey"], ["l_orderkey"],
                  build_prefix="b_")
    f = Filter(j5, (Col("a_n_supp") >= Lit(2)) & (Col("b_n_late") == Lit(1)))
    agg = GroupAggregate(f, ["s_name"],
                         [Aggregate("count", None, "numwait")])
    srt = OrderBy(agg, [("numwait", True), ("s_name", False)], limit=100)
    return Project(srt, {"s_name": "s_name", "numwait": "numwait"})


@multi_phase
def q22(ex):
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    cntry = Substr(Col("c_phone"), 1, 2)
    base_f = [cntry.isin(codes)]
    avg_rel = ex.execute(GroupAggregate(
        TableScan("customer",
                  filters=base_f + [col("c_acctbal") > dec_lit("0.00")],
                  projection=["c_acctbal", "c_phone"]),
        [], [Aggregate("sum", col("c_acctbal"), "s"),
             Aggregate("count", None, "c")]))
    s = int(avg_rel.columns["s"].array[0])
    c = int(avg_rel.columns["c"].array[0])
    avg_bal = (s / 100.0) / c
    cust = TableScan(
        "customer",
        filters=base_f + [col("c_acctbal").cast_double() > Lit(avg_bal)],
        projection=["c_custkey", "c_acctbal", "c_phone"])
    orders = TableScan("orders", projection=["o_custkey"])
    no_orders = HashJoin(cust, orders, ["c_custkey"], ["o_custkey"], "anti")
    proj = Project(no_orders, {"cntrycode": cntry,
                               "c_acctbal": "c_acctbal"})
    agg = GroupAggregate(proj, ["cntrycode"], [
        Aggregate("count", None, "numcust"),
        Aggregate("sum", col("c_acctbal"), "totacctbal")])
    srt = OrderBy(agg, [("cntrycode", False)])
    return ex.execute(Project(srt, {c2: c2 for c2 in [
        "cntrycode", "numcust", "totacctbal"]}))


from ..types import DataType as _DataType, TypeId as _TypeId

_DEC4 = _DataType(_TypeId.DECIMAL, 4)

QUERIES = {1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9,
           10: q10, 11: q11, 12: q12, 13: q13, 14: q14, 15: q15, 16: q16,
           17: q17, 18: q18, 19: q19, 20: q20, 21: q21, 22: q22}


def run(ex, n: int):
    """Execute TPC-H query n and return the result Relation."""
    builder = QUERIES[n]
    if getattr(builder, "multi_phase", False):
        return builder(ex)
    return ex.execute(builder())


def get_query(n: int):
    if n not in QUERIES:
        raise NotImplementedError(f"TPC-H Q{n} not implemented yet")
    return QUERIES[n]()
