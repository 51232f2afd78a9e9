"""TPC-H logical schema and default CUBIT index configuration.

Column types mirror the reference's table definitions (reference
extension/tpch/dbgen/dbgen.cpp:332-425: BIGINT keys, DECIMAL(15,2) money,
DATE dates, VARCHAR strings).
"""

from __future__ import annotations

import numpy as np

from ..types import DATE, DECIMAL, INT32, INT64, DataType, date_to_days

DEC2 = DECIMAL(2)

SCHEMA: dict[str, dict[str, DataType]] = {
    "region": {},
    "nation": {},
    "supplier": {"s_acctbal": DEC2},
    "customer": {"c_acctbal": DEC2},
    "part": {"p_retailprice": DEC2},
    "partsupp": {"ps_supplycost": DEC2},
    "orders": {"o_totalprice": DEC2, "o_orderdate": DATE},
    "lineitem": {
        "l_quantity": DEC2, "l_extendedprice": DEC2, "l_discount": DEC2,
        "l_tax": DEC2, "l_shipdate": DATE, "l_commitdate": DATE,
        "l_receiptdate": DATE,
    },
}


def month_edges(first_year: int = 1992, last_year: int = 1998) -> np.ndarray:
    """Epoch-day edges of every month start in the TPC-H date window."""
    edges = []
    for y in range(first_year, last_year + 1):
        for m in range(1, 13):
            edges.append(date_to_days(f"{y:04d}-{m:02d}-01"))
    edges.append(date_to_days(f"{last_year + 1:04d}-01-01"))
    return np.array(edges, dtype=np.int64)


# Primary-key columns with dense direct-address indexes (join accelerators,
# the analog of the reference's ART primary-key indexes)
PK_COLUMNS = {
    "region": "r_regionkey",
    "nation": "n_nationkey",
    "supplier": "s_suppkey",
    "customer": "c_custkey",
    "part": "p_partkey",
    "orders": "o_orderkey",
}

# Foreign keys (fk column -> pk table/column); names are globally unique in
# the TPC-H schema so the registry is keyed by column name
FOREIGN_KEYS = {
    "l_orderkey": ("orders", "o_orderkey"),
    "l_partkey": ("part", "p_partkey"),
    "l_suppkey": ("supplier", "s_suppkey"),
    "o_custkey": ("customer", "c_custkey"),
    "ps_partkey": ("part", "p_partkey"),
    "ps_suppkey": ("supplier", "s_suppkey"),
    "c_nationkey": ("nation", "n_nationkey"),
    "s_nationkey": ("nation", "n_nationkey"),
    "n_regionkey": ("region", "r_regionkey"),
    # self references (grouping by a table's own pk)
    "o_orderkey": ("orders", "o_orderkey"),
    "p_partkey": ("part", "p_partkey"),
    "s_suppkey": ("supplier", "s_suppkey"),
    "c_custkey": ("customer", "c_custkey"),
    "n_nationkey": ("nation", "n_nationkey"),
}

# Composite uniqueness constraints (TPC-H spec compound primary keys);
# consumed by the binder's single-match join decision
UNIQUE_KEYS = {
    "partsupp": [frozenset({"ps_partkey", "ps_suppkey"})],
    "lineitem": [frozenset({"l_orderkey", "l_linenumber"})],
}

# CUBIT indexes built at load: column -> (n_bins, bin_edges | None).
# Identity-binned low-cardinality columns index their raw device codes;
# edge-binned columns (dates, cents quantities) get exact answers whenever
# predicate endpoints land on edges, else boundary-bin refinement.
DEFAULT_INDEXES = {
    "lineitem": {
        "l_shipdate": ("edges", month_edges()[:-1]),
        "l_discount": ("identity", 11),
        "l_quantity": ("edges", np.arange(1, 51, dtype=np.int64) * 100),
        "l_returnflag": ("values", None),
        "l_shipmode": ("dict", None),
        "l_receiptdate": ("edges", month_edges()[:-1]),
    },
    "orders": {
        "o_orderdate": ("edges", month_edges()[:-1]),
        "o_orderpriority": ("dict", None),
    },
    "part": {
        "p_size": ("identity", 51),
        "p_brand": ("dict", None),
        "p_container": ("dict", None),
    },
    "customer": {
        "c_mktsegment": ("dict", None),
    },
}
