"""TPC-H's refresh functions as SQL text (clause 2.5).

RF1 inserts update set `u`'s new orders and their lineitems; RF2 deletes the
set's old orders and their lineitems.  Each is one transaction: BEGIN, the
statements, COMMIT, sent one by one through the connection's SQL entry.
The rows come from `datagen`; nothing here touches the engine.
"""

from __future__ import annotations

import datetime

from . import datagen

EPOCH = datetime.date(1970, 1, 1)


def _date(d: int) -> str:
    return "'" + (EPOCH + datetime.timedelta(days=int(d))).isoformat() + "'"


def _money(v: int) -> str:
    v = int(v)
    sign = "-" if v < 0 else ""
    ip, fp = divmod(abs(v), 100)
    return f"{sign}{ip}.{fp:02d}"


def _text(b: bytes) -> str:
    return "'" + b.decode("latin-1").replace("'", "''") + "'"


def _char(c: int) -> str:
    return "'" + chr(int(c)) + "'"


# column order of the tables, with each column's literal form
ORDERS = (("o_orderkey", str), ("o_custkey", str), ("o_orderstatus", _char),
          ("o_totalprice", _money), ("o_orderdate", _date),
          ("o_orderpriority", _text), ("o_clerk", _text),
          ("o_shippriority", str), ("o_comment", _text))
LINEITEM = (("l_orderkey", str), ("l_partkey", str), ("l_suppkey", str),
            ("l_linenumber", str), ("l_quantity", _money),
            ("l_extendedprice", _money), ("l_discount", _money),
            ("l_tax", _money), ("l_returnflag", _char),
            ("l_linestatus", _char), ("l_shipdate", _date),
            ("l_commitdate", _date), ("l_receiptdate", _date),
            ("l_shipinstruct", _text), ("l_shipmode", _text),
            ("l_comment", _text))


def _values(cols: dict, spec) -> str:
    lists = [[f(v) for v in cols[name].tolist()] for name, f in spec]
    return ", ".join("(" + ", ".join(row) + ")" for row in zip(*lists))


def rf1(sf: float, u: int) -> list[str]:
    orders, lineitem = datagen.update_set(sf, u)
    return ["BEGIN",
            "INSERT INTO orders VALUES " + _values(orders, ORDERS),
            "INSERT INTO lineitem VALUES " + _values(lineitem, LINEITEM),
            "COMMIT"]


def rf2(sf: float, u: int) -> list[str]:
    keys = ", ".join(str(k) for k in datagen.delete_keys(sf, u).tolist())
    return ["BEGIN",
            f"DELETE FROM lineitem WHERE l_orderkey IN ({keys})",
            f"DELETE FROM orders WHERE o_orderkey IN ({keys})",
            "COMMIT"]

