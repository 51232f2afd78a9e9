"""The benchmark's own TPC-H data, independent of the engine under test.

A ctypes driver over `native/tpch_dbgen.cpp`, the benchmark's frozen copy of
the engine's columnar generator, built with g++ into `_build/`.  Money
columns are int64 cents, dates int32 days since 1970-01-01, strings
zero-padded fixed-width bytes, CHAR(1) columns uint8.

`base_tables(sf)` is the initial population, cached column by column as
`.npy` files in `_cache/sf<sf>/` (written once per checkout, read back with
memory maps).  `update_set(sf, u)` and `delete_keys(sf, u)` are TPC-H update
set `u` (clause 4.2.3): SF x 1,500 new orders with their lineitems, keyed
from the sparse key space the base population leaves unused (dbgen's keys
with sequence number 1), and the keys of SF x 1,500 old orders.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(HERE, "_build")
CACHE_DIR = os.path.join(HERE, "_cache")
SRC = os.path.join(HERE, "native", "tpch_dbgen.cpp")
DISTS = os.path.join(HERE, "native", "dists.json")
LIB = os.path.join(BUILD_DIR, "libtpchbench_dbgen.so")

TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem")

i64 = ctypes.c_longlong

ORDER_STR = {"o_orderpriority": 16, "o_clerk": 16, "o_comment": 80}
LINE_STR = {"l_shipinstruct": 26, "l_shipmode": 12, "l_comment": 44}
ORDER_COLS = (("o_orderkey", np.int64), ("o_custkey", np.int64),
              ("o_orderstatus", np.uint8), ("o_totalprice", np.int64),
              ("o_orderdate", np.int32), ("o_orderpriority", None),
              ("o_clerk", None), ("o_shippriority", np.int32),
              ("o_comment", None))
LINE_COLS = (("l_orderkey", np.int64), ("l_partkey", np.int64),
             ("l_suppkey", np.int64), ("l_linenumber", np.int64),
             ("l_quantity", np.int64), ("l_extendedprice", np.int64),
             ("l_discount", np.int64), ("l_tax", np.int64),
             ("l_returnflag", np.uint8), ("l_linestatus", np.uint8),
             ("l_shipdate", np.int32), ("l_commitdate", np.int32),
             ("l_receiptdate", np.int32), ("l_shipinstruct", None),
             ("l_shipmode", None), ("l_comment", None))


class _Gen:
    """The built library with the distributions loaded, at one scale."""

    def __init__(self, sf: float):
        if (not os.path.exists(LIB)
                or os.path.getmtime(LIB) < os.path.getmtime(SRC)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp,
                                SRC], check=True)
                os.replace(tmp, LIB)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(LIB)
        lib.tpg_init.restype = ctypes.c_int
        lib.tpg_init.argtypes = [ctypes.c_double]
        lib.tpg_rows.restype = i64
        lib.tpg_rows.argtypes = [ctypes.c_int]
        lib.tpg_gen_orders_lineitem.restype = i64
        lib.tpg_set_order_keys.restype = None
        lib.tpg_set_order_keys.argtypes = [i64, i64]
        with open(DISTS) as f:
            dists = json.load(f)
        for name, entries in dists.items():
            texts = [t.encode("latin-1") for t, _ in entries]
            weights = np.array([w for _, w in entries], dtype=np.int64)
            offsets = np.zeros(len(texts) + 1, dtype=np.int32)
            np.cumsum([len(t) for t in texts], out=offsets[1:])
            lib.tpg_load_dist(
                name.encode(), len(texts), b"".join(texts),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                weights.ctypes.data_as(ctypes.POINTER(i64)))
        if lib.tpg_init(ctypes.c_double(sf)) != 0:
            raise RuntimeError("tpg_init: a distribution is missing")
        self.lib = lib

    def rows(self, table_id: int) -> int:
        return int(self.lib.tpg_rows(table_id))

    def call(self, fn: str, *args):
        conv = [a.ctypes.data_as(ctypes.c_void_p) if isinstance(a, np.ndarray)
                else i64(a) for a in args]
        return getattr(self.lib, fn)(*conv)


def _cols(spec, n, widths):
    return {name: (np.zeros(n, dtype=dt) if dt is not None
                   else np.zeros(n, dtype=f"S{widths[name]}"))
            for name, dt in spec}


def _orders_lineitem(gen: _Gen, start: int, count: int, key_start: int = -1,
                     seq: int = 0):
    orders = _cols(ORDER_COLS, count, ORDER_STR)
    lines = _cols(LINE_COLS, count * 7, LINE_STR)
    gen.lib.tpg_set_order_keys(i64(key_start), i64(seq))
    try:
        n = gen.call("tpg_gen_orders_lineitem", start, count,
                     *orders.values(), *lines.values())
    finally:
        gen.lib.tpg_set_order_keys(i64(-1), i64(0))
    return orders, {k: v[:n] for k, v in lines.items()}


def generate(sf: float) -> dict:
    """Every table at `sf`: {table: {column: array}}."""
    g = _Gen(sf)
    out = {}
    n = g.rows(9)
    out["region"] = {"r_regionkey": np.zeros(n, np.int32),
                     "r_name": np.zeros(n, "S26"),
                     "r_comment": np.zeros(n, "S116")}
    g.call("tpg_gen_region", *out["region"].values())
    n = g.rows(8)
    out["nation"] = {"n_nationkey": np.zeros(n, np.int32),
                     "n_name": np.zeros(n, "S26"),
                     "n_regionkey": np.zeros(n, np.int32),
                     "n_comment": np.zeros(n, "S116")}
    g.call("tpg_gen_nation", *out["nation"].values())
    n = g.rows(2)
    out["supplier"] = {
        "s_suppkey": np.zeros(n, np.int64), "s_name": np.zeros(n, "S26"),
        "s_address": np.zeros(n, "S40"), "s_nationkey": np.zeros(n, np.int32),
        "s_phone": np.zeros(n, "S16"), "s_acctbal": np.zeros(n, np.int64),
        "s_comment": np.zeros(n, "S104")}
    g.call("tpg_gen_supplier", 0, n, *out["supplier"].values())
    n = g.rows(3)
    out["customer"] = {
        "c_custkey": np.zeros(n, np.int64), "c_name": np.zeros(n, "S26"),
        "c_address": np.zeros(n, "S40"), "c_nationkey": np.zeros(n, np.int32),
        "c_phone": np.zeros(n, "S16"), "c_acctbal": np.zeros(n, np.int64),
        "c_mktsegment": np.zeros(n, "S12"), "c_comment": np.zeros(n, "S120")}
    g.call("tpg_gen_customer", 0, n, *out["customer"].values())
    n = g.rows(0)
    out["part"] = {
        "p_partkey": np.zeros(n, np.int64), "p_name": np.zeros(n, "S56"),
        "p_mfgr": np.zeros(n, "S26"), "p_brand": np.zeros(n, "S12"),
        "p_type": np.zeros(n, "S26"), "p_size": np.zeros(n, np.int32),
        "p_container": np.zeros(n, "S12"),
        "p_retailprice": np.zeros(n, np.int64),
        "p_comment": np.zeros(n, "S24")}
    out["partsupp"] = {
        "ps_partkey": np.zeros(4 * n, np.int64),
        "ps_suppkey": np.zeros(4 * n, np.int64),
        "ps_availqty": np.zeros(4 * n, np.int64),
        "ps_supplycost": np.zeros(4 * n, np.int64),
        "ps_comment": np.zeros(4 * n, "S200")}
    g.call("tpg_gen_part_psupp", 0, n, *out["part"].values(),
           *out["partsupp"].values())
    out["orders"], out["lineitem"] = _orders_lineitem(g, 0, g.rows(4))
    return out


def _sf_dir(sf: float) -> str:
    return os.path.join(CACHE_DIR, f"sf{sf:g}")


def base_tables(sf: float) -> dict:
    """The initial population at `sf`, from the cache (memory-mapped,
    read-only), generated and written there on first use."""
    d = _sf_dir(sf)
    done = os.path.join(d, "complete")
    if not os.path.exists(done):
        tables = generate(sf)
        os.makedirs(d, exist_ok=True)
        for t, cols in tables.items():
            for c, a in cols.items():
                fd, tmp = tempfile.mkstemp(suffix=".npy", dir=d)
                with os.fdopen(fd, "wb") as f:
                    np.save(f, a)
                os.replace(tmp, os.path.join(d, f"{t}.{c}.npy"))
        with open(done, "w") as f:
            f.write("\n".join(f"{t}.{c}" for t, cols in tables.items()
                              for c in cols))
    with open(done) as f:
        names = f.read().split()
    out: dict[str, dict] = {t: {} for t in TABLES}
    for name in names:
        t, c = name.split(".")
        out[t][c] = np.load(os.path.join(d, name + ".npy"), mmap_mode="r")
    return out


def set_size(sf: float) -> int:
    """Orders in one refresh function: SF x 1,500 (clause 2.5.2)."""
    return max(1, int(round(sf * 1500)))


def update_set(sf: float, u: int):
    """RF1's rows of update set `u` (1-based): (orders, lineitem).  Their
    contents continue the generator's streams past the base population;
    their keys are sparse keys with sequence number 1, which no base order
    has."""
    if u < 1:
        raise ValueError("update sets are numbered from 1")
    g = _Gen(sf)
    n = set_size(sf)
    return _orders_lineitem(g, g.rows(4) + (u - 1) * n, n,
                            key_start=(u - 1) * n, seq=1)


def delete_keys(sf: float, u: int) -> np.ndarray:
    """RF2's order keys of update set `u`: base orders (sequence number 0)
    with the indexes (u-1) x n + 1 .. u x n."""
    n = set_size(sf)
    idx = np.arange((u - 1) * n + 1, u * n + 1, dtype=np.int64)
    return (((idx >> 3) << 2) << 3) | (idx & 7)
