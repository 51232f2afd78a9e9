"""TPC-H data generation: ctypes driver for the native columnar generator.

The native generator (``native/tpch_dbgen.cpp``) implements the TPC-H
specification with a columnar, offset-addressable API; this module builds it
with g++ into the port's git-ignored ``_build/`` directory, feeds it the spec
distribution data (``tpch/dists.json``, the port's byte-for-byte copy of the
reference package's) and returns each table as a dict of numpy columns.

Money columns are int64 *cents* (exact fixed-point, the engine's
DECIMAL(15,2) representation); dates int32 unix epoch days; strings
zero-padded fixed-width ``|S`` bytes columns.  Same generator and driver as
``duckdb_cubit_tpu/tpch/dbgen.py``, so both packages load identical rows.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_BUILD_DIR = os.path.join(_PKG, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libtpchgen.so")
_SRC_PATH = os.path.join(_ROOT, "native", "tpch_dbgen.cpp")
_DISTS_PATH = os.path.join(_PKG, "tpch", "dists.json")

_lock = threading.Lock()
_lib = None
_dists_loaded = False
_current_sf = None

i64 = ctypes.c_longlong


def _build_lib():
    """Compile into a temporary file and rename it into place, so concurrent
    processes never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp,
                        _SRC_PATH], check=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_LIB_PATH)) or (
        os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)
    ):
        _build_lib()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.tpg_init.restype = ctypes.c_int
    lib.tpg_init.argtypes = [ctypes.c_double]
    lib.tpg_rows.restype = i64
    lib.tpg_rows.argtypes = [ctypes.c_int]
    lib.tpg_gen_orders_lineitem.restype = i64
    _lib = lib
    return lib


def _load_dists(lib):
    global _dists_loaded
    if _dists_loaded:
        return
    with open(_DISTS_PATH) as f:
        dists = json.load(f)
    for name, entries in dists.items():
        texts = [t for t, _ in entries]
        weights = np.array([w for _, w in entries], dtype=np.int64)
        concat = "".join(texts).encode("latin-1")
        offsets = np.zeros(len(texts) + 1, dtype=np.int32)
        np.cumsum([len(t.encode("latin-1")) for t in texts], out=offsets[1:])
        lib.tpg_load_dist(
            name.encode(),
            len(texts),
            concat,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            weights.ctypes.data_as(ctypes.POINTER(i64)),
        )
    _dists_loaded = True


def _init(sf: float):
    global _current_sf
    lib = _get_lib()
    _load_dists(lib)
    if _current_sf != sf:
        rc = lib.tpg_init(ctypes.c_double(sf))
        if rc != 0:
            raise RuntimeError("tpg_init failed: missing distributions")
        _current_sf = sf
    return lib


def _p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _strcol(n: int, width: int) -> np.ndarray:
    return np.zeros(n, dtype=f"S{width}")


def gen_region(sf: float = 1.0) -> dict:
    lib = _init(sf)
    n = lib.tpg_rows(9)
    key = np.zeros(n, dtype=np.int32)
    name = _strcol(n, 26)
    comment = _strcol(n, 116)
    lib.tpg_gen_region(_p(key), _p(name), _p(comment))
    return {"r_regionkey": key, "r_name": name, "r_comment": comment}


def gen_nation(sf: float = 1.0) -> dict:
    lib = _init(sf)
    n = lib.tpg_rows(8)
    key = np.zeros(n, dtype=np.int32)
    name = _strcol(n, 26)
    region = np.zeros(n, dtype=np.int32)
    comment = _strcol(n, 116)
    lib.tpg_gen_nation(_p(key), _p(name), _p(region), _p(comment))
    return {
        "n_nationkey": key,
        "n_name": name,
        "n_regionkey": region,
        "n_comment": comment,
    }


def gen_supplier(sf: float = 1.0, start: int = 0, count: int | None = None) -> dict:
    lib = _init(sf)
    total = lib.tpg_rows(2)
    if count is None:
        count = total - start
    key = np.zeros(count, dtype=np.int64)
    name = _strcol(count, 26)
    address = _strcol(count, 40)
    nation = np.zeros(count, dtype=np.int32)
    phone = _strcol(count, 16)
    acctbal = np.zeros(count, dtype=np.int64)
    comment = _strcol(count, 104)
    lib.tpg_gen_supplier(
        i64(start), i64(count), _p(key), _p(name), _p(address), _p(nation),
        _p(phone), _p(acctbal), _p(comment),
    )
    return {
        "s_suppkey": key, "s_name": name, "s_address": address,
        "s_nationkey": nation, "s_phone": phone, "s_acctbal": acctbal,
        "s_comment": comment,
    }


def gen_customer(sf: float = 1.0, start: int = 0, count: int | None = None) -> dict:
    lib = _init(sf)
    total = lib.tpg_rows(3)
    if count is None:
        count = total - start
    key = np.zeros(count, dtype=np.int64)
    name = _strcol(count, 26)
    address = _strcol(count, 40)
    nation = np.zeros(count, dtype=np.int32)
    phone = _strcol(count, 16)
    acctbal = np.zeros(count, dtype=np.int64)
    mktsegment = _strcol(count, 12)
    comment = _strcol(count, 120)
    lib.tpg_gen_customer(
        i64(start), i64(count), _p(key), _p(name), _p(address), _p(nation),
        _p(phone), _p(acctbal), _p(mktsegment), _p(comment),
    )
    return {
        "c_custkey": key, "c_name": name, "c_address": address,
        "c_nationkey": nation, "c_phone": phone, "c_acctbal": acctbal,
        "c_mktsegment": mktsegment, "c_comment": comment,
    }


def gen_part_partsupp(
    sf: float = 1.0, start: int = 0, count: int | None = None
) -> tuple[dict, dict]:
    lib = _init(sf)
    total = lib.tpg_rows(0)
    if count is None:
        count = total - start
    p_key = np.zeros(count, dtype=np.int64)
    p_name = _strcol(count, 56)
    p_mfgr = _strcol(count, 26)
    p_brand = _strcol(count, 12)
    p_type = _strcol(count, 26)
    p_size = np.zeros(count, dtype=np.int32)
    p_container = _strcol(count, 12)
    p_retail = np.zeros(count, dtype=np.int64)
    p_comment = _strcol(count, 24)
    nps = count * 4
    ps_partkey = np.zeros(nps, dtype=np.int64)
    ps_suppkey = np.zeros(nps, dtype=np.int64)
    ps_availqty = np.zeros(nps, dtype=np.int64)
    ps_supplycost = np.zeros(nps, dtype=np.int64)
    ps_comment = _strcol(nps, 200)
    lib.tpg_gen_part_psupp(
        i64(start), i64(count), _p(p_key), _p(p_name), _p(p_mfgr), _p(p_brand),
        _p(p_type), _p(p_size), _p(p_container), _p(p_retail), _p(p_comment),
        _p(ps_partkey), _p(ps_suppkey), _p(ps_availqty), _p(ps_supplycost),
        _p(ps_comment),
    )
    part = {
        "p_partkey": p_key, "p_name": p_name, "p_mfgr": p_mfgr,
        "p_brand": p_brand, "p_type": p_type, "p_size": p_size,
        "p_container": p_container, "p_retailprice": p_retail,
        "p_comment": p_comment,
    }
    partsupp = {
        "ps_partkey": ps_partkey, "ps_suppkey": ps_suppkey,
        "ps_availqty": ps_availqty, "ps_supplycost": ps_supplycost,
        "ps_comment": ps_comment,
    }
    return part, partsupp


def gen_orders_lineitem(
    sf: float = 1.0, start: int = 0, count: int | None = None
) -> tuple[dict, dict]:
    lib = _init(sf)
    total = lib.tpg_rows(4)
    if count is None:
        count = total - start
    o_orderkey = np.zeros(count, dtype=np.int64)
    o_custkey = np.zeros(count, dtype=np.int64)
    o_orderstatus = np.zeros(count, dtype=np.uint8)
    o_totalprice = np.zeros(count, dtype=np.int64)
    o_orderdate = np.zeros(count, dtype=np.int32)
    o_orderpriority = _strcol(count, 16)
    o_clerk = _strcol(count, 16)
    o_shippriority = np.zeros(count, dtype=np.int32)
    o_comment = _strcol(count, 80)
    nl = count * 7
    l_orderkey = np.zeros(nl, dtype=np.int64)
    l_partkey = np.zeros(nl, dtype=np.int64)
    l_suppkey = np.zeros(nl, dtype=np.int64)
    l_linenumber = np.zeros(nl, dtype=np.int64)
    l_quantity = np.zeros(nl, dtype=np.int64)
    l_extendedprice = np.zeros(nl, dtype=np.int64)
    l_discount = np.zeros(nl, dtype=np.int64)
    l_tax = np.zeros(nl, dtype=np.int64)
    l_returnflag = np.zeros(nl, dtype=np.uint8)
    l_linestatus = np.zeros(nl, dtype=np.uint8)
    l_shipdate = np.zeros(nl, dtype=np.int32)
    l_commitdate = np.zeros(nl, dtype=np.int32)
    l_receiptdate = np.zeros(nl, dtype=np.int32)
    l_shipinstruct = _strcol(nl, 26)
    l_shipmode = _strcol(nl, 12)
    l_comment = _strcol(nl, 44)
    nlines = lib.tpg_gen_orders_lineitem(
        i64(start), i64(count),
        _p(o_orderkey), _p(o_custkey), _p(o_orderstatus), _p(o_totalprice),
        _p(o_orderdate), _p(o_orderpriority), _p(o_clerk), _p(o_shippriority),
        _p(o_comment),
        _p(l_orderkey), _p(l_partkey), _p(l_suppkey), _p(l_linenumber),
        _p(l_quantity), _p(l_extendedprice), _p(l_discount), _p(l_tax),
        _p(l_returnflag), _p(l_linestatus), _p(l_shipdate), _p(l_commitdate),
        _p(l_receiptdate), _p(l_shipinstruct), _p(l_shipmode), _p(l_comment),
    )
    orders = {
        "o_orderkey": o_orderkey, "o_custkey": o_custkey,
        "o_orderstatus": o_orderstatus, "o_totalprice": o_totalprice,
        "o_orderdate": o_orderdate, "o_orderpriority": o_orderpriority,
        "o_clerk": o_clerk, "o_shippriority": o_shippriority,
        "o_comment": o_comment,
    }
    lineitem = {
        "l_orderkey": l_orderkey[:nlines], "l_partkey": l_partkey[:nlines],
        "l_suppkey": l_suppkey[:nlines], "l_linenumber": l_linenumber[:nlines],
        "l_quantity": l_quantity[:nlines],
        "l_extendedprice": l_extendedprice[:nlines],
        "l_discount": l_discount[:nlines], "l_tax": l_tax[:nlines],
        "l_returnflag": l_returnflag[:nlines],
        "l_linestatus": l_linestatus[:nlines],
        "l_shipdate": l_shipdate[:nlines], "l_commitdate": l_commitdate[:nlines],
        "l_receiptdate": l_receiptdate[:nlines],
        "l_shipinstruct": l_shipinstruct[:nlines],
        "l_shipmode": l_shipmode[:nlines], "l_comment": l_comment[:nlines],
    }
    return orders, lineitem


def gen_all(sf: float = 1.0) -> dict:
    """Generate every TPC-H table at the given scale factor."""
    with _lock:
        part, partsupp = gen_part_partsupp(sf)
        orders, lineitem = gen_orders_lineitem(sf)
        out = {
            "region": gen_region(sf),
            "nation": gen_nation(sf),
            "supplier": gen_supplier(sf),
            "customer": gen_customer(sf),
            "part": part,
            "partsupp": partsupp,
            "orders": orders,
            "lineitem": lineitem,
        }
    return out
