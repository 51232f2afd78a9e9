"""GPU smoke run of the PyTorch + CUDA port: TPC-H Q6, Q1, Q12 and Q3 through
the public API, all 22 TPC-H plan builders, the 22 TPC-H SQL texts, the
sqllogic files the port runs, window functions and range / ASOF joins over
the catalog, the reference's two kernel benchmarks, then DML under a
transaction, a checkpoint and a restart, on one device and on a mesh.

    python3 chip_smoke.py            # SF1 (6,001,215 lineitem rows)
    python3 chip_smoke.py --sf 10    # SF10

Needs one CUDA card, the CUDA toolkit (nvcc) and g++.  Phases, each of which
raises on failure (non-zero exit):

  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: all nine kernels from duckdb_cubit_tpu_torch/csrc/, one nvcc
     each, started together: K1 the fused scan-sum, K2 the monotone gather,
     K3 / K4 the Q6 word- and mask-sums with int32 halves, K5a the table
     gather, K5b the lane gather, K6 the dictionary LIKE matcher, K7 the
     stream compaction and K8 the key-to-row probe for unsorted keys;
  3. kernel parity: `pytest -m cuda` on the kernel test files
     (`KERNEL_TESTS`), whose `cuda` cases hold each kernel to its plain
     torch body on the card, bit for bit (ragged lengths, views off a 16-B
     boundary, bad keys and indices, every mask byte, the main path's
     shapes); the run fails when a case fails;
  4. main path: connect(sf, device="cuda"), every table / index tensor on the
     card.  Q6 (and an off-bin-edge variant), Q1, Q12 and Q3 through
     conn.sql() against numpy oracles on the generated columns (Q6 also
     against its known answer).  Each query runs with its launches counted
     from just before it to just after: K1 must launch in Q6; K2
     exactly once in Q12 (the probe with the o_orderpriority value lut: 2
     luts) and once in Q3 (the lineitem -> orders join: the row lut and 3
     value luts); K6 in none of them.  Each kernel is then compared with its
     plain version on the inputs the main path gave it, K6 on the catalog's
     o_comment, p_name, p_type and s_comment dictionaries; then, inside a
     transaction, LIKE finds an order INSERTed with a new o_comment, and
     after ROLLBACK does not;
  5. TPC-H plans: each of the 22 builders of `tpch/queries.py` through
     `queries.run(conn.executor, n)` on the card catalog, with the launches
     counted from just before it to just after, held cell by cell
     (DOUBLE cells within 1e-9, relative) against the port's own run of
     the same builder on a CPU catalog at the same SF; its K1 and K2
     launches must equal what the CPU run's wrapper calls would launch (K2
     launches in q3, q7, q9, q12, q21 and more, K1 in q6).  Per query: the
     rows (the first five), K2 and K1 launches, `Executor.retry_count`'s
     rise, the median of warm wall times, and the profiled device time and
     busy share.  Then six plans over the same two catalogs take the
     HashJoin paths the 22 do not take: inner expansion with capacity
     regrows (orders x lineitem), a single-match join on duplicate build
     keys (the `unique` retry to expansion), FULL OUTER, LEFT with a found
     column, ANTI on a packed 2-column key and SEMI on a hashed 3-column
     key, each equal to its CPU run;
  6. TPC-H SQL: each of the 22 texts of `tpch/sql_queries.py` through
     `conn.sql(...)` on the same card catalog, with the launches counted
     from just before it to just after, held cell by cell (DOUBLE cells
     within 1e-9) against the rows the card's builder of the same query
     gave in phase 5 (themselves held against the port's CPU run).  K1 must
     launch exactly once in q6, K2 in q3 and q12, K7 at least once for
     each compacted stage input (and on the profiler's root,
     `k7_launches`), K6 in q2, q9, q13, q14,
     q16 and q20 and in no other text, and again in every timed run (no
     truth table is kept).  Per query: the first rows, K1 / K2 launches
     beside the builder's, K6's, the retries, the median of warm wall times
     and the profiled device time;
  7. sqllogic: each file of `testing/sqllogic_gate.FILES` through the
     port's copy of the sqllogic runner on a fresh `Connection()` (the
     card);
  8. windows, range and ASOF joins (`tpch/analytic_sql.py`) through
     `conn.sql` on the card, each with the launches counted from just
     before it to just after, held cell by cell against the port's
     run on the CPU catalog of phase 5: W1 (lineitem, a partition per
     order: row_number, the running SUM, a sliding MAX over ROWS, LAG with
     a default), W2 (orders, a partition per customer: rank() and a 90-day
     RANGE frame), R1 (lineitem against 84 monthly date bands: two bounds
     and a residual), A1 (each order's previous order by the same
     customer, inner and LEFT); W1 and A1 also against numpy oracles.  Per
     query the rows, the retries, the warm median and the profiled device
     time with its top kernels;
  9. timing: each query end to end (median of warm runs), the device busy
     share of each from torch.profiler with its top device kernels, the
     device time of the PK probe's prelude beside K2's, and each kernel
     alone against its plain version at the main path's shapes with the L2
     cache flushed, beside its bound (the bytes it must move at 3.35 TB/s)
     and the one PyTorch call that computes the same function, where there
     is one; K2's 2- and 4-lut passes against the one-lut launches they
     replaced; K6 at q13's o_comment and q09's p_name inputs, and the host
     regex walk it replaced at q13's; K7 at `K7_SHAPES` beside the plain
     sort and torch.nonzero (the library yardstick, which the port never
     calls); K8 at `K8_SHAPES` (SSB SF20's star-join passes) beside its
     plain body, the route it replaced (`DirectPKIndex.probe` and the row
     gathers) and a bare `lut[keys]`;
 10. entry points, each with the launches counted from just before it
     to just after, on the catalog already loaded:
     `benchmarks.q6bench` (64 random word variants over lineitem; K3 and
     K4 must launch; then K3 on all-zero words and K4 on an all-zero mask,
     L2 flushed: their fixed cost beside their time at variant 0, and that
     time after a flush that leaves the L2 clean),
     `benchmarks.gather_probe` (N = 2**22, T = 2**13; K5a
     and K5b must launch; then K5a on 128 indices and K5b on one row, L2
     flushed: their fixed cost, beside one torch kernel on one element, and
     their time at N = 2**22 after a clean-L2 flush).  Each checks its own
     results and prints its times;
 11. executor modes: verification, EXPLAIN ANALYZE, prepared queries, the
     deadline, staged against whole plan and out of core;
 12. mesh: the parallel steps (`duckdb_cubit_tpu_torch/parallel/`) on a
     one-rank NCCL process group on the card (one H100: NCCL puts no two
     ranks on one device, so this shows the collectives run and agree, and
     claims no scaling), each equal to its single-device counterpart and
     an oracle: Q6's step over the three predicate words of Q6's CUBIT
     indexes (the phase-4 revenue, `masked_sum_exact`, K1 on the same
     words), the grouped step over Q1's (l_returnflag, l_linestatus) code
     and l_quantity (`group_sum_exact`, `group_count`), the partitioned and
     pipelined (4 chunks) joins of lineitem.l_orderkey against
     orders.o_orderkey (a numpy oracle of sum l_quantity * o_custkey,
     overflow 0) and the requota on l_orderkey from a quarter of the rows
     (3 rounds, 4x the quota, every key kept).  Each step's median warm
     time beside its single-device counterpart's;
 13. engine on a mesh: `connect(sf, device="cuda", mesh=make_mesh(1))` on
     a one-rank NCCL group, the catalog loaded on the host and sharded
     (every table a row block on the card): Q6, Q1, Q12, Q3 and the 22 SQL
     texts, each with the launches counted from just before it to just
     after (K2 must launch, K1 must not: it declines on a mesh, as
     the reference's does), equal to the single-device connection's rows
     with the same retries; their medians, mesh and single device
     interleaved; the radix-exchange join forced on (`SET
     exchange_min_build_rows = 1`): lineitem x orders against the numpy
     oracle 1149209522195200, `nccl:all_to_all` in its profile, SQL q3 and
     q7 equal to their single-device rows; the skew requota on 2M probe
     rows, half on one key, retrying to the single device's rows;
 14. entry point: shell: `python -m duckdb_cubit_tpu_torch.shell --sf
     0.01` driven through stdin (`\\timing`, `\\d`, `\\tpch 6`, a
     multi-line SELECT, `\\q`), its lines equal to `conn.sql` /
     `tpch_query` on a card catalog at SF0.01;
 15. DML, transactions and persistence, last because it mutates the
     catalog: BEGIN; UPDATE of l_discount over about 1% of lineitem (Q6
     equal to its numpy oracle over the mutated columns, K1 launches once);
     UPDATE of o_shippriority (a column Q3's K2 pass fetches through a
     value lut) around Q3's top order (Q3 equal to its oracle, its first
     row showing the new value, K2 launches); DELETE of about 1/7 of orders
     (Q12, Q3); DELETE of lineitem rows with l_quantity > 45 (Q1, Q6; K1
     does not launch); ROLLBACK (all four equal their rows from before,
     K1 launches again); a checkpoint of the whole catalog, a committed
     DELETE in the write-ahead log, and `open_database(path,
     device="cuda")`, whose Q1, Q6 and Q3 equal the first connection's.
     Each statement's time, the checkpoint's seconds and bytes and the
     reopen's seconds are printed;
 16. DML, transactions, persistence and the deadline on a mesh: a fresh
     `connect(sf, device="cuda", mesh=make_mesh(1))` on a one-rank NCCL
     group runs phase 15's statements in its order, each query's rows
     equal to phase 15's after the same statement (K1 never launches, K2
     where phase 15 requires it); a checkpoint written by the mesh, the
     committed DELETE in its log, and the reopen onto the mesh
     (`Connection(open_database(path, device="cpu").catalog, ...,
     mesh=...)`); then, on it and on phase 15's reopened connection side
     by side, an INSERT of three lineitem rows through SQL, an
     `append_rows` that grows lineitem past its capacity (Q1, Q6, Q12, Q3
     equal), and q13 under a 3 ms deadline (it must raise; Q6 answers
     after it).  Each statement's time, the checkpoint's seconds and bytes
     and the reopen's seconds are printed beside phase 15's.

The kernel table is one JSON line (each kernel's `launches` sums the main
path's runs: the four SQL queries, the 22 plans, the 22 SQL texts, the
window / join queries, the executor modes, the engine on a mesh and the
two DML phases' queries, split in `launches_by_path` as "sql",
"tpch_plans", "tpch_sql", "windows", "verification", "external",
"mesh_engine", "dml" and "mesh_dml"), then the card's name and power
limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from duckdb_cubit_tpu_torch.benchmarks.timing import (bound_ms, card_line,
                                                      device_busy_share,
                                                      device_kernel_times,
                                                      flush_buffer,
                                                      time_cold, turns)
from duckdb_cubit_tpu_torch.exec import profiler as PROF

Q6 = """
    SELECT sum(l_extendedprice * l_discount) AS revenue
    FROM lineitem
    WHERE l_shipdate >= CAST('1994-01-01' AS date)
      AND l_shipdate < CAST('1995-01-01' AS date)
      AND l_discount BETWEEN 0.05 AND 0.07
      AND l_quantity < 24
"""
# bounds off the index's bin edges: residual filters, no fused path
Q6_OFF_EDGE = """
    SELECT sum(l_extendedprice * l_discount) AS revenue
    FROM lineitem
    WHERE l_shipdate >= CAST('1994-01-10' AS date)
      AND l_shipdate < CAST('1995-01-01' AS date)
      AND l_discount BETWEEN 0.05 AND 0.07
      AND l_quantity < 23.5
"""
Q1 = """
    SELECT l_returnflag, l_linestatus,
           sum(l_quantity) AS sum_qty,
           sum(l_extendedprice) AS sum_base_price,
           sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
           avg(l_quantity) AS avg_qty,
           avg(l_extendedprice) AS avg_price,
           avg(l_discount) AS avg_disc,
           count(*) AS count_order
    FROM lineitem
    WHERE l_shipdate <= CAST('1998-09-02' AS date)
    GROUP BY l_returnflag, l_linestatus
    ORDER BY l_returnflag, l_linestatus
"""
Q12 = """
    SELECT l_shipmode,
           sum(CASE WHEN o_orderpriority = '1-URGENT'
                     OR o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END)
               AS high_line_count,
           sum(CASE WHEN o_orderpriority <> '1-URGENT'
                    AND o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END)
               AS low_line_count
    FROM orders, lineitem
    WHERE o_orderkey = l_orderkey
      AND l_shipmode IN ('MAIL', 'SHIP')
      AND l_commitdate < l_receiptdate
      AND l_shipdate < l_commitdate
      AND l_receiptdate >= CAST('1994-01-01' AS date)
      AND l_receiptdate < CAST('1995-01-01' AS date)
    GROUP BY l_shipmode
    ORDER BY l_shipmode
"""
Q3 = """
    SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
           o_orderdate, o_shippriority
    FROM customer, orders, lineitem
    WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
      AND l_orderkey = o_orderkey
      AND o_orderdate < CAST('1995-03-15' AS date)
      AND l_shipdate > CAST('1995-03-15' AS date)
    GROUP BY l_orderkey, o_orderdate, o_shippriority
    ORDER BY revenue DESC, o_orderdate
    LIMIT 10
"""
# TPC-H Q6 answers: SF1 is the specification's published answer; SF10 is the
# reference package's result, checked there against a numpy oracle
KNOWN_Q6 = {1.0: "123141078.2283", 10.0: "1230113636.0101"}
REPLACES = {
    "fused_scan_sum": "duckdb_cubit_tpu/ops/pallas_kernels.py:148",
    "monotone_gather": "duckdb_cubit_tpu/ops/pallas_probe.py:170",
    "q6_words_i32": "benchmarks/q6bench.py:127 (pallas_q6, kernel q6_kernel "
                    ":110)",
    "q6_mask8_i32": "benchmarks/q6bench.py:168 (pallas_m8, kernel "
                    "pallas_m8_kernel :154)",
    "table_gather": "benchmarks/pallas_gather_probe.py:35 (try_kernel: kA "
                    ":62, kA2 :77, kC :113)",
    "lane_gather": "benchmarks/pallas_gather_probe.py:35 (try_kernel: kB "
                   ":94)",
    "dict_like": "none: duckdb_cubit_tpu/ops/expressions.py:428 (Like) "
                 "matches a regex per dictionary entry on the host",
    "stream_compact": "none: the sort in duckdb_cubit_tpu/ops/kernels.py:233 "
                      "(mask_to_indices)",
    "pk_probe": "none: duckdb_cubit_tpu/index/pk.py:61 (probe) and the row "
                "gathers of duckdb_cubit_tpu/plan/physical.py:806 "
                "(_gather_single), plain array operations",
}
# K7 at the main path's shapes: (label, rows, density, capacity); the first
# is the one the kernel table reports
K7_SHAPES = [("SSB SF20 lineorder at Q1.1's density", 120_000_000, 0.019,
              4_194_304),
             ("SSB SF20 lineorder at 0.1%", 120_000_000, 0.001, 131_072),
             ("TPC-H SF1 lineitem at 2%", 6_001_215, 0.02, 131_072)]
# K8 at SSB SF20's star-join passes: (label, probe rows, table slots, table
# rows, value luts, live share of the table's rows); the first is the one
# the kernel table reports
K8_SHAPES = [("SSB SF20 pass into part, 1 value lut", 60_000_000, 1_000_000,
              1_000_000, 1, 0.04),
             ("SSB SF20 pass into ddate, 1 value lut", 60_000_000, 61_130,
              2_556, 1, 1 / 7),
             ("SSB SF20 pass into customer, 2 value luts", 60_000_000,
              600_000, 600_000, 2, 0.2)]
# the SQL texts that evaluate LIKE, so K6 launches there and nowhere else
K6_TEXTS = {2, 9, 13, 14, 16, 20}
# the kernel test files whose `cuda` cases hold each kernel to its plain
# body on the card
KERNEL_TESTS = ["tests/test_torch_fused_scan.py", "tests/test_torch_probe.py",
                "tests/test_torch_q6_variants.py",
                "tests/test_torch_gather_forms.py",
                "tests/test_torch_like_year_substr.py",
                "tests/test_torch_compact.py",
                "tests/test_torch_pk_probe.py"]
# the real dictionaries K6 is held to on the loaded catalog, with the
# patterns TPC-H's queries give them
K6_COLUMNS = [("orders", "o_comment", ["%special%requests%",
                                       "%pending%deposits%", "%express%"]),
              ("part", "p_name", ["%green%", "forest%", "%_ed%"]),
              ("part", "p_type", ["PROMO%", "%BRASS", "MEDIUM POLISHED%"]),
              ("supplier", "s_comment", ["%Customer%Complaints%"])]
# relative tolerance of DOUBLE cells against the numpy oracle: the engine
# and numpy sum floats in different orders
DOUBLE_RTOL = 1e-9
# the deadline q13 must not meet, on one device and on a mesh: q13 takes
# about 13 ms at SF1 on an H100 since its LIKE runs on the card (K6)
DEADLINE_S = 0.003
# warm runs behind each end-to-end and profiled time
RUNS = 20
# warm runs behind each TPC-H plan's median
RUNS_PLANS = 10
# warm runs behind each window / range / ASOF query's median
RUNS_WINDOWS = 10
# warm runs behind each mesh step's median
RUNS_MESH = 10
# the shell phase's SELECT: one statement over four lines
SHELL_SELECT = """SELECT l_returnflag, l_linestatus, count(*) AS c,
       sum(l_quantity) AS q
  FROM lineitem WHERE l_shipdate <= CAST('1998-09-02' AS date)
 GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus;"""


def phase(name: str):
    print(f"== {name}", flush=True)


def live_columns(table, names) -> dict:
    """Host int64 columns of a table's live rows (its deleted rows left
    out), from the host mirrors every DML statement keeps current."""
    n = table.num_rows
    keep = None if table.deleted is None else \
        ~table.deleted[:n].cpu().numpy()
    out = {}
    for name in names:
        a = table.columns[name].host[:n].astype(np.int64)
        out[name] = a if keep is None else a[keep]
    return out


def q6_kernel_inputs(conn):
    """Run Q6 once and take K1's inputs from its prepared plan: -> (words,
    payloads, packed)."""
    conn.executor.execute(conn.binder.bind_sql(Q6))
    agg = next(op for op in conn.executor.plan.walk()
               if type(op).__name__ == "GroupAggregate")
    if agg._kernel is None:
        raise AssertionError("Q6's prepared plan holds no K1 payload")
    payloads, packed = agg._kernel
    return agg.children[0]._words, payloads, packed


def oracle_q6(li: dict, ship_lo: str, qty_lt_cents: int) -> str:
    """Q6 from host columns with numpy: independent of both engines."""
    from duckdb_cubit_tpu_torch.exec.result import format_decimal
    from duckdb_cubit_tpu_torch.types import date_to_days

    sel = ((li["l_shipdate"] >= date_to_days(ship_lo))
           & (li["l_shipdate"] < date_to_days("1995-01-01"))
           & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
           & (li["l_quantity"] < qty_lt_cents))
    total = int((li["l_extendedprice"][sel] * li["l_discount"][sel]).sum())
    return format_decimal(total, 4)


def _code(table, column: str, value: str) -> int:
    """A string's code in a column's sorted dictionary."""
    d = table.columns[column].dictionary
    i = int(np.searchsorted(d, value.encode()))
    if i >= len(d) or d[i] != value.encode():
        raise AssertionError(f"{value!r} not in {column}'s dictionary")
    return i


def oracle_q1(c: dict) -> list[list]:
    """Q1 from host columns with numpy; DOUBLE cells as floats."""
    from duckdb_cubit_tpu_torch.exec.result import format_decimal
    from duckdb_cubit_tpu_torch.types import date_to_days

    sel = c["l_shipdate"] <= date_to_days("1998-09-02")
    rows = []
    for rf in np.unique(c["l_returnflag"][sel]):
        for ls in np.unique(c["l_linestatus"][sel]):
            g = sel & (c["l_returnflag"] == rf) & (c["l_linestatus"] == ls)
            n = int(g.sum())
            if n == 0:
                continue
            qty, price = c["l_quantity"][g], c["l_extendedprice"][g]
            disc, tax = c["l_discount"][g], c["l_tax"][g]
            disc_price = price * (100 - disc)
            rows.append([chr(rf), chr(ls), format_decimal(int(qty.sum()), 2),
                         format_decimal(int(price.sum()), 2),
                         format_decimal(int(disc_price.sum()), 4),
                         format_decimal(int((disc_price * (100 + tax)).sum()),
                                        6),
                         int(qty.sum()) / n / 100, int(price.sum()) / n / 100,
                         int(disc.sum()) / n / 100, str(n)])
    return rows


def _row_of(keys_of_rows: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """The row holding each key (-1 where none does)."""
    lut = np.full(int(max(keys_of_rows.max(), keys.max())) + 1, -1, np.int64)
    lut[keys_of_rows] = np.arange(len(keys_of_rows))
    return lut[keys]


def oracle_q12(li: dict, od: dict, codes: dict) -> list[list]:
    """Q12 from host columns with numpy (the join through a key lut; a
    lineitem row whose order is gone matches nothing)."""
    from duckdb_cubit_tpu_torch.types import date_to_days

    row = _row_of(od["o_orderkey"], li["l_orderkey"])
    prio = od["o_orderpriority"][np.maximum(row, 0)]
    high = np.isin(prio, codes["high"])
    sel = ((row >= 0) & (li["l_commitdate"] < li["l_receiptdate"])
           & (li["l_shipdate"] < li["l_commitdate"])
           & (li["l_receiptdate"] >= date_to_days("1994-01-01"))
           & (li["l_receiptdate"] < date_to_days("1995-01-01")))
    rows = []
    for mode in ("MAIL", "SHIP"):
        m = sel & (li["l_shipmode"] == codes[mode])
        rows.append([mode, str(int((m & high).sum())),
                     str(int((m & ~high).sum()))])
    return rows


def oracle_q3(cu: dict, od: dict, li: dict, building: int) -> list[list]:
    """Q3 from host columns with numpy (lineitem is sorted by l_orderkey,
    so a group is a run)."""
    from duckdb_cubit_tpu_torch.exec.result import format_decimal
    from duckdb_cubit_tpu_torch.types import date_to_days, days_to_date

    lk = li["l_orderkey"]
    if not np.all(lk[1:] >= lk[:-1]):
        raise AssertionError("lineitem is not sorted by l_orderkey")
    is_building = np.zeros(int(cu["c_custkey"].max()) + 1, bool)
    is_building[cu["c_custkey"][cu["c_mktsegment"] == building]] = True
    okey, odate = od["o_orderkey"], od["o_orderdate"]
    cut = date_to_days("1995-03-15")
    order_ok = np.zeros(int(max(okey.max(), lk.max())) + 1, bool)
    order_ok[okey[(odate < cut) & is_building[od["o_custkey"]]]] = True
    sel = (li["l_shipdate"] > cut) & order_ok[lk]
    keys = lk[sel]
    rev = li["l_extendedprice"][sel] * (100 - li["l_discount"][sel])
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    sums = np.add.reduceat(rev, starts)
    ukeys = keys[starts]
    orow = _row_of(okey, ukeys)
    top = np.lexsort((odate[orow], -sums))[:10]
    return [[str(int(ukeys[i])), format_decimal(int(sums[i]), 4),
             days_to_date(int(odate[orow[i]])).isoformat(),
             str(int(od["o_shippriority"][orow[i]]))] for i in top]


LI_COLS = ("l_orderkey", "l_linenumber", "l_quantity", "l_extendedprice",
           "l_discount", "l_tax", "l_returnflag", "l_linestatus",
           "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipmode")
ORDER_COLS = ("o_orderkey", "o_custkey", "o_orderdate", "o_orderpriority",
              "o_shippriority", "o_totalprice")


def oracle_of(cat, name: str) -> list[list]:
    """The numpy oracle of Q6 / Q1 / Q12 / Q3 over the catalog's live rows
    as they are now (after any DML)."""
    lineitem, orders = cat.table("lineitem"), cat.table("orders")
    li = live_columns(lineitem, LI_COLS)
    if name == "Q6":
        return [[oracle_q6(li, "1994-01-01", 2400)]]
    if name == "Q1":
        return oracle_q1(li)
    od = live_columns(orders, ORDER_COLS)
    if name == "Q12":
        return oracle_q12(li, od, {
            "high": [_code(orders, "o_orderpriority", "1-URGENT"),
                     _code(orders, "o_orderpriority", "2-HIGH")],
            "MAIL": _code(lineitem, "l_shipmode", "MAIL"),
            "SHIP": _code(lineitem, "l_shipmode", "SHIP")})
    customer = cat.table("customer")
    return oracle_q3(live_columns(customer, ("c_custkey", "c_mktsegment")),
                     od, li, _code(customer, "c_mktsegment", "BUILDING"))


def rows_agree(got: list[list], want: list[list]) -> bool:
    """Engine rows (strings) against oracle rows: float oracle cells within
    DOUBLE_RTOL, every other cell equal as text."""
    if len(got) != len(want):
        return False
    for g_row, w_row in zip(got, want):
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                if abs(float(g) - w) > DOUBLE_RTOL * max(abs(w), 1e-300):
                    return False
            elif g != w:
                return False
    return True


def cells_agree(got: list[list], want: list[list], doubles: list) -> bool:
    """Rows of two runs of one plan, cell by cell: cells of DOUBLE columns
    within DOUBLE_RTOL of each other, every other cell equal as text."""
    if len(got) != len(want):
        return False
    for g_row, w_row in zip(got, want):
        for g, w, dbl in zip(g_row, w_row, doubles):
            if g == w:
                continue
            if not dbl or "NULL" in (g, w):
                return False
            gf, wf = float(g), float(w)
            if abs(gf - wf) > DOUBLE_RTOL * max(abs(gf), abs(wf), 1e-300):
                return False
    return True


def kernel_calls(run) -> tuple:
    """`run()` with the K1, K2 and K7 wrappers recording their calls (a
    recording run is not a counted main-path run; on the CPU the wrappers
    run their plain bodies).  -> (run's result, K1 calls, the (luts, keys)
    of each K2 call, K7 calls)."""
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs
    from duckdb_cubit_tpu_torch.ops import kernels, probe

    k1, k2, k7 = [], [], []
    real_k1, real_k2 = fs.fused_scan_sum, probe.monotone_gather_many
    real_k7 = kernels.mask_to_indices

    def k1_recording(*args):
        k1.append(1)
        return real_k1(*args)

    def k2_recording(luts, keys):
        k2.append((list(luts), keys))
        return real_k2(luts, keys)

    def k7_recording(*args):
        k7.append(1)
        return real_k7(*args)
    fs.fused_scan_sum, probe.monotone_gather_many = k1_recording, k2_recording
    kernels.mask_to_indices = k7_recording
    try:
        result = run()
    finally:
        fs.fused_scan_sum, probe.monotone_gather_many = real_k1, real_k2
        kernels.mask_to_indices = real_k7
    return result, len(k1), k2, len(k7)


def tpch_plans(conn, sf: float, card: str) -> dict:
    """The 22 TPC-H plan builders on the card, each held against the port's
    own CPU run of the same builder at the same SF (the reference cannot run
    on this machine).  Each card run has the launches counted from just
    before it to just after; its K1 and K2 launches must equal what
    the CPU run's calls of the two wrappers would launch (one K2 launch per
    MAX_LUTS luts of a call): kernel eligibility does not depend on the
    device.  K7 launches once for each call of the CPU run's
    `kernels.mask_to_indices`.
    -> {"launches": {kernel: total}, "queries": [per-query row]}."""
    from duckdb_cubit_tpu_torch.api import connect
    from duckdb_cubit_tpu_torch.exec.result import to_strings
    from duckdb_cubit_tpu_torch.ops.probe import MAX_LUTS
    from duckdb_cubit_tpu_torch.tpch import queries
    from duckdb_cubit_tpu_torch.types import TypeId

    t0 = time.perf_counter()
    cpu = connect(sf=sf, device="cpu")
    print(f"CPU catalog at SF{sf:g} loaded in {time.perf_counter() - t0:.2f} s")
    totals = {"fused_scan_sum": 0, "monotone_gather": 0, "dict_like": 0,
              "stream_compact": 0, "pk_probe": 0}
    out, card_rows = [], {}
    for n in sorted(queries.QUERIES):
        def run_card(n=n):
            rel = queries.run(conn.executor, n)
            return rel, to_strings(rel)
        retries = conn.executor.retry_count
        (rel, rows), counts = counted(run_card)
        retried = conn.executor.retry_count - retries
        t1 = time.perf_counter()
        want, k1_calls, k2_calls, k7_calls = kernel_calls(
            lambda n=n: to_strings(queries.run(cpu.executor, n)))
        k2_luts = [len(luts) for luts, _ in k2_calls]
        cpu_s = time.perf_counter() - t1
        doubles = [c.dtype.id == TypeId.DOUBLE for c in rel.columns.values()]
        if not cells_agree(rows, want, doubles):
            raise AssertionError(f"Q{n} on the card disagrees with the CPU "
                                 f"run: {rows[:3]} vs {want[:3]}")
        k2_want = sum(-(-luts // MAX_LUTS) for luts in k2_luts)
        k1, k2 = counts["fused_scan_sum"], counts["monotone_gather"]
        k7 = counts["stream_compact"]
        if k2 != k2_want or k1 != k1_calls or k7 != k7_calls:
            raise AssertionError(
                f"Q{n} launched K1 {k1} / K2 {k2} / K7 {k7} times; its CPU "
                f"run calls K1 {k1_calls} times, K2 with luts {k2_luts} and "
                f"K7 {k7_calls} times")
        totals["fused_scan_sum"] += k1
        totals["monotone_gather"] += k2
        totals["dict_like"] += counts["dict_like"]
        totals["stream_compact"] += k7
        totals["pk_probe"] += counts["pk_probe"]
        times = []
        for _ in range(RUNS_PLANS + 2):
            t1 = time.perf_counter()
            run_card()
            times.append((time.perf_counter() - t1) * 1e3)
        median = statistics.median(times[2:])
        dev_ms, wall_ms, top = device_busy_share(run_card, 3)
        print(f"Q{n}: {len(rows)} rows, equal to the CPU run ({cpu_s:.2f} s "
              f"there); K2 launches {k2} (luts per call {k2_luts}), K1 "
              f"launches {k1}, K7 launches {k7}, retries {retried}; median {median:.3f} ms "
              f"over {RUNS_PLANS} warm runs; profiled: device kernels "
              f"{dev_ms:.4f} ms of {wall_ms:.4f} ms wall, busy share "
              f"{dev_ms / wall_ms:.4f}  [{card}]")
        print(f"  top device kernels per query: {top}")
        for row in rows[:5]:
            print("   ", row)
        if len(rows) > 5:
            print(f"    ... {len(rows) - 5} more rows")
        out.append({"query": n, "rows": len(rows), "k1_launches": k1,
                    "k2_launches": k2, "k2_luts": k2_luts,
                    "k7_launches": k7,
                    "retries": retried, "median_ms": median,
                    "device_ms": dev_ms, "profiled_wall_ms": wall_ms})
        card_rows[n] = rows, doubles
    for name, total in totals.items():
        if total < 1:
            raise AssertionError(f"{name} did not launch in the 22 plans")
    print(f"22 TPC-H plans equal their CPU runs; launches {totals}; "
          f"retries {sum(q['retries'] for q in out)}")
    print(json.dumps({"tpch_plans": out}))
    print("HashJoin paths the 22 plans do not take at this SF:")
    general_joins(conn, cpu, card)
    return {"launches": totals, "queries": out, "rows": card_rows,
            "cpu": cpu}


def tpch_sql(conn, plans: dict, card: str) -> dict:
    """The 22 TPC-H SQL texts through `conn.sql` on the card, each held cell
    by cell against the rows the card's builder of the same query gave
    (`plans["rows"]`, already held against the port's CPU run).  Each run
    has the launches counted from just before it to just after: K1
    must launch exactly once in q6, K2 in q3 and q12, K7 at least once for
    each compacted stage input; the profiler's root of one text with a
    compaction counts K7's launches as the wrapper does.
    -> {"launches": {kernel: total}, "queries": [per-query row]}."""
    from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL

    builder = {q["query"]: q for q in plans["queries"]}
    must = {6: {"fused_scan_sum": 1}, 3: {"monotone_gather": 1},
            12: {"monotone_gather": 1}}
    totals = {"fused_scan_sum": 0, "monotone_gather": 0, "dict_like": 0,
              "stream_compact": 0, "pk_probe": 0}
    out, text_rows = [], {}
    for n in sorted(SQL):
        def run(n=n):
            return conn.sql(SQL[n]).strings()
        retries = conn.executor.retry_count
        compacted = conn.executor.compacted_boundaries
        rows, counts = counted(run)
        retried = conn.executor.retry_count - retries
        compacted = conn.executor.compacted_boundaries - compacted
        want, doubles = plans["rows"][n]
        if not cells_agree(rows, want, doubles):
            raise AssertionError(f"SQL q{n} disagrees with its builder on "
                                 f"the card: {rows[:3]} vs {want[:3]}")
        k1, k2 = counts["fused_scan_sum"], counts["monotone_gather"]
        if k1 != must.get(n, {}).get("fused_scan_sum", k1) or \
                k2 < must.get(n, {}).get("monotone_gather", 0):
            raise AssertionError(f"SQL q{n} launched K1 {k1} / K2 {k2} "
                                 f"times; expected {must[n]}")
        k6 = counts["dict_like"]
        if (k6 > 0) != (n in K6_TEXTS):
            raise AssertionError(f"SQL q{n} launched K6 {k6} times; K6 "
                                 f"launches in q{sorted(K6_TEXTS)} only")
        k7 = counts["stream_compact"]
        if k7 < compacted:
            raise AssertionError(f"SQL q{n} compacted {compacted} stage "
                                 f"inputs but launched K7 {k7} times")
        totals["fused_scan_sum"] += k1
        totals["monotone_gather"] += k2
        totals["dict_like"] += k6
        totals["stream_compact"] += k7
        totals["pk_probe"] += counts["pk_probe"]
        times = []
        # no truth table is kept: every run launches K6 again
        before = PROF.read("k6_launches")
        for _ in range(RUNS_PLANS + 2):
            t1 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t1) * 1e3)
        timed_k6 = PROF.read("k6_launches") - before
        if timed_k6 != k6 * (RUNS_PLANS + 2):
            raise AssertionError(f"SQL q{n}: K6 launched {timed_k6} times in "
                                 f"{RUNS_PLANS + 2} runs, {k6} a run before")
        median = statistics.median(times[2:])
        dev_ms, wall_ms, _ = device_busy_share(run, 3)
        b = builder[n]
        print(f"SQL q{n}: {len(rows)} rows, equal to the builder's; K1 "
              f"{k1} (builder {b['k1_launches']}), K2 {k2} (builder "
              f"{b['k2_launches']}), retries {retried}; median "
              f"{median:.3f} ms over {RUNS_PLANS} warm runs (builder "
              f"{b['median_ms']:.3f}); profiled: device kernels "
              f"{dev_ms:.4f} ms of {wall_ms:.4f} ms wall (builder "
              f"{b['device_ms']:.4f}); compacted stage inputs "
              f"{compacted}, K7 {k7}; K6 {k6}  [{card}]")
        for row in rows[:3]:
            print("   ", row)
        out.append({"query": n, "rows": len(rows), "k1_launches": k1,
                    "k2_launches": k2, "k6_launches": k6,
                    "k7_launches": k7,
                    "retries": retried,
                    "median_ms": median, "device_ms": dev_ms,
                    "profiled_wall_ms": wall_ms,
                    "builder_median_ms": b["median_ms"],
                    "builder_device_ms": b["device_ms"],
                    "compacted": compacted})
        text_rows[n] = rows, doubles
    print(f"22 TPC-H SQL texts equal their builders; launches {totals}; "
          f"retries {sum(q['retries'] for q in out)}")
    print(json.dumps({"tpch_sql": out}))
    first = next(q for q in out if q["compacted"])
    k7_on_root(conn, SQL[first["query"]], first["k7_launches"],
               f"SQL q{first['query']}")
    return {"launches": totals, "queries": out, "rows": text_rows}


def sqllogic_on_card(card: str):
    """Each gated sqllogic file through the port's runner on a fresh
    `Connection()`, which is on the card."""
    from duckdb_cubit_tpu_torch.api import Connection
    from duckdb_cubit_tpu_torch.testing.sqllogic import run_file
    from duckdb_cubit_tpu_torch.testing.sqllogic_gate import FILES

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "sqllogic")
    t0 = time.perf_counter()
    records = 0
    for rel in FILES:
        conn = Connection()
        if conn.device.type != "cuda":
            raise AssertionError(f"Connection() is on {conn.device}")
        report = run_file(os.path.join(root, rel), conn=conn)
        if report.skipped or report.executed < 1:
            raise AssertionError(f"{rel}: skipped or empty ({report})")
        records += report.executed
        print(f"{rel}: {report.executed} records pass")
    print(f"sqllogic: {len(FILES)} files, {records} records executed on the "
          f"card in {time.perf_counter() - t0:.2f} s  [{card}]")


def general_join_plans() -> dict:
    """Plans that take HashJoin's paths no TPC-H builder takes at SF1, each
    under an ungrouped count / sum so that the result is one row."""
    from duckdb_cubit_tpu_torch.ops.expressions import Col
    from duckdb_cubit_tpu_torch.plan.physical import (Aggregate,
                                                      GroupAggregate,
                                                      HashJoin, TableScan)

    def summed(join, *cols):
        return GroupAggregate(join, [], [Aggregate("count", None, "n")] + [
            Aggregate("count", Col(c), f"n_{c}") for c in cols] + [
            Aggregate("sum", Col(c), f"s_{c}") for c in cols])

    def scan(table, *cols):
        return TableScan(table, projection=list(cols))

    return {
        # about 6M pairs against a capacity of twice orders': regrows
        "inner expansion, orders x lineitem": lambda: summed(HashJoin(
            scan("orders", "o_orderkey", "o_totalprice"),
            scan("lineitem", "l_orderkey", "l_quantity"), ["o_orderkey"],
            ["l_orderkey"], single_match=False), "o_totalprice",
            "l_quantity"),
        # duplicate build keys under single match: the unique check fails
        # and the retry expands (and regrows)
        "single match on duplicate keys, customer x orders": lambda: summed(
            HashJoin(scan("customer", "c_custkey", "c_acctbal"),
                     scan("orders", "o_custkey", "o_totalprice"),
                     ["c_custkey"], ["o_custkey"]), "c_acctbal",
            "o_totalprice"),
        # a third of the customers place no order
        "full outer, customer x orders": lambda: summed(HashJoin(
            scan("customer", "c_custkey", "c_acctbal"),
            scan("orders", "o_custkey", "o_totalprice"), ["c_custkey"],
            ["o_custkey"], "full", single_match=False), "c_acctbal",
            "o_totalprice"),
        "left with a found column, customer x orders": lambda: summed(
            HashJoin(scan("customer", "c_custkey", "c_acctbal"),
                     scan("orders", "o_custkey", "o_totalprice"),
                     ["c_custkey"], ["o_custkey"], "left",
                     single_match=False, found_column="hit"),
            "c_acctbal", "o_totalprice"),
        "anti, packed 2-column key, partsupp x lineitem": lambda: summed(
            HashJoin(scan("partsupp", "ps_partkey", "ps_suppkey",
                          "ps_availqty"),
                     scan("lineitem", "l_partkey", "l_suppkey"),
                     ["ps_partkey", "ps_suppkey"],
                     ["l_partkey", "l_suppkey"], "anti"), "ps_availqty"),
        "semi, hashed 3-column key, partsupp x lineitem": lambda: summed(
            HashJoin(scan("partsupp", "ps_partkey", "ps_suppkey",
                          "ps_availqty"),
                     scan("lineitem", "l_partkey", "l_suppkey",
                          "l_linenumber"),
                     ["ps_partkey", "ps_suppkey", "ps_availqty"],
                     ["l_partkey", "l_suppkey", "l_linenumber"], "semi"),
            "ps_availqty"),
    }


def general_joins(conn, cpu, card: str):
    """Each general-join plan on the card against the CPU run; prints the
    rows, the retries and the card's wall time of the run."""
    from duckdb_cubit_tpu_torch.exec.result import to_strings

    for label, build in general_join_plans().items():
        retries = conn.executor.retry_count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = to_strings(conn.executor.execute(build()))
        wall = (time.perf_counter() - t0) * 1e3
        retried = conn.executor.retry_count - retries
        want = to_strings(cpu.executor.execute(build()))
        if rows != want:
            raise AssertionError(f"{label}: card {rows} vs CPU {want}")
        print(f"{label}: {rows[0]}, equal to the CPU run; retries "
              f"{retried}; {wall:.3f} ms on the card, retries included  "
              f"[{card}]")


def oracle_w1(li: dict) -> list[list]:
    """W1 with numpy: per order (sorted by l_orderkey, l_linenumber) the row
    number, the running SUM of the price, the MAX of the quantity over the
    row and its neighbours, and the LAG of the quantity (0 first)."""
    from duckdb_cubit_tpu_torch.exec.result import format_decimal

    o = np.lexsort((li["l_linenumber"], li["l_orderkey"]))
    key, price, qty = (li[n][o] for n in ("l_orderkey", "l_extendedprice",
                                           "l_quantity"))
    n = len(key)
    first = np.r_[True, key[1:] != key[:-1]]
    last = np.r_[key[1:] != key[:-1], True]
    start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    rn = np.arange(n) - start + 1
    csum = np.cumsum(price)
    rs = csum - np.where(start > 0, csum[np.maximum(start - 1, 0)], 0)
    prev = np.where(first, qty, np.r_[qty[:1], qty[:-1]])
    nxt = np.where(last, qty, np.r_[qty[1:], qty[-1:]])
    mq = np.maximum(np.maximum(prev, qty), nxt)
    lg = np.where(first, 0, np.r_[0, qty[:-1]])
    return [[str(n), str(int(rn.sum())), format_decimal(int(rs.sum()), 2),
             format_decimal(int(mq.sum()), 2),
             format_decimal(int(lg.sum()), 2)]]


def oracle_a1(od: dict) -> tuple[list[list], list[list]]:
    """A1 and its LEFT form with numpy: each order's latest earlier order of
    the same customer (among equal dates the last in row order, as the
    join's stable sort leaves them)."""
    from duckdb_cubit_tpu_torch.exec.result import format_decimal

    cust, date, price = od["o_custkey"], od["o_orderdate"], \
        od["o_totalprice"]
    enc = (cust << 20) | date
    o = np.lexsort((np.arange(len(enc)), enc))
    pos = np.searchsorted(enc[o], enc, side="left") - 1
    hit = (pos >= 0) & (cust[o][np.maximum(pos, 0)] == cust)
    total = int(price[o][np.maximum(pos, 0)][hit].sum())
    return ([[str(int(hit.sum())), format_decimal(total, 2)]],
            [[str(len(enc))]])


def windows_and_joins(conn, cpu, card: str) -> dict:
    """W1, W2, R1 and A1 (`tpch/analytic_sql.py`) through `conn.sql` on the
    card, each with the launches counted from just before it to just
    after, held cell by cell against the port's run on the CPU catalog
    of the TPC-H plans phase; W1 and A1 also against numpy oracles.  Per
    query: the rows, the retries, the median of warm wall times and the
    profiled device time with its top kernels.  -> {"launches": {kernel:
    total}, "queries": [per-query row]}."""
    from duckdb_cubit_tpu_torch.tpch import analytic_sql as S
    from duckdb_cubit_tpu_torch.types import TypeId

    for c in (conn, cpu):
        for stmt in S.month_bands():
            c.sql(stmt)
    cat = conn.catalog
    oracles = {"W1": oracle_w1(live_columns(cat.table("lineitem"),
                                            LI_COLS))}
    oracles["A1"], oracles["A1_LEFT"] = oracle_a1(
        live_columns(cat.table("orders"), ORDER_COLS))
    totals = {"fused_scan_sum": 0, "monotone_gather": 0}
    out = []
    for name, sql in S.QUERIES.items():
        def run(sql=sql):
            res = conn.sql(sql)
            return res.relation, res.strings()
        retries = conn.executor.retry_count
        (rel, rows), counts = counted(run)
        retried = conn.executor.retry_count - retries
        t1 = time.perf_counter()
        want = cpu.sql(sql).strings()
        cpu_s = time.perf_counter() - t1
        doubles = [c.dtype.id == TypeId.DOUBLE for c in rel.columns.values()]
        if not cells_agree(rows, want, doubles):
            raise AssertionError(f"{name} on the card disagrees with the CPU "
                                 f"run: {rows[:3]} vs {want[:3]}")
        if name in oracles and rows != oracles[name]:
            raise AssertionError(f"{name} disagrees with the numpy oracle: "
                                 f"{rows} vs {oracles[name]}")
        for kernel in totals:
            totals[kernel] += counts[kernel]
        times = []
        for _ in range(RUNS_WINDOWS + 2):
            t1 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t1) * 1e3)
        median = statistics.median(times[2:])
        dev_ms, wall_ms, top = device_busy_share(run, 3)
        checked = "the CPU run" + (" and the numpy oracle"
                                   if name in oracles else "")
        print(f"{name}: {len(rows)} rows, equal to {checked} ({cpu_s:.2f} s "
              f"on the CPU); K1 {counts['fused_scan_sum']}, K2 "
              f"{counts['monotone_gather']}, retries {retried}; median "
              f"{median:.3f} ms over {RUNS_WINDOWS} warm runs; profiled: "
              f"device kernels {dev_ms:.4f} ms of {wall_ms:.4f} ms wall, busy "
              f"share {dev_ms / wall_ms:.4f}  [{card}]")
        print(f"  top device kernels per query: {top}")
        for row in rows[:3]:
            print("   ", row)
        out.append({"query": name, "rows": len(rows), "retries": retried,
                    "median_ms": median, "device_ms": dev_ms,
                    "profiled_wall_ms": wall_ms})
    print(json.dumps({"windows_and_joins": out}))
    return {"launches": totals, "queries": out}


def dml_transactions_persistence(conn, card: str, prepared,
                                 q6_rows: list) -> dict:
    """DELETE / UPDATE inside a transaction on the card catalog, each query
    after them against the numpy oracle of the mutated columns (and the
    prepared Q6 of the executor-modes phase: pinned, it still gives
    `q6_rows` after the UPDATE; executed afresh, the new oracle), ROLLBACK,
    then a checkpoint of the whole catalog, a committed DELETE in the
    write-ahead log and `open_database` on the card.  Every query has the
    launches counted from just before it to just after.  The rows
    of each query are kept under "<step>/<query>" for the mesh's DML phase
    (`mesh_dml`), which runs the same statements, and the reopened
    connection is kept for its steps that go further.
    -> {"launches": {kernel: total}, "steps": [...], "rows": {...},
    "reopened": the reopened connection, ...}."""
    import shutil
    import tempfile

    from duckdb_cubit_tpu_torch.exec.result import to_strings

    from duckdb_cubit_tpu_torch.storage.persist import open_database

    cat = conn.catalog
    queries = {"Q6": Q6, "Q1": Q1, "Q12": Q12, "Q3": Q3}
    totals = {"fused_scan_sum": 0, "monotone_gather": 0}
    steps = []
    recorded = {}
    at = ["before"]

    def statement(sql):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        status = conn.sql(sql).status
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"  {status}: {' '.join(sql.split())[:90]} ({secs:.3f} s)  "
              f"[{card}]")
        steps.append({"sql": " ".join(sql.split()), "status": status,
                      "seconds": secs})
        return status

    def query(name, want=None, k1=None, k2_min=0, c=conn):
        rows, counts = counted(lambda: c.sql(queries[name]).strings())
        recorded[f"{at[0]}/{name}"] = rows
        against = "its numpy oracle" if want is None else "the rows"
        want = oracle_of(c.catalog, name) if want is None else want
        if not rows_agree(rows, want):
            raise AssertionError(f"{name} after DML disagrees: {rows[:3]} "
                                 f"vs {want[:3]}")
        if k1 is not None and counts["fused_scan_sum"] != k1:
            raise AssertionError(f"{name} launched K1 "
                                 f"{counts['fused_scan_sum']} times, "
                                 f"expected {k1}")
        if counts["monotone_gather"] < k2_min:
            raise AssertionError(f"{name} did not launch K2")
        for kernel in totals:
            totals[kernel] += counts[kernel]
        print(f"  {name}: {rows[0]}{' ...' if len(rows) > 1 else ''}, equal "
              f"to {against}; K1 "
              f"{counts['fused_scan_sum']}, K2 {counts['monotone_gather']}")
        return rows

    print("step 1: the rows before")
    base = {name: conn.sql(sql).strings() for name, sql in queries.items()}
    recorded.update({f"before/{name}": rows for name, rows in base.items()})
    sf = cat.table("lineitem").num_rows / 6_001_215
    print("step 2: BEGIN; UPDATE about 1% of lineitem")
    at[0] = "update_lineitem"
    statement("BEGIN")
    statement(f"UPDATE lineitem SET l_discount = l_discount + 0.01 WHERE "
              f"l_orderkey <= {int(60000 * sf)} AND l_discount < 0.10")
    query("Q6", k1=1)
    # the prepared query's launches count under the executor-modes phase
    # ("verification"), so this phase's own counts read as before
    pinned, counts = counted(lambda: to_strings(prepared.run_pinned()))
    fresh, fresh_counts = counted(lambda: to_strings(prepared.execute()))
    prepared_launches = {k: counts[k] + fresh_counts[k] for k in totals}
    if pinned != q6_rows or fresh != oracle_of(cat, "Q6") or fresh == pinned:
        raise AssertionError(f"prepared Q6 after the UPDATE: pinned {pinned} "
                             f"(want {q6_rows}), fresh {fresh}")
    print(f"  prepared Q6 pinned before the UPDATE: {pinned}, the rows of "
          f"step 1; executed afresh: {fresh}, the new oracle")
    print("step 3: UPDATE about 1% of orders on a value-lut column of Q3")
    at[0] = "update_orders"
    top = int(base["Q3"][0][0])
    statement(f"UPDATE orders SET o_shippriority = 1 WHERE o_orderkey "
              f"BETWEEN {top - int(30000 * sf)} AND {top + int(30000 * sf)}")
    rows = query("Q3", k2_min=1)
    if rows[0][0] != str(top) or rows[0][3] != "1":
        raise AssertionError(f"Q3's first row {rows[0]} does not show the "
                             f"updated o_shippriority of order {top}")
    print("step 4: DELETE about 1/7 of orders")
    at[0] = "delete_orders"
    statement("DELETE FROM orders WHERE o_orderdate < DATE '1993-01-01'")
    query("Q12", k2_min=1)
    query("Q3", k2_min=1)
    print("step 5: DELETE lineitem rows with l_quantity > 45")
    at[0] = "delete_lineitem"
    statement("DELETE FROM lineitem WHERE l_quantity > 45")
    query("Q1")
    query("Q6", k1=0)
    print("step 6: ROLLBACK")
    at[0] = "rollback"
    statement("ROLLBACK")
    for name in queries:
        query(name, want=base[name], k1=1 if name == "Q6" else None)
    print("step 7: checkpoint, then a committed DELETE in the log")
    path = tempfile.mkdtemp(prefix="chip_smoke_db_")
    try:
        conn.attach(path)
        t0 = time.perf_counter()
        conn.checkpoint()
        ckpt_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        print(f"  checkpoint of {len(cat.tables)} tables: {ckpt_s:.2f} s, "
              f"{disk} B on disk  [{card}]")
        at[0] = "after_log"
        statement("BEGIN")
        statement(f"DELETE FROM lineitem WHERE l_orderkey <= "
                  f"{int(60000 * sf)}")
        statement("COMMIT")
        with open(os.path.join(path, "wal.sql")) as f:
            logged = f.read().count(";\n")
        if logged != 1:
            raise AssertionError(f"the log holds {logged} statements")
        after = {name: query(name) for name in ("Q1", "Q6", "Q3")}
        print("step 8: open_database on the card")
        at[0] = "reopened"
        t0 = time.perf_counter()
        conn2 = open_database(path, device=conn.device)
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        print(f"  open_database (checkpoint + log replay): {open_s:.2f} s  "
              f"[{card}]")
        if not all(c.data.device.type == conn.device.type
                   for t in conn2.catalog.tables.values()
                   for c in t.columns.values()):
            raise AssertionError("the reopened catalog is not on the card")
        for name in ("Q1", "Q6", "Q3"):
            query(name, want=after[name], c=conn2)
    finally:
        conn.db_path = None
        shutil.rmtree(path, ignore_errors=True)
    print(f"DML, transactions and persistence: every step equals its oracle; "
          f"launches {totals}; checkpoint {ckpt_s:.2f} s, {disk} B; open "
          f"{open_s:.2f} s  [{card}]")
    out = {"steps": steps, "checkpoint_s": ckpt_s, "checkpoint_bytes": disk,
           "open_s": open_s}
    print(json.dumps({"dml": out}))
    return {"launches": totals, "prepared_launches": prepared_launches,
            "rows": recorded, "reopened": conn2, **out}


def verified(conn, sql: str) -> tuple:
    """`sql` through verification's legs, with the launches counted from
    just before each leg to just after.  -> (rows, [(leg, seconds,
    {kernel: launches})], whether the legs agreed exactly, DOUBLE cells
    included)."""
    ex = conn.executor
    counts = {}
    real = ex._leg

    def leg(name, run):
        before = PROF.snapshot()
        out = real(name, run)
        counts[name] = launches_since(before)
        return out
    ex._leg = leg
    try:
        rows = conn.sql(sql).strings()
    finally:
        del ex._leg
    legs = [(name, secs, counts.get(name, {})) for name, secs in
            ex.last_legs]
    return rows, legs, ex.legs_exact


def _launch_sum(counts: dict) -> dict:
    return {k: counts.get(k, 0) for k in ("fused_scan_sum",
                                          "monotone_gather")}


def corrupted_index_on_card(card: str):
    """The seeded CUBIT corruption of `tests/test_torch_verification.py`
    on a small card table: bin 3 of the index cleared, the optimized plan
    counts 0 rows, and verification must raise."""
    from duckdb_cubit_tpu_torch.api import Connection
    from duckdb_cubit_tpu_torch.index.cubit import CubitIndex
    from duckdb_cubit_tpu_torch.storage.table import Catalog, from_numpy

    data = {"k": np.arange(1, 201, dtype=np.int64),
            "v": (np.arange(200) % 10).astype(np.int64)}
    t = from_numpy("t", data, device="cuda")
    t.indexes["v"] = CubitIndex.build("v", data["v"].astype(np.int32),
                                      t.capacity, t.num_rows, 10,
                                      device="cuda")
    cat = Catalog()
    cat.register(t)
    small = Connection(cat)
    if small.sql("SELECT count(*) AS c FROM t WHERE v = 3").strings() != \
            [["20"]]:
        raise AssertionError("the small card table counts wrongly")
    words = t.indexes["v"].words.clone()
    words[3] = 0
    t.indexes["v"].words = words
    t.indexes["v"]._rebuild_cum()
    t.indexes["v"]._query_cache.clear()
    wrong = small.sql("SELECT count(*) AS c1 FROM t WHERE v = 3").strings()
    if wrong != [["0"]]:
        raise AssertionError(f"the corrupted index answered {wrong}")
    small.sql("SET enable_verification = true")
    try:
        small.sql("SELECT count(*) AS c2 FROM t WHERE v = 3").strings()
    except RuntimeError as e:
        if "verification failed" not in str(e):
            raise
        print(f"corrupted CUBIT index (bin 3 cleared) on the card: without "
              f"verification count {wrong}; with it: {e}  [{card}]")
        return
    raise AssertionError("verification did not catch the corrupted index")


def _profile_tree(node) -> tuple:
    return (node["name"], node["cardinality"],
            tuple(_profile_tree(c) for c in node["children"]))


def executor_modes(conn, cpu, card: str) -> dict:
    """Verification, EXPLAIN ANALYZE, prepared queries, the deadline, staged
    against whole plan, and out-of-core execution, on the main card
    connection; every setting it changes is restored.  -> {"launches":
    {"verification": {kernel: n}, "external": {kernel: n}}, "prepared":
    the prepared Q6, "q6_rows": its rows}."""
    from duckdb_cubit_tpu_torch.api import QueryTimeoutError
    from duckdb_cubit_tpu_torch.exec.result import to_strings
    from duckdb_cubit_tpu_torch.plan import optimizer as opt
    from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL

    cat = conn.catalog
    launches = {"verification": {"fused_scan_sum": 0, "monotone_gather": 0},
                "external": {"fused_scan_sum": 0, "monotone_gather": 0}}

    def add(path, counts):
        for k, v in _launch_sum(counts).items():
            launches[path][k] += v

    print("-- verification (SET enable_verification = true)")
    cases = [("Q6", Q6), ("Q1", Q1), ("Q12", Q12), ("Q3", Q3),
             ("SQL q3", SQL[3]), ("SQL q6", SQL[6]), ("SQL q12", SQL[12]),
             ("SQL q16", SQL[16]),
             ("supplier x nation", """
                SELECT n_name, count(*) AS c, sum(s_acctbal) AS b
                FROM supplier, nation WHERE s_nationkey = n_nationkey
                GROUP BY n_name ORDER BY n_name""")]
    out = []
    for name, sql in cases:
        plain, counts = counted(lambda: conn.sql(sql).strings())
        plain_counts = _launch_sum(counts)
        conn.sql("SET enable_verification = true")
        try:
            rows, legs, exact = verified(conn, sql)
        finally:
            conn.sql("SET enable_verification = false")
        if rows != plain:
            raise AssertionError(f"{name} verified {rows[:3]} differs from "
                                 f"its unverified run {plain[:3]}")
        by_leg = {leg: _launch_sum(c) for leg, _, c in legs}
        for leg in ("production", "eager"):
            if by_leg[leg] != plain_counts:
                raise AssertionError(f"{name}: leg {leg} launched "
                                     f"{by_leg[leg]}, the unverified run "
                                     f"{plain_counts}")
        if any(by_leg["unoptimized"].values()):
            raise AssertionError(f"{name}: leg 3 launched "
                                 f"{by_leg['unoptimized']}")
        for c in by_leg.values():
            add("verification", c)
        names = [leg for leg, _, _ in legs]
        if name == "supplier x nation" and names[-1] != "row-by-row":
            raise AssertionError(f"leg 4 did not run: {names}")
        print(f"{name}: {len(rows)} rows, equal to its unverified run; legs "
              + "; ".join(f"{leg} {secs * 1e3:.3f} ms (K1 "
                          f"{by_leg.get(leg, {}).get('fused_scan_sum', 0)}, "
                          f"K2 {by_leg.get(leg, {}).get('monotone_gather', 0)}"
                          ")" for leg, secs, _ in legs)
              + f"; legs exactly equal: {exact}  [{card}]")
        out.append({"query": name, "rows": len(rows), "exact": exact,
                    "legs": [{"leg": leg, "ms": secs * 1e3,
                              "launches": _launch_sum(c)}
                             for leg, secs, c in legs]})
    corrupted_index_on_card(card)

    print("-- EXPLAIN ANALYZE, against the CPU catalog's")
    for n in (3, 12):
        sql = "EXPLAIN ANALYZE " + SQL[n]
        before = PROF.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = conn.sql(sql).strings()
        wall_ms = (time.perf_counter() - t0) * 1e3
        add("verification", launches_since(before))
        card_json = json.loads(conn.executor.profiler.to_json(
            conn.executor.plan))
        cpu.sql(sql)
        cpu_json = json.loads(cpu.executor.profiler.to_json(
            cpu.executor.plan))
        if _profile_tree(card_json["plan"]) != _profile_tree(cpu_json["plan"]):
            raise AssertionError(f"EXPLAIN ANALYZE q{n}: the card's operator "
                                 f"rows differ from the CPU run's")
        root_ms = card_json["plan"]["time_ms"]
        if root_ms > wall_ms:
            raise AssertionError(f"q{n}: root {root_ms} ms > statement "
                                 f"{wall_ms} ms")
        print(f"EXPLAIN ANALYZE q{n} ({wall_ms:.3f} ms wall, root "
              f"{root_ms:.3f} ms; operator rows equal the CPU run's)  "
              f"[{card}]")
        print(text[-1][0])

    print("-- prepared queries")
    prepared = conn.prepare(Q6)
    q6_rows = to_strings(prepared.execute())
    if q6_rows != oracle_of(cat, "Q6"):
        raise AssertionError(f"prepared Q6 {q6_rows} differs from its oracle")
    before = PROF.snapshot()
    times = []
    for _ in range(RUNS + 2):
        t0 = time.perf_counter()
        to_strings(prepared.execute())
        times.append((time.perf_counter() - t0) * 1e3)
    add("verification", launches_since(before))
    sql_times = []
    for _ in range(RUNS + 2):
        t0 = time.perf_counter()
        conn.sql(Q6).strings()
        sql_times.append((time.perf_counter() - t0) * 1e3)
    prep_ms, sql_ms = (statistics.median(times[2:]),
                       statistics.median(sql_times[2:]))
    print(f"prepared Q6 {q6_rows}, equal to its oracle: median {prep_ms:.3f} "
          f"ms over {RUNS} executes, conn.sql(Q6) {sql_ms:.3f} ms  [{card}]")

    print(f"-- the deadline (SET query_timeout_s = {DEADLINE_S})")
    conn.sql(f"SET query_timeout_s = {DEADLINE_S}")
    t0 = time.perf_counter()
    before = PROF.snapshot()
    try:
        conn.sql(SQL[13]).strings()
    except QueryTimeoutError as e:
        cut_s = time.perf_counter() - t0
        print(f"SQL q13 abandoned after {cut_s:.3f} s: {e}  [{card}]")
    else:
        raise AssertionError(f"q13 finished inside a {DEADLINE_S} s "
                             f"deadline")
    finally:
        conn.sql("SET query_timeout_s = 0")
    add("verification", launches_since(before))
    rows, counts = counted(lambda: conn.sql(Q6).strings(), "fused_scan_sum")
    add("verification", counts)
    if rows != oracle_of(cat, "Q6"):
        raise AssertionError("Q6 after the deadline differs from its oracle")
    print(f"then, the deadline off: Q6 {rows}, equal to its oracle")

    print("-- out of core (SET force_external = true, decode off)")
    ex = conn.executor
    ext = {}

    def external(name, sql, want):
        p0, s0 = ex.external_passes, ex.external_chunks_skipped
        rows, counts = counted(lambda: conn.sql(sql).strings())
        passes = ex.external_passes - p0
        skipped = ex.external_chunks_skipped - s0
        add("external", counts)
        if not rows_agree(rows, want):
            raise AssertionError(f"{name} out of core {rows[:3]} differs "
                                 f"from its oracle {want[:3]}")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            conn.sql(sql).strings()
            times.append((time.perf_counter() - t0) * 1e3)
        ext[name] = {"passes": passes, "skipped": skipped,
                     "median_ms": statistics.median(times[2:]),
                     "launches": _launch_sum(counts)}
        print(f"{name}: equal to its oracle; passes {passes}, chunks "
              f"skipped {skipped}, K1 {counts['fused_scan_sum']}, K2 "
              f"{counts['monotone_gather']}; median "
              f"{ext[name]['median_ms']:.3f} ms over 3 warm runs  [{card}]")
        return passes, counts

    saved = {k: getattr(conn.config, k) for k in (
        "force_external", "memory_limit", "index_scan_max_count",
        "index_scan_percentage")}
    try:
        conn.sql("SET index_scan_max_count = 0")
        conn.sql("SET index_scan_percentage = 0.0")
        conn.sql("SET force_external = true")
        for name in ("Q1", "Q6"):
            passes, counts = external(f"{name} forced external",
                                      {"Q1": Q1, "Q6": Q6}[name],
                                      oracle_of(cat, name))
            if passes < 4:
                raise AssertionError(f"{name} ran {passes} passes")
            if name == "Q6" and counts["fused_scan_sum"]:
                raise AssertionError("K1 launched in a chunked pass")
        passes, _ = external("Q12 forced external", Q12,
                             oracle_of(cat, "Q12"))
        print(f"Q12's aggregate stage (the join fused into it) "
              f"{'chunked into ' + str(passes) + ' passes' if passes else 'ran in one pass'}")
        conn.sql("SET force_external = false")
        conn.sql(f"SET memory_limit = {256 << 20}")
        plan = opt.optimize(conn.binder.bind_sql(Q1), cat)
        ex._prepare(plan)
        scan = next(op for op in plan.walk() if op.name == "table_scan")
        est = ex.working_set(scan, 0)
        want_passes = ex.chunk_count(scan, 0) or 0
        passes, _ = external("Q1 under memory_limit = 256 MiB", Q1,
                             oracle_of(cat, "Q1"))
        print(f"Q1's stage estimate {est} B against 268435456 B: "
              f"_chunk_plan predicts {want_passes} passes, ran {passes}")
        if passes != want_passes:
            raise AssertionError(f"Q1 ran {passes} passes, _chunk_plan "
                                 f"predicts {want_passes}")
    finally:
        for k, v in saved.items():
            setattr(conn.config, k, v)
    result = {"verification": out, "prepared_ms": prep_ms, "sql_ms": sql_ms,
              "external": ext}
    print(json.dumps({"executor_modes": result}))
    return {"launches": launches, "prepared": prepared, "q6_rows": q6_rows}


def staged_against_whole_plan(conn, texts: dict, card: str) -> dict:
    """The four SQL queries and the 22 SQL texts on both paths, the whole
    plan (`staged_execution = false`) held against the staged rows; three
    rounds of one staged and one whole-plan run, interleaved so that both
    medians see the same host; each query's compacted boundaries."""
    from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL

    cat = conn.catalog
    cases = [(name, sql, oracle_of(cat, name), None)
             for name, sql in (("Q6", Q6), ("Q1", Q1), ("Q12", Q12),
                               ("Q3", Q3))]
    cases += [(f"SQL q{n}", SQL[n], *texts["rows"][n]) for n in sorted(SQL)]

    def run(sql, staged):
        conn.config.staged_execution = staged
        t0 = time.perf_counter()
        rows = conn.sql(sql).strings()
        return rows, (time.perf_counter() - t0) * 1e3

    out, total = [], {"staged": 0.0, "whole": 0.0}
    try:
        for name, sql, want, doubles in cases:
            ex = conn.executor
            b0 = ex.compacted_boundaries
            rows, _ = run(sql, True)
            compacted = ex.compacted_boundaries - b0
            whole_rows, _ = run(sql, False)
            for label, got in (("staged", rows), ("whole plan", whole_rows)):
                ok = rows_agree(got, want) if doubles is None else \
                    cells_agree(got, want, doubles)
                if not ok:
                    raise AssertionError(f"{name} {label} {got[:3]} differs "
                                         f"from {want[:3]}")
            times = {True: [], False: []}
            for _ in range(3):
                for staged in (True, False):
                    times[staged].append(run(sql, staged)[1])
            s_ms, w_ms = (statistics.median(times[True]),
                          statistics.median(times[False]))
            total["staged"] += s_ms
            total["whole"] += w_ms
            out.append({"query": name, "staged_ms": s_ms, "whole_ms": w_ms,
                        "compacted": compacted})
            print(f"{name}: staged and whole plan equal; median staged "
                  f"{s_ms:.3f} ms ({compacted} compacted boundaries), whole "
                  f"plan {w_ms:.3f} ms  [{card}]")
    finally:
        conn.config.staged_execution = True
    print(f"staged medians sum to {total['staged']:.3f} ms, whole plan "
          f"{total['whole']:.3f} ms (4 queries and 22 texts)  [{card}]")
    print(json.dumps({"staged_vs_whole": out}))
    return {"queries": out, "total": total}


@functools.lru_cache(maxsize=None)
def cuda_kernels() -> tuple:
    """Every hand-written kernel: each module of `ops/` imported, so each
    wrapper has made its `CudaKernel`."""
    import importlib
    import pkgutil

    from duckdb_cubit_tpu_torch import ops
    from duckdb_cubit_tpu_torch.ops import cuda_build

    for m in pkgutil.iter_modules(ops.__path__):
        importlib.import_module(f"{ops.__name__}.{m.name}")
    return tuple(cuda_build.KERNELS)


def launches_since(before: dict) -> dict:
    """Launches by kernel (its source's stem) since the profiler's counter
    table read `before` (`PROF.snapshot()`)."""
    torch.cuda.synchronize()
    now = PROF.snapshot()
    return {k.stem: now[k.counter] - before.get(k.counter, 0)
            for k in cuda_kernels()}


def build_kernels():
    """Every kernel, one nvcc each, started together."""
    kernels = {k.stem: k for k in cuda_kernels()}

    def build(item):
        t0 = time.perf_counter()
        item[1].build()
        return item[0], time.perf_counter() - t0

    with ThreadPoolExecutor(len(kernels)) as pool:
        for name, secs in pool.map(build, kernels.items()):
            print(f"{name} built in {secs:.2f} s")
            for line in kernels[name].build_log.splitlines():
                if "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip())


def kernel_tests():
    """Every kernel against its plain torch body on the card, bit for bit:
    the `cuda` cases of the kernel test files (`KERNEL_TESTS`), run by
    pytest without the repo's conftest (which imports jax); raises when a
    case fails or skips, or none ran."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", "-m", "cuda", *KERNEL_TESTS],
        capture_output=True, text=True)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
        else ""
    print(f"pytest -m cuda {' '.join(KERNEL_TESTS)}: {tail}")
    if proc.returncode != 0 or " passed" not in tail or "skipped" in tail:
        print(proc.stdout[-20000:], proc.stderr[-4000:], sep="\n")
        raise AssertionError(f"the kernel tests failed (exit "
                             f"{proc.returncode})")


def k5_fixed_cost(device, card) -> tuple[dict, dict]:
    """K5a on 128 indices and K5b on one row, L2 flushed: the launch, the
    table copy and the finish, so gather_probe's time splits into that
    fixed cost and streaming; and each at gather_probe's shapes after a
    flush that leaves the L2 clean.  -> ({name: fixed ms}, {name: clean-L2
    ms})."""
    from duckdb_cubit_tpu_torch.benchmarks import gather_probe
    from duckdb_cubit_tpu_torch.ops import gather_forms as gf

    idx, table, li2 = gather_probe.inputs(gather_probe.N, gather_probe.T,
                                          device)
    tab2 = table.reshape(-1, gf.LANES)
    flush = flush_buffer(device)
    fixed = {"table_gather": time_cold(
                 lambda: gf.table_gather(table, idx[:128]), 30, flush),
             "lane_gather": time_cold(
                 lambda: gf.lane_gather(tab2, li2[:1]), 30, flush)}
    clean = {"table_gather": time_cold(
                 lambda: gf.table_gather(table, idx), 30, flush, True),
             "lane_gather": time_cold(
                 lambda: gf.lane_gather(tab2, li2), 30, flush, True)}
    # the floor of this reading: one torch kernel on one element
    one = torch.zeros(1, device=device)
    floor = time_cold(lambda: one.add_(1), 30, flush)
    for name, label in (("table_gather", "K5a on 128 indices"),
                        ("lane_gather", "K5b on one 128-wide row")):
        print(f"{label} {fixed[name]:.4f} ms (L2 flushed: launch, the "
              f"{4 * gather_probe.T} B table copy, the finish; one torch "
              f"kernel on one element reads {floor:.4f} ms); at N="
              f"{gather_probe.N} after a flush that leaves the L2 clean "
              f"{clean[name]:.4f} ms  [{card}]")
    return fixed, clean


def k3k4_fixed_cost(catalog, device, summary, times, card) -> tuple:
    """K3 on all-zero words and K4 on an all-zero mask at q6bench's n, L2
    flushed: the launch, the selector pass and the finish without any
    payload.  Prints each beside the kernel's time at variant 0, so that
    time splits into that fixed cost and payload streaming, and beside its
    time at variant 0 after a flush that leaves the L2 clean (the standard
    flush leaves it dirty, and a call that evicts those lines writes them
    back); -> ({name: fixed ms}, {name: clean-L2 ms})."""
    from duckdb_cubit_tpu_torch.benchmarks import q6bench
    from duckdb_cubit_tpu_torch.ops import q6_variants as qv

    ep, di = q6bench.payloads(catalog, device)
    n = ep.shape[0]
    words, masks = q6bench.variants(n, 1, device)   # variant 0
    zero_words = torch.zeros(n // 32, dtype=torch.int32, device=device)
    zero_mask = torch.zeros(n, dtype=torch.int8, device=device)
    flush = flush_buffer(device)
    fixed = {"q6_words_i32": time_cold(
                 lambda: qv.q6_words_i32(zero_words, ep, di), 30, flush),
             "q6_mask8_i32": time_cold(
                 lambda: qv.q6_mask8_i32(zero_mask, ep, di), 30, flush)}
    clean = {"q6_words_i32": time_cold(
                 lambda: qv.q6_words_i32(words[0], ep, di), 30, flush, True),
             "q6_mask8_i32": time_cold(
                 lambda: qv.q6_mask8_i32(masks[0], ep, di), 30, flush, True)}
    selector = {"q6_words_i32": 4 * (n // 32), "q6_mask8_i32": n}
    for name, label in (("q6_words_i32", "K3 on all-zero words"),
                        ("q6_mask8_i32", "K4 on an all-zero mask")):
        ms, f = times[name][0], fixed[name]
        payload = summary["bytes"][name] - selector[name] - 8
        print(f"{label} {f:.4f} ms (L2 flushed; launch, the "
              f"{selector[name]} B selector pass, the finish) against {ms:.4f} ms at "
              f"variant 0: the {payload} B of payload sectors take the other "
              f"{ms - f:.4f} ms, {payload / max(ms - f, 1e-9) / 1e6:.1f} "
              f"GB/s; at variant 0 after a flush that leaves the L2 clean "
              f"{clean[name]:.4f} ms  [{card}]")
    return fixed, clean


def k6_after_insert(conn, card: str):
    """The stale case on the card: inside a transaction, an INSERT of one
    order whose o_comment is new merges it into the dictionary, and LIKE
    must find the row (over a fresh device copy of the new dictionary);
    after ROLLBACK the old dictionary, and its copy, are back, and LIKE must
    not find it.  Each count launches K6 once."""
    count = ("SELECT count(*) AS n FROM orders "
             "WHERE o_comment LIKE '%zzyzx%requests%'")

    def dictionary():
        return conn.catalog.table("orders").columns["o_comment"].dictionary

    before = dictionary()
    key = int(conn.sql("SELECT max(o_orderkey) AS k FROM orders")
              .strings()[0][0]) + 1
    got = {}
    for step, sql in (("before", None), ("BEGIN", "BEGIN"),
                      ("INSERT", f"INSERT INTO orders VALUES ({key}, 1, 'O', "
                                 f"1.00, DATE '1998-08-02', '1-URGENT', "
                                 f"'Clerk#000000001', 0, "
                                 f"'quick zzyzx requests')"),
                      ("ROLLBACK", "ROLLBACK")):
        if sql is not None:
            conn.sql(sql)
        if step == "BEGIN":
            continue
        rows, counts = counted(lambda: conn.sql(count).strings(), "dict_like")
        got[step] = rows[0][0], counts["dict_like"], dictionary() is before
    want = {"before": ("0", 1, True), "INSERT": ("1", 1, False),
            "ROLLBACK": ("0", 1, True)}
    if got != want:
        raise AssertionError(f"LIKE around an INSERT and ROLLBACK: {got}, "
                             f"expected {want}")
    print(f"  K6 after an INSERT of a new o_comment: the row found (a new "
          f"dictionary), and not after ROLLBACK (the old one): {got}  "
          f"[{card}]")


def k6_timing(cat, device, flush, card) -> tuple[float, float, float]:
    """K6 on q13's input (o_comment LIKE '%special%requests%') and q09's
    (p_name LIKE '%green%') beside the plain body, L2 flushed, each with
    its bound, and the host regex walk it replaced (one run, at q13's
    input).  -> (K6 ms, plain ms, bound ms) at q13's input."""
    import re

    from duckdb_cubit_tpu_torch.ops import dict_like as dl
    from duckdb_cubit_tpu_torch.ops.expressions import like_to_regex

    out = {}
    for label, table, column, pattern in (
            ("q13 o_comment", "orders", "o_comment", "%special%requests%"),
            ("q09 p_name", "part", "p_name", "%green%")):
        d = cat.table(table).columns[column].dictionary
        ent = dl.dictionary_bytes(d, device)
        pat = dl.compile_pattern(pattern)
        n, w = ent.shape
        print(f"K6 at {label} LIKE {pattern!r} (n={n}, w={w}):")
        ms, plain_ms = turns(lambda: dl.like_table(ent, pattern),
                             lambda: dl.like_table_reference(ent, pat),
                             flush, card)
        bound = bound_ms(dl.like_bytes(n, w))
        print(f"K6 {ms:.4f} ms vs plain {plain_ms:.4f} ms at {label} (L2 "
              f"flushed); bound {bound:.4f} ms ({dl.like_bytes(n, w)} B), "
              f"{bound / ms:.3f} of it  [{card}]")
        out[label] = ms, plain_ms, bound
        if label.startswith("q13"):
            rx = re.compile(like_to_regex(pattern).encode())
            t0 = time.perf_counter()
            want = np.fromiter((rx.match(s) is not None for s in d),
                               count=len(d), dtype=np.bool_)
            walk_ms = (time.perf_counter() - t0) * 1e3
            if not np.array_equal(want, dl.like_table(ent, pattern).cpu()
                                  .numpy()):
                raise AssertionError("K6 disagrees with the regex walk at "
                                     "q13's input")
            print(f"the host regex walk it replaced: {walk_ms:.1f} ms at "
                  f"{label}, equal to K6's table  [{card}]")
    return out["q13 o_comment"]


def k7_mask(n: int, density, seed: int, device) -> torch.Tensor:
    """A seeded mask of n rows on the card: each row set with probability
    `density`, or (`"last"`) only the last row."""
    if density == "last":
        mask = torch.zeros(n, dtype=torch.bool, device=device)
        mask[-1] = True
        return mask
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(n, generator=gen, device=device) < density


def k7_timing(device, flush, card) -> dict:
    """K7 at each of `K7_SHAPES` beside the plain sort, L2 flushed, with
    its bound (`compact.compact_bytes` at 3.35 TB/s) and torch.nonzero, the
    library call that computes the same ids (it waits for the host to size
    its output; the port never calls it).  -> {label: (K7 ms, plain ms,
    bound ms, nonzero ms)}."""
    from duckdb_cubit_tpu_torch.ops import compact

    out = {}
    for i, (label, n, density, cap) in enumerate(K7_SHAPES):
        mask = k7_mask(n, density, 200 + i, device)
        print(f"K7 at {label} (n={n}, density {density}, cap={cap}):")
        ms, plain_ms = turns(lambda: compact.mask_to_indices(mask, cap),
                             lambda: compact.mask_to_indices_reference(
                                 mask, cap), flush, card)
        nbytes = compact.compact_bytes(n, cap)
        bound = bound_ms(nbytes)
        nonzero_ms = time_cold(lambda: torch.nonzero(mask), 30, flush)
        print(f"K7 {ms:.4f} ms vs plain sort {plain_ms:.4f} ms and "
              f"torch.nonzero {nonzero_ms:.4f} ms at {label} (L2 flushed); "
              f"bound {bound:.4f} ms ({nbytes} B), {bound / ms:.3f} of it  "
              f"[{card}]")
        out[label] = ms, plain_ms, bound, nonzero_ms
        del mask
    return out


def k8_inputs(n: int, slots: int, rows: int, n_vals: int, live: float,
              seed: int, device):
    """A key-to-row table of `rows` keys over `slots` slots from key 1
    (every slot filled when they are equal, else `rows` sorted keys spread
    over them, as the date table's), a `live` share of its rows live,
    `n_vals` value columns, and n probe keys drawn from the table's keys,
    every probe row masked in (a pass's first join).  -> (index, build
    mask, value luts, keys, mask), on the card."""
    from duckdb_cubit_tpu_torch.index.pk import DirectPKIndex

    rng = np.random.default_rng(seed)
    keys = 1 + (np.arange(slots) if rows == slots else np.sort(
        rng.choice(slots, rows, replace=False)))
    keys[-1] = slots
    idx = DirectPKIndex.build("k", keys, rows, device=device)
    bmask = torch.as_tensor(rng.random(rows) < live, device=device)
    vluts = [idx.device_value_lut(f"v{j}", rng.integers(
        0, 2**31 - 1, rows, dtype=np.int32)) for j in range(n_vals)]
    gen = torch.Generator(device=device).manual_seed(seed)
    table_keys = torch.as_tensor(keys.astype(np.int32), device=device)
    probe = table_keys[torch.randint(0, rows, (n,), generator=gen,
                                     device=device)]
    mask = torch.ones(n, dtype=torch.bool, device=device)
    return idx, bmask, vluts, probe, mask


def k8_timing(device, flush, card) -> dict:
    """K8 at each of `K8_SHAPES` beside its plain body, the `gather` route
    it replaced on SSB's joins (`DirectPKIndex.probe`, then a clamp and
    one row gather a build column), L2 flushed, with its bound
    (`pk_probe.probe_bytes` at 3.35 TB/s) and a bare `lut[keys]` over the
    slots, the library call.  -> {label: (K8 ms, plain ms, bound ms,
    lut[keys] ms, gather-route ms)}."""
    from duckdb_cubit_tpu_torch.ops import pk_probe as K8

    out = {}
    for i, (label, n, slots, rows, n_vals, live) in enumerate(K8_SHAPES):
        idx, bmask, vluts, keys, mask = k8_inputs(n, slots, rows, n_vals,
                                                  live, 300 + i, device)
        lut = K8.live_lut(idx.lut, bmask)
        cols = [torch.randint(0, 2**31 - 1, (rows,), device=device,
                              dtype=torch.int32) for _ in range(n_vals)]

        def gather_route():
            row, found = idx.probe(keys, mask, bmask)
            safe = torch.clamp(row, 0, rows - 1)
            return found, [c[safe] for c in cols]

        print(f"K8 at {label} (n={n}, {slots} slots, {rows} rows, "
              f"{live:.3f} live):")
        ms, plain_ms = turns(
            lambda: K8.pk_probe(lut, idx.base, keys, mask, vluts),
            lambda: K8.pk_probe_reference(lut, idx.base, keys, mask, vluts),
            flush, card)
        nbytes = K8.probe_bytes(keys, mask, [4] * n_vals)
        bound = bound_ms(nbytes)
        slots_of = (keys - idx.base).contiguous()
        lib_ms = time_cold(lambda: lut[slots_of], 30, flush)
        route_ms = time_cold(gather_route, 30, flush)
        print(f"K8 {ms:.4f} ms vs plain body {plain_ms:.4f} ms, the gather "
              f"route {route_ms:.4f} ms and lut[keys] {lib_ms:.4f} ms at "
              f"{label} (L2 flushed); bound {bound:.4f} ms ({nbytes} B), "
              f"{bound / ms:.3f} of it  [{card}]")
        out[label] = ms, plain_ms, bound, lib_ms, route_ms
        del idx, bmask, vluts, keys, mask, lut, cols, slots_of
    return out


def k7_on_root(conn, sql: str, want: int, label: str):
    """One run of `sql` under torch.profiler: its `db.sql` root's
    `k7_launches` must equal the wrapper's count, `want`."""
    from torch.profiler import ProfilerActivity, profile

    PROF.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            conn.sql(sql).strings()
        roots = [s[5] for s in PROF.spans() if s[0] == "db.sql"]
    finally:
        PROF.reset()
    got = [r["k7_launches"] for r in roots]
    if got != [want] or want < 1:
        raise AssertionError(f"{label}: k7_launches on the root {got}, the "
                             f"wrapper counted {want}")
    print(f"{label}: k7_launches on its db.sql root {got[0]}, as the "
          f"wrapper counted")


def counted(run, *must_launch):
    """`run()` with the launches counted from just before it to just after;
    raises unless each kernel named in `must_launch` launched.  -> (run's
    result, launches by kernel name)."""
    before = PROF.snapshot()
    result = run()
    counts = launches_since(before)
    for name in must_launch:
        if counts[name] < 1:
            raise AssertionError(f"{name} did not launch: {counts}")
    return result, counts


def pk_probe_profile(conn, sql: str) -> tuple[float, float]:
    """Device ms per call of the first `HashJoin._pk_probe` of a query that
    launches K2, from torch.profiler, split into (K2's own kernel, the rest:
    the key widening and clamp, the liveness scatter and the lut-sized
    where)."""
    from duckdb_cubit_tpu_torch.plan.physical import HashJoin

    seen = []
    real = HashJoin._pk_probe

    def recording(self, *args, **kwargs):
        before = PROF.read("k2_launches")
        result = real(self, *args, **kwargs)
        if PROF.read("k2_launches") > before and not seen:
            seen.append((self, args, kwargs))
        return result
    HashJoin._pk_probe = recording
    try:
        conn.sql(sql).strings()
    finally:
        HashJoin._pk_probe = real
    join, args, kwargs = seen[0]
    kernels, _ = device_kernel_times(lambda: real(join, *args, **kwargs),
                                     RUNS)
    k2 = sum(ms for name, ms in kernels.items() if "monotone_gather" in name)
    return k2, sum(kernels.values()) - k2


def median_wall_ms(fn, device, runs: int = RUNS_MESH) -> float:
    """Median host ms of `fn` over warm calls, each ended by a synchronize
    (the requota reads a scalar per round, so device time alone would miss
    its waits)."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mesh_steps(conn, q6_revenue: str, card: str,
               backend: str = "nccl") -> dict:
    """The mesh layer's steps on a one-rank process group over the loaded
    catalog, each equal to its single-device counterpart and oracle: Q6's
    step over the three predicate words of Q6's CUBIT indexes, the grouped
    step over Q1's (l_returnflag, l_linestatus) code and l_quantity, the
    partitioned and pipelined joins of l_orderkey against o_orderkey
    (sum of l_quantity * o_custkey), and the requota on l_orderkey from a
    quarter of the rows.  There is one card and NCCL puts no two ranks on
    one device, so this shows the collectives run and agree; it claims no
    scaling.  -> {step: (ms, single-device ms or None)}."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from duckdb_cubit_tpu_torch.exec.result import format_decimal
    from duckdb_cubit_tpu_torch.ops import bitmap as bm
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs
    from duckdb_cubit_tpu_torch.ops import join as join_ops
    from duckdb_cubit_tpu_torch.ops import kernels
    from duckdb_cubit_tpu_torch.parallel import distributed as D
    from duckdb_cubit_tpu_torch.parallel import exchange as E
    from duckdb_cubit_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from duckdb_cubit_tpu_torch.types import date_to_days

    device = conn.device
    li, od = conn.catalog.table("lineitem"), conn.catalog.table("orders")
    cap, n, n_o = li.capacity, li.num_rows, od.num_rows
    if li.deleted is not None or od.deleted is not None:
        raise AssertionError("the mesh phase expects no deleted rows")
    times = {}
    tmp = tempfile.mkdtemp(prefix="mesh-")
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, backend=backend, device=device)
        print(f"mesh: {mesh.size} rank, backend "
              f"{dist.get_backend(mesh.group)}, device {mesh.device}")

        def col(table, name, rows):
            return shard_rows(table.columns[name].data[:rows].to(torch.int64),
                              mesh)

        # Q6: the three index words, their AND the main path's words
        words, payloads, packed = q6_kernel_inputs(conn)
        # Q6's predicate as CUBIT ranges (inclusive; exact on bin edges)
        q6_ranges = {"l_shipdate": (date_to_days("1994-01-01"),
                                    date_to_days("1994-12-31")),
                     "l_discount": (5, 7), "l_quantity": (None, 2399)}
        ranges = [li.indexes[c].query_range(lo, hi)
                  for c, (lo, hi) in q6_ranges.items()]
        if not all(r.exact for r in ranges):
            raise AssertionError("Q6's index ranges are not exact")
        w3 = [shard_rows(r.words, mesh) for r in ranges]
        if not torch.equal(w3[0] & w3[1] & w3[2], words):
            raise AssertionError("Q6's three index words do not AND to the "
                                 "main path's words")
        eprice, disc = (col(li, c, cap)
                        for c in ("l_extendedprice", "l_discount"))
        valid = shard_rows(torch.arange(cap, device=device) < n, mesh)
        q6 = D.make_q6_step(mesh)
        hi, lo = q6(*w3, eprice, disc, valid)
        got = kernels.combine_hi_lo(hi, lo)
        want_hi, want_lo = kernels.masked_sum_exact(
            eprice * disc, bm.expand(words, cap) & valid)
        k1 = int(fs.fused_scan_sum(words, payloads, packed))
        print(f"Q6 step: {format_decimal(got, 4)} (phase 4: {q6_revenue}); "
              f"masked_sum_exact ({int(want_hi)}, {int(want_lo)}), step "
              f"({int(hi)}, {int(lo)}); K1 {k1}")
        if (format_decimal(got, 4) != q6_revenue or k1 != got
                or (int(hi), int(lo)) != (int(want_hi), int(want_lo))):
            raise AssertionError("the Q6 step disagrees")
        times["q6"] = (median_wall_ms(lambda: q6(*w3, eprice, disc, valid),
                                      device),
                       median_wall_ms(lambda: fs.fused_scan_sum(
                           words, payloads, packed), device))

        # Q1's dense group code over the live rows
        live = torch.ones(n, dtype=torch.bool, device=device)
        rf_vals, rf = torch.unique(col(li, "l_returnflag", n),
                                   return_inverse=True)
        ls_vals, ls = torch.unique(col(li, "l_linestatus", n),
                                   return_inverse=True)
        groups = rf_vals.shape[0] * ls_vals.shape[0]
        codes = rf * ls_vals.shape[0] + ls
        qty = col(li, "l_quantity", n)
        grouped = D.make_grouped_agg_step(mesh, groups)
        got = grouped(codes, qty, live)
        want = (*kernels.group_sum_exact(codes, qty, live, groups),
                kernels.group_count(codes, live, groups))
        print(f"grouped step over {groups} groups: counts "
              f"{got[2].tolist()}, sums "
              f"{[kernels.combine_hi_lo(h, l) for h, l in zip(*got[:2])]}")
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("the grouped step disagrees with "
                                 "group_sum_exact / group_count")
        times["grouped"] = (
            median_wall_ms(lambda: grouped(codes, qty, live), device),
            median_wall_ms(lambda: kernels.group_sum_exact(
                codes, qty, live, groups), device))

        # the joins: lineitem (probe) against orders (build)
        bk, bv = col(od, "o_orderkey", n_o), col(od, "o_custkey", n_o)
        pk, pv = col(li, "l_orderkey", n), qty
        bvalid = torch.ones(n_o, dtype=torch.bool, device=device)
        host_li = live_columns(li, ["l_orderkey", "l_quantity"])
        host_od = live_columns(od, ["o_orderkey", "o_custkey"])
        row = _row_of(host_od["o_orderkey"], host_li["l_orderkey"])
        found = row >= 0
        oracle = int((host_li["l_quantity"][found]
                      * host_od["o_custkey"][row[found]]).sum())
        whole = D.make_partitioned_join_step(mesh, n_o, n)
        padded = -(-n // 4) * 4
        pad = torch.zeros(padded - n, dtype=torch.int64, device=device)
        pk4, pv4 = torch.cat([pk, pad]), torch.cat([pv, pad])
        pvalid4 = torch.arange(padded, device=device) < n
        pipe = D.make_pipelined_join_step(mesh, n_o, padded // 4, 4)
        results = {"partitioned join": whole(bk, bv, bvalid, pk, pv, live),
                   "pipelined join": pipe(bk, bv, bvalid, pk4, pv4, pvalid4)}
        for name, (total, ovf) in results.items():
            print(f"{name}: {int(total)} (numpy oracle {oracle}), overflow "
                  f"{int(ovf)}")
            if (int(total), int(ovf)) != (oracle, 0):
                raise AssertionError(f"the {name} disagrees")

        def local_join():
            bs = join_ops.build(bk, bvalid)
            return join_ops.probe(bs, pk, live)

        local_ms = median_wall_ms(local_join, device)
        times["partitioned join"] = (median_wall_ms(
            lambda: whole(bk, bv, bvalid, pk, pv, live), device), local_ms)
        times["pipelined join"] = (median_wall_ms(
            lambda: pipe(bk, bv, bvalid, pk4, pv4, pvalid4), device),
            local_ms)

        # the requota: a quarter of the rows, doubled twice
        start = -(-n // 4)
        ids = torch.arange(n, device=device)
        k2, v2, (p2,), quota, rounds = E.exchange_with_requota(
            mesh, pk, live, [ids], quota=start)
        print(f"requota on l_orderkey: quota {start} -> {quota} in {rounds} "
              f"rounds, {int(v2.sum())} rows out")
        if (rounds, quota) != (3, 4 * start):
            raise AssertionError("the requota took other rounds")
        if not (torch.equal(torch.sort(k2[v2]).values, torch.sort(pk).values)
                and torch.equal(pk[p2[v2]], k2[v2])):
            raise AssertionError("the requota lost or moved rows")
        times["requota"] = (median_wall_ms(lambda: E.exchange_with_requota(
            mesh, pk, live, [ids], quota=start), device), None)

        for step, (ms, local) in times.items():
            beside = "" if local is None else f", single device {local:.3f} ms"
            print(f"{step} step: median {ms:.3f} ms over {RUNS_MESH} warm "
                  f"runs{beside}  [{card}]")
        if device.type == "cuda":
            kernels_seen, _ = device_kernel_times(
                lambda: whole(bk, bv, bvalid, pk, pv, live), 1)
            print("collective kernels in the partitioned join: "
                  f"{sorted(k for k in kernels_seen if 'nccl' in k.lower())}")
        flag = torch.ones(8, dtype=torch.bool, device=mesh.device)
        out = torch.zeros_like(flag)
        try:
            dist.all_to_all_single(out, flag, group=mesh.group)
            verdict = f"accepted ({bool(out.all())})"
        except (RuntimeError, TypeError, ValueError) as e:
            verdict = f"refused ({e})"
        print(f"{backend} all_to_all_single on a bool tensor: {verdict}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return times


# the exchange's oracle query (the "mesh" phase's join: 1149209522195200 at
# SF1, where l_quantity is stored in hundredths)
EXCHANGE_SUM = ("SELECT sum(l_quantity * o_custkey) AS s FROM lineitem, "
                "orders WHERE l_orderkey = o_orderkey")
SKEW_SUM = ("SELECT sum(pv * bv) AS s, count(*) AS c FROM probe, build "
            "WHERE probe.k = build.k")
SKEW_ROWS = 2_000_000


def profiled_names(fn) -> set:
    """Every event name torch.profiler records over one call of `fn`, host
    ops and device kernels alike."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


def skew_tables() -> dict:
    """A probe side of SKEW_ROWS rows, half of its keys on one value, and a
    build side of 2,000 distinct keys."""
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2000, SKEW_ROWS)
    keys[: SKEW_ROWS // 2] = 7
    return {"probe": {"k": keys, "pv": rng.integers(0, 100, SKEW_ROWS)},
            "build": {"k": np.arange(2000, dtype=np.int64),
                      "bv": rng.integers(0, 100, 2000)}}


def mesh_engine(conn, texts: dict, sf: float, card: str,
                backend: str = "nccl") -> dict:
    """The engine sharded over a one-rank NCCL mesh on the card
    (`connect(sf, device="cuda", mesh=make_mesh(1))`, from a host load):
    Q6, Q1, Q12, Q3 and the 22 SQL texts, each counted (K2 must launch, K1
    must not: it declines on a mesh, as the reference's does) and equal to
    the single-device connection's rows with the same retries; then the
    radix-exchange join forced on (EXCHANGE_SUM against its numpy oracle,
    SQL q3 and q7 against their single-device rows, `nccl:all_to_all` in
    the profile), the skew requota on a registered pair of SKEW_ROWS probe
    rows, and the medians of the four queries and the 22 texts, mesh and
    single device interleaved.  One rank claims no scaling: it shows the
    mesh path's collectives, exchange and kernel launches on the card.
    -> {"launches": {kernel: launches on the counted runs}}."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from duckdb_cubit_tpu_torch.api import Connection
    from duckdb_cubit_tpu_torch.api import connect as connect_to
    from duckdb_cubit_tpu_torch.exec.result import format_decimal, to_strings
    from duckdb_cubit_tpu_torch.parallel.mesh import make_mesh
    from duckdb_cubit_tpu_torch.plan.physical import HashJoin
    from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL
    from duckdb_cubit_tpu_torch.types import TypeId

    device = conn.device
    tmp = tempfile.mkdtemp(prefix="mesh-engine-")
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, backend=backend, device=device)
        t0 = time.perf_counter()
        mconn = connect_to(sf, device=device, mesh=mesh)
        print(f"connect(sf={sf:g}, device={str(device)!r}, "
              f"mesh=make_mesh(1)) in "
              f"{time.perf_counter() - t0:.2f} s: placement "
              f"{mconn.catalog.placement}, mesh device {mesh.device}, "
              f"backend {dist.get_backend(mesh.group)}")
        for t in mconn.catalog.tables.values():
            tensors = [c.data for c in t.columns.values()]
            tensors += [ix.words for ix in t.indexes.values()]
            tensors += [ix.cum_words for ix in t.indexes.values()]
            tensors += [pk.lut for pk in t.pk_indexes.values()]
            where = sorted({str(x.device) for x in tensors if x is not None})
            print(f"  {t.name}: {'sharded' if t.sharded else 'replicated'}, "
                  f"block rows [{t.row_offset}, "
                  f"{t.row_offset + t.capacity}) of {t.global_capacity}, "
                  f"{t.num_rows} live; tensors on {where}")
            if not t.sharded or where != [str(mesh.device)]:
                raise AssertionError(f"{t.name} is not a row block on "
                                     f"{mesh.device}")

        def single_rows(sql):
            rel = conn.sql(sql).relation
            return to_strings(rel), [c.dtype.id == TypeId.DOUBLE
                                     for c in rel.columns.values()]

        def compare(name, sql, want, doubles, single_retries):
            before = mconn.executor.retry_count
            rows, counts = counted(lambda: mconn.sql(sql).strings())
            retries = mconn.executor.retry_count - before
            if not cells_agree(rows, want, doubles):
                raise AssertionError(f"{name} on the mesh disagrees with the "
                                     f"single device: {rows[:3]} vs "
                                     f"{want[:3]}")
            if retries != single_retries:
                raise AssertionError(f"{name} retried {retries} times on the "
                                     f"mesh, {single_retries} on one device")
            print(f"{name}: {len(rows)} rows equal to the single device's; "
                  f"K1 {counts['fused_scan_sum']}, K2 "
                  f"{counts['monotone_gather']}, retries {retries}")
            return counts

        launches = {"fused_scan_sum": 0, "monotone_gather": 0}
        named = [("Q6", Q6), ("Q1", Q1), ("Q12", Q12), ("Q3", Q3)]
        named += [(f"SQL q{n}", SQL[n]) for n in sorted(SQL)]
        for name, sql in named:
            before = conn.executor.retry_count
            want, doubles = single_rows(sql)
            counts = compare(name, sql, want, doubles,
                             conn.executor.retry_count - before)
            for k in launches:
                launches[k] += counts[k]
        if launches["fused_scan_sum"] != 0 or launches["monotone_gather"] < 1:
            raise AssertionError(f"mesh launches {launches}: K1 must not "
                                 f"launch, K2 must")
        print(f"the four queries and 22 texts on the mesh equal the single "
              f"device; launches {launches}")

        print("-- medians, mesh and single device interleaved "
              f"({RUNS_PLANS} warm runs each)")
        sums = {"mesh": 0.0, "single": 0.0}
        for name, sql in named:
            times = {"mesh": [], "single": []}
            runs = (("mesh", mconn), ("single", conn))
            for c in (mconn, conn):
                c.sql(sql).strings()
            for _ in range(RUNS_PLANS):
                for side, c in runs:
                    t1 = time.perf_counter()
                    c.sql(sql).strings()
                    times[side].append((time.perf_counter() - t1) * 1e3)
            med = {side: statistics.median(v) for side, v in times.items()}
            if name.startswith("SQL"):
                for side in sums:
                    sums[side] += med[side]
            else:
                print(f"{name}: mesh {med['mesh']:.3f} ms, single device "
                      f"{med['single']:.3f} ms  [{card}]")
        print(f"22 texts, sum of medians: mesh {sums['mesh']:.3f} ms, single "
              f"device {sums['single']:.3f} ms  [{card}]")

        # the radix exchange forced on every inner / left equi join
        mconn.config.explicit_exchange = True
        mconn.config.exchange_min_build_rows = 1
        li, od = conn.catalog.table("lineitem"), conn.catalog.table("orders")
        host_li = live_columns(li, ["l_orderkey", "l_quantity"])
        host_od = live_columns(od, ["o_orderkey", "o_custkey"])
        row = _row_of(host_od["o_orderkey"], host_li["l_orderkey"])
        found = row >= 0
        oracle = int((host_li["l_quantity"][found]
                      * host_od["o_custkey"][row[found]]).sum())
        res = mconn.sql(EXCHANGE_SUM)
        dt = next(iter(res.relation.columns.values())).dtype
        want = format_decimal(oracle, dt.scale) \
            if dt.id == TypeId.DECIMAL else str(oracle)
        got = res.strings()
        used = [j for j in mconn.executor.plan.walk()
                if isinstance(j, HashJoin)
                and getattr(j, "_exchange_used", False)]
        print(f"exchange join: {got} (numpy oracle {oracle} in storage "
              f"units, {want}); exchange used by {len(used)} join(s), "
              f"quotas {[(j._exq_probe, j._exq_build) for j in used]}")
        if got != [[want]] or not used:
            raise AssertionError("the exchange join disagrees or was not "
                                 "taken")
        if sf == 1.0 and oracle != 1149209522195200:
            raise AssertionError("the exchange oracle moved")
        names = profiled_names(lambda: mconn.sql(EXCHANGE_SUM).strings())
        nccl = sorted(n for n in names if "nccl" in n.lower())
        print(f"profiled exchange join: {nccl}")
        if not any("nccl:all_to_all" in n for n in nccl):
            raise AssertionError("no nccl:all_to_all in the exchange join")
        for q in (3, 7):
            want_rows, doubles = texts["rows"][q]
            got = mconn.sql(SQL[q]).strings()
            used = [j for j in mconn.executor.plan.walk()
                    if isinstance(j, HashJoin)
                    and getattr(j, "_exchange_used", False)]
            print(f"SQL q{q} with the exchange: {len(got)} rows, "
                  f"{len(used)} exchange join(s)")
            if not used or not cells_agree(got, want_rows, doubles):
                raise AssertionError(f"SQL q{q} with the exchange disagrees "
                                     f"or took none")

        # the skew requota: one rank owns every key, so a quota below the
        # fill (slack 0.5 of the block) must overflow and double
        tables = skew_tables()
        single = Connection(device=device)
        skewed = Connection(device=device, mesh=mesh)
        skewed.config.exchange_min_build_rows = 1
        skewed.config.exchange_quota_slack = 0.5
        for c in (single, skewed):
            for name, cols in tables.items():
                c.register_numpy(name, cols)
        want = single.sql(SKEW_SUM).strings()
        got = skewed.sql(SKEW_SUM).strings()
        j = next(j for j in skewed.executor.plan.walk()
                 if isinstance(j, HashJoin))
        print(f"skew requota ({SKEW_ROWS} probe rows, half on one key, "
              f"slack 0.5): {got} (single device {want}), retries "
              f"{skewed.executor.retry_count}, quotas probe "
              f"{j._exq_probe} / build {j._exq_build}")
        if got != want or skewed.executor.retry_count < 1 or \
                not getattr(j, "_exchange_used", False):
            raise AssertionError("the skew requota did not retry to the "
                                 "single device's rows")
        times = {"mesh": [], "single": []}
        for _ in range(RUNS_PLANS):
            for side, c in (("mesh", mconn), ("single", conn)):
                t1 = time.perf_counter()
                c.sql(EXCHANGE_SUM).strings()
                times[side].append((time.perf_counter() - t1) * 1e3)
        print(f"exchange join median {statistics.median(times['mesh']):.3f} "
              f"ms against the single device's PK join "
              f"{statistics.median(times['single']):.3f} ms  [{card}]")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches}


def lineitem_rows(table, n: int, key_shift: int) -> dict:
    """`n` rows for `dml.append_rows`, copied from the first rows of a
    lineitem table's host mirrors (strings decoded), their l_orderkey moved
    past every order: they join no order, and (l_orderkey, l_linenumber)
    stays unique."""
    rows = {}
    for name, col in table.columns.items():
        host = col.host[:n]
        rows[name] = col.dictionary[host] if col.dictionary is not None \
            else host.copy()
    rows["l_orderkey"] = rows["l_orderkey"].astype(np.int64) + key_shift
    return rows


# a few lineitem rows through SQL: Q1 and Q6 read them, no order joins them
# (a new l_comment re-encodes that column's dictionary)
INSERT_LINEITEM = ("INSERT INTO lineitem VALUES "
                   "(7000001, 1, 1, 1, 10, 12345.60, 0.06, 0.02, 'N', 'O', "
                   "'1994-06-01', '1994-06-15', '1994-06-20', "
                   "'DELIVER IN PERSON', 'MAIL', 'mesh smoke row one'), "
                   "(7000001, 2, 2, 2, 20, 23456.70, 0.05, 0.01, 'R', 'F', "
                   "'1994-09-09', '1994-09-19', '1994-09-29', 'NONE', 'SHIP', "
                   "'mesh smoke row two'), "
                   "(7000002, 3, 3, 1, 30, 34567.80, 0.07, 0.00, 'A', 'F', "
                   "'1995-02-02', '1995-02-12', '1995-02-22', "
                   "'TAKE BACK RETURN', 'AIR', 'mesh smoke row three')")


def mesh_dml(single: dict, sf: float, card: str, backend: str = "nccl",
             device="cuda") -> dict:
    """DML, transactions, persistence and the deadline on a one-rank NCCL
    mesh over the SF catalog on the card (`connect(sf, device="cuda",
    mesh=make_mesh(1))`, as the engine-on-a-mesh phase connects): the
    statements of the single-device DML phase in its order, each query's
    rows equal to that phase's rows after the same statement (`single`,
    from `dml_transactions_persistence`), K1 never launching and K2 in Q12
    and Q3 where that phase requires it; a checkpoint written by the mesh,
    a committed DELETE in its write-ahead log, and the reopen onto the mesh
    (`Connection(open_database(path, device="cpu").catalog, device=...,
    mesh=mesh)`).  Then, on the reopened mesh and on the single device's
    reopened connection side by side: an INSERT of three lineitem rows
    through SQL, a direct `append_rows` that grows lineitem past its
    capacity, and q13 under a 0.2 s deadline, which must raise, with Q6
    answering after it.  Each statement's time is printed beside the
    single device's, as are the checkpoint's seconds and bytes and the
    reopen's seconds.  One rank holds the whole table: the blocks' offsets,
    growth and re-blocking run on 8 gloo ranks in the CPU tests.
    -> {"launches": {kernel: launches on the counted queries}, ...}."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from duckdb_cubit_tpu_torch.api import Connection, QueryTimeoutError
    from duckdb_cubit_tpu_torch.api import connect as connect_to
    from duckdb_cubit_tpu_torch.exec.result import to_strings
    from duckdb_cubit_tpu_torch.parallel.mesh import make_mesh
    from duckdb_cubit_tpu_torch.storage import dml
    from duckdb_cubit_tpu_torch.storage.persist import open_database
    from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL
    from duckdb_cubit_tpu_torch.types import TypeId

    device = torch.device(device)
    queries = {"Q6": Q6, "Q1": Q1, "Q12": Q12, "Q3": Q3}
    launches = {"fused_scan_sum": 0, "monotone_gather": 0}
    single_steps = list(single["steps"])
    steps = []
    tmp = tempfile.mkdtemp(prefix="mesh-dml-")
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=0, world_size=1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def statement(c, sql):
        """A statement of the single-device phase, in its order."""
        status, secs = timed(lambda: c.sql(sql).status)
        want = single_steps[len(steps)]
        if " ".join(sql.split()) != want["sql"] or status != want["status"]:
            raise AssertionError(f"mesh {status!r} for {sql!r}, single "
                                 f"device {want['status']!r} for "
                                 f"{want['sql']!r}")
        print(f"  {status}: {' '.join(sql.split())[:70]}: mesh {secs:.3f} s, "
              f"single device {want['seconds']:.3f} s  [{card}]")
        steps.append({"sql": want["sql"], "status": status,
                      "mesh_s": secs, "single_s": want["seconds"]})

    def query(c, name, want, k2_min=0):
        rel, counts = counted(lambda: c.sql(queries[name]).relation)
        rows = to_strings(rel)
        doubles = [col.dtype.id == TypeId.DOUBLE
                   for col in rel.columns.values()]
        if not cells_agree(rows, want, doubles):
            raise AssertionError(f"{name} on the mesh disagrees with the "
                                 f"single device: {rows[:3]} vs {want[:3]}")
        if counts["fused_scan_sum"] != 0:
            raise AssertionError(f"{name} launched K1 on the mesh")
        if counts["monotone_gather"] < k2_min:
            raise AssertionError(f"{name} did not launch K2 on the mesh")
        for k in launches:
            launches[k] += counts[k]
        print(f"  {name}: {rows[0]}{' ...' if len(rows) > 1 else ''}, equal "
              f"to the single device's; K1 {counts['fused_scan_sum']}, K2 "
              f"{counts['monotone_gather']}")
        return rows

    def same(step, c, names, k2=()):
        for name in names:
            query(c, name, single["rows"][f"{step}/{name}"],
                  k2_min=1 if name in k2 else 0)

    def blocks_on_card(c):
        for t in c.catalog.tables.values():
            if not t.sharded or t.device != mesh.device:
                raise AssertionError(f"{t.name} is not a row block on "
                                     f"{mesh.device}")

    try:
        mesh = make_mesh(1, backend=backend, device=device)
        mconn, secs = timed(lambda: connect_to(sf, device=device, mesh=mesh))
        blocks_on_card(mconn)
        print(f"connect(sf={sf:g}, device='cuda', mesh=make_mesh(1)) in "
              f"{secs:.2f} s: every table a row block on {mesh.device}")
        cat = mconn.catalog
        scale = cat.table("lineitem").num_rows / 6_001_215
        print("step 1: the rows before")
        same("before", mconn, queries, k2=("Q12", "Q3"))
        print("step 2: BEGIN; UPDATE about 1% of lineitem")
        statement(mconn, "BEGIN")
        statement(mconn, f"UPDATE lineitem SET l_discount = l_discount + "
                         f"0.01 WHERE l_orderkey <= {int(60000 * scale)} "
                         f"AND l_discount < 0.10")
        same("update_lineitem", mconn, ["Q6"])
        print("step 3: UPDATE about 1% of orders on a value-lut column of "
              "Q3")
        top = int(single["rows"]["before/Q3"][0][0])
        statement(mconn, f"UPDATE orders SET o_shippriority = 1 WHERE "
                         f"o_orderkey BETWEEN {top - int(30000 * scale)} "
                         f"AND {top + int(30000 * scale)}")
        same("update_orders", mconn, ["Q3"], k2=("Q3",))
        print("step 4: DELETE about 1/7 of orders")
        statement(mconn, "DELETE FROM orders WHERE o_orderdate < "
                         "DATE '1993-01-01'")
        same("delete_orders", mconn, ["Q12", "Q3"], k2=("Q12", "Q3"))
        print("step 5: DELETE lineitem rows with l_quantity > 45")
        statement(mconn, "DELETE FROM lineitem WHERE l_quantity > 45")
        same("delete_lineitem", mconn, ["Q1", "Q6"])
        print("step 6: ROLLBACK")
        statement(mconn, "ROLLBACK")
        same("rollback", mconn, queries, k2=("Q12", "Q3"))
        print("step 7: checkpoint on the mesh, then a committed DELETE in "
              "the log")
        path = os.path.join(tmp, "db")
        mconn.attach(path)
        _, ckpt_s = timed(mconn.checkpoint)
        disk = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        print(f"  checkpoint of {len(cat.tables)} tables: mesh "
              f"{ckpt_s:.2f} s, {disk} B; single device "
              f"{single['checkpoint_s']:.2f} s, "
              f"{single['checkpoint_bytes']} B  [{card}]")
        statement(mconn, "BEGIN")
        statement(mconn, f"DELETE FROM lineitem WHERE l_orderkey <= "
                         f"{int(60000 * scale)}")
        statement(mconn, "COMMIT")
        with open(os.path.join(path, "wal.sql")) as f:
            logged = f.read().count(";\n")
        if logged != 1:
            raise AssertionError(f"the mesh's log holds {logged} statements")
        same("after_log", mconn, ["Q1", "Q6", "Q3"])
        print("step 8: open_database, then the catalog onto the mesh")
        del mconn, cat
        mconn, open_s = timed(lambda: Connection(
            open_database(path, device="cpu").catalog, device=device,
            mesh=mesh))
        blocks_on_card(mconn)
        print(f"  reopen onto the mesh: {open_s:.2f} s; open_database on "
              f"the card: {single['open_s']:.2f} s  [{card}]")
        same("reopened", mconn, ["Q1", "Q6", "Q3"], k2=("Q3",))

        # further than the single-device phase: the same statements on its
        # reopened connection, side by side
        other = single["reopened"]
        other.db_path = None    # its directory is gone with that phase
        both = (("mesh", mconn), ("single device", other))

        def side_by_side(label, run):
            secs = {}
            for side, c in both:
                _, secs[side] = timed(lambda: run(c))
            print(f"  {label}: mesh {secs['mesh']:.3f} s, single device "
                  f"{secs['single device']:.3f} s  [{card}]")
            steps.append({"sql": label, "mesh_s": secs["mesh"],
                          "single_s": secs["single device"]})

        def compare(names):
            for name in names:
                query(mconn, name, other.sql(queries[name]).strings())

        print("step 9: INSERT of three lineitem rows through SQL")
        side_by_side("INSERT 3 lineitem rows",
                     lambda c: c.sql(INSERT_LINEITEM))
        compare(["Q1", "Q6"])
        li = mconn.catalog.table("lineitem")
        capacity = li.global_capacity
        n_new = max(4096, capacity - li.num_rows + 1)
        print(f"step 10: append_rows of {n_new} lineitem rows, past the "
              f"capacity of {capacity}")
        rows = lineitem_rows(other.catalog.table("lineitem"), n_new,
                             10_000_000)
        side_by_side(f"append_rows {n_new} lineitem rows",
                     lambda c: dml.append_rows(
                         c.catalog.table("lineitem"), rows))
        grown = [c.catalog.table("lineitem").global_capacity
                 for _, c in both]
        if grown[0] != grown[1] or grown[0] <= capacity:
            raise AssertionError(f"lineitem's capacity after the append: "
                                 f"{grown}, before {capacity}")
        blocks_on_card(mconn)
        print(f"  lineitem capacity {capacity} -> {grown[0]} on both")
        compare(["Q1", "Q6", "Q12", "Q3"])
        print(f"step 11: q13 under a {DEADLINE_S} s deadline, then Q6")
        mconn.sql(f"SET query_timeout_s = {DEADLINE_S}")
        t0 = time.perf_counter()
        try:
            mconn.sql(SQL[13]).strings()
            raise AssertionError(f"q13 was not cut by the {DEADLINE_S} s "
                                 f"deadline")
        except QueryTimeoutError as e:
            cut = time.perf_counter() - t0
            print(f"  q13 cut on the mesh after {cut:.3f} s: {e}")
        finally:
            mconn.sql("SET query_timeout_s = 0")
        compare(["Q6"])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    if launches["monotone_gather"] < 1:
        raise AssertionError("K2 never launched in the mesh's DML phase")
    out = {"steps": steps, "checkpoint_s": ckpt_s, "checkpoint_bytes": disk,
           "reopen_s": open_s, "deadline_s": cut}
    print(f"DML, transactions, persistence and the deadline on a mesh: "
          f"every step equals the single device; launches {launches}  "
          f"[{card}]")
    print(json.dumps({"mesh_dml": out}))
    return {"launches": launches, **out}


def _shell_lines(out: str) -> list[str]:
    lines = []
    for line in out.splitlines():
        while line.startswith(("sql> ", "...> ")):
            line = line[5:]
        lines.append(line)
    return lines


def shell_on_card(device, card: str):
    """`python -m duckdb_cubit_tpu_torch.shell --sf 0.01` driven through
    stdin: its `\\d`, `\\tpch 6` and multi-line SELECT must print the rows
    `conn.sql` / `tpch_query` give on a card catalog at SF0.01."""
    from duckdb_cubit_tpu_torch.api import connect

    root = os.path.dirname(os.path.abspath(__file__))
    stdin = f"\\timing\n\\d\n\\tpch 6\n{SHELL_SELECT}\n\\q\n"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "duckdb_cubit_tpu_torch.shell", "--sf",
         "0.01", "--device", device.type], input=stdin, cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the shell failed: {proc.stderr[-2000:]}")
    got = _shell_lines(proc.stdout)
    conn = connect(sf=0.01, device=device)

    def table(rows):
        return [" | ".join(r) for r in rows] + [f"({len(rows)} rows)"]

    tables = [f"{name:12} {t.num_rows:>12} rows  indexes: "
              f"{','.join(t.indexes) or '-'}"
              for name, t in conn.catalog.tables.items()]
    want = (["timing off"] + tables + table(conn.tpch_query(6).strings())
            + table(conn.sql(SHELL_SELECT.rstrip(";")).strings()) + [""])
    for line in got:
        print("   ", line)
    if got[2:] != want:
        raise AssertionError(f"the shell printed {got[2:]}, expected {want}")
    print(f"shell session: {len(tables)} tables, \\tpch 6 and the SELECT "
          f"equal conn.sql's rows; {secs:.2f} s with the process start  "
          f"[{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    args = ap.parse_args()

    phase("environment")
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs one card", file=sys.stderr)
        return 2
    card = card_line()
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])
    nvcc = subprocess.run(["bash", "-c", "nvcc --version || "
                           "/usr/local/cuda/bin/nvcc --version"],
                          capture_output=True, text=True).stdout
    print("nvcc:", nvcc.strip().splitlines()[-1] if nvcc.strip() else "?")
    device = torch.device("cuda")

    from duckdb_cubit_tpu_torch.api import connect
    from duckdb_cubit_tpu_torch.benchmarks import gather_probe, q6bench
    from duckdb_cubit_tpu_torch.ops import dict_like as dl
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs
    from duckdb_cubit_tpu_torch.ops import probe

    phase("build")
    build_kernels()

    phase("kernel parity (bit-exact): pytest -m cuda")
    kernel_tests()

    phase(f"main path: connect(sf={args.sf:g}, device='cuda')")
    t0 = time.perf_counter()
    conn = connect(sf=args.sf, device=device)
    print(f"catalog loaded in {time.perf_counter() - t0:.2f} s")
    for t in conn.catalog.tables.values():
        tensors = [c.data for c in t.columns.values()]
        tensors += [ix.words for ix in t.indexes.values()]
        tensors += [ix.cum_words for ix in t.indexes.values()]
        tensors += [pk.lut for pk in t.pk_indexes.values()]
        for x in tensors:
            if x.device.type != "cuda":
                raise AssertionError(f"{t.name}: tensor on {x.device}")
    cat = conn.catalog
    lineitem, orders = cat.table("lineitem"), cat.table("orders")
    print(f"lineitem rows {lineitem.num_rows}, capacity {lineitem.capacity}; "
          f"orders rows {orders.num_rows}, PK lut "
          f"{orders.pk_indexes['o_orderkey'].lut.shape[0]} slots")

    launches = {"dict_like": 0}
    rows, counts = counted(lambda: conn.sql(Q6).strings(), "fused_scan_sum")
    launches["fused_scan_sum"] = counts["fused_scan_sum"]
    launches["stream_compact"] = counts["stream_compact"]
    launches["pk_probe"] = counts["pk_probe"]
    if counts["dict_like"]:
        raise AssertionError("K6 launched in Q6, which has no LIKE")
    expect = oracle_of(cat, "Q6")[0][0]
    print(f"Q6 = {rows}, numpy oracle = {expect}, K1 launches = "
          f"{launches['fused_scan_sum']}")
    if rows != [[expect]]:
        raise AssertionError("Q6 disagrees with the numpy oracle")
    q6_revenue = rows[0][0]
    known = KNOWN_Q6.get(args.sf)
    if known is not None and expect != known:
        raise AssertionError(f"Q6 {expect} != known answer {known}")
    rows2 = conn.sql(Q6_OFF_EDGE).strings()
    expect2 = oracle_q6(live_columns(lineitem, LI_COLS), "1994-01-10", 2350)
    print(f"Q6 off-edge = {rows2}, numpy oracle = {expect2}")
    if rows2 != [[expect2]]:
        raise AssertionError("off-edge Q6 disagrees with the numpy oracle")

    # luts of each K2 launch: one launch per PK join on sorted keys, with
    # the row lut and every value lut the join reads
    k2_luts = {"Q1": [], "Q12": [2], "Q3": [4]}
    launches["monotone_gather"] = 0
    for name, sql in (("Q1", Q1), ("Q12", Q12), ("Q3", Q3)):
        print(conn.explain(sql))
        compacted = conn.executor.compacted_boundaries
        rows, counts = counted(lambda: conn.sql(sql).strings())
        compacted = conn.executor.compacted_boundaries - compacted
        k2_launches = counts["monotone_gather"]
        want = oracle_of(cat, name)
        print(f"{name}: {len(rows)} rows, K2 launches = {k2_launches}, "
              f"compacted stage inputs {compacted}")
        for row in rows[:4]:
            print("   ", row)
        if not rows_agree(rows, want):
            raise AssertionError(f"{name} disagrees with the numpy oracle: "
                                 f"{rows} vs {want}")
        if k2_launches != len(k2_luts[name]):
            raise AssertionError(f"{name} launched K2 {k2_launches} times, "
                                 f"expected {len(k2_luts[name])}")
        if counts["dict_like"]:
            raise AssertionError(f"K6 launched in {name}, which has no LIKE")
        if counts["stream_compact"] < compacted:
            raise AssertionError(f"{name} compacted {compacted} stage inputs "
                                 f"but launched K7 {counts['stream_compact']}"
                                 f" times")
        launches["monotone_gather"] += k2_launches
        launches["stream_compact"] += counts["stream_compact"]
        launches["pk_probe"] += counts["pk_probe"]
    print(f"Q1, Q12, Q3 equal their numpy oracles; K2 launches "
          f"{launches['monotone_gather']}")

    # each kernel on the main path's own inputs, against its plain version
    words, payloads, packed = q6_kernel_inputs(conn)
    if int(fs.fused_scan_sum(words, payloads, packed)) != \
            int(fs.fused_scan_sum_reference(words, payloads, packed)):
        raise AssertionError("K1 disagrees with plain on Q6's inputs")
    print(f"K1 on Q6 inputs: words {tuple(words.shape)} payload "
          f"{tuple(payloads[0].shape)} packed={packed}; kernel == plain")
    k2_calls = {}
    for name, sql in (("Q12", Q12), ("Q3", Q3)):
        k2_calls[name] = kernel_calls(lambda: conn.sql(sql).strings())[2]
        got = [len(luts) for luts, _ in k2_calls[name]]
        if got != k2_luts[name]:
            raise AssertionError(f"{name} gathered {got} luts per K2 call, "
                                 f"expected {k2_luts[name]}")
        for luts, keys in k2_calls[name]:
            outs, ovf = probe.monotone_gather_many(luts, keys)
            want, want_ovf = probe.monotone_gather_many_reference(luts, keys)
            if not torch.equal(outs, want) or int(ovf) != int(want_ovf):
                raise AssertionError(f"K2 disagrees with plain on {name}'s "
                                     f"probe inputs")
        print(f"K2 on {name}'s probe inputs: luts per call {got}; kernel "
              f"== plain")
    for table, column, patterns in K6_COLUMNS:
        ent = dl.dictionary_bytes(cat.table(table).columns[column].dictionary,
                                  device)
        for pattern in patterns:
            got = dl.like_table(ent, pattern)
            if not torch.equal(got, dl.like_table_reference(
                    ent, dl.compile_pattern(pattern))):
                raise AssertionError(f"K6 disagrees with plain on {table}."
                                     f"{column} LIKE {pattern!r}")
            print(f"K6 on {table}.{column} LIKE {pattern!r}: n={ent.shape[0]}"
                  f" w={ent.shape[1]}, {int(got.sum())} matches, kernel == "
                  f"plain")
    k6_after_insert(conn, card)

    phase(f"TPC-H plans: the 22 builders at SF{args.sf:g}")
    plans = tpch_plans(conn, args.sf, card)
    phase(f"TPC-H SQL: the 22 texts at SF{args.sf:g}")
    texts = tpch_sql(conn, plans, card)
    phase("sqllogic")
    sqllogic_on_card(card)
    phase(f"windows, range and ASOF joins at SF{args.sf:g}")
    cpu = plans.pop("cpu")
    windows = windows_and_joins(conn, cpu, card)

    phase("timing")
    print("card:", card)
    e2e = {}
    for name, sql in (("Q6", Q6), ("Q1", Q1), ("Q12", Q12), ("Q3", Q3)):
        times = []
        for _ in range(RUNS + 2):
            t0 = time.perf_counter()
            conn.sql(sql).strings()
            times.append((time.perf_counter() - t0) * 1e3)
        e2e[name] = statistics.median(times[2:])
        print(f"{name} end to end: median {e2e[name]:.3f} ms over {RUNS} "
              f"warm runs ({lineitem.num_rows / e2e[name] / 1e6:.3f} Grow/s "
              f"of lineitem)  [{card}]")
    for name, sql in (("Q6", Q6), ("Q1", Q1), ("Q12", Q12), ("Q3", Q3)):
        dev_ms, wall_ms, top = device_busy_share(
            lambda: conn.sql(sql).strings(), RUNS)
        print(f"{name} profiled: device kernels {dev_ms:.4f} ms of "
              f"{wall_ms:.4f} ms wall per query, device busy share "
              f"{dev_ms / wall_ms:.4f}  [{card}]")
        print(f"  top device kernels per query: {top}")
    for name, sql in (("Q12", Q12), ("Q3", Q3)):
        k2_dev, prelude = pk_probe_profile(conn, sql)
        print(f"{name} PK probe profiled: K2 {k2_dev:.4f} ms, the rest of "
              f"_pk_probe (key widening, clamp, liveness scatter, lut-sized "
              f"where) {prelude:.4f} ms of device time per call  [{card}]")

    flush = flush_buffer(device)
    times, bounds, library = {}, {}, {}
    print("K1 at Q6's inputs:")
    times["fused_scan_sum"] = k1_ms, k1_plain_ms = turns(
        lambda: fs.fused_scan_sum(words, payloads, packed),
        lambda: fs.fused_scan_sum_reference(words, payloads, packed),
        flush, card)
    n = payloads[0].shape[0]
    k1_bytes = fs.scan_sum_bytes(words, n, len(payloads))
    bounds["fused_scan_sum"] = bound_ms(k1_bytes)
    library["fused_scan_sum"] = None
    print(f"K1 {k1_ms:.4f} ms vs plain {k1_plain_ms:.4f} ms at n={n} "
          f"(L2 flushed); bound {bounds['fused_scan_sum']:.4f} ms "
          f"({k1_bytes} B: words and the payload sectors holding a selected "
          f"row), {bounds['fused_scan_sum'] / k1_ms:.3f} of it  [{card}]")
    # its fixed cost: launch, zeroing and the word pass, no payload sector
    zero_words = torch.zeros_like(words)
    fixed_ms = time_cold(lambda: fs.fused_scan_sum(zero_words, payloads,
                                                   packed), 30, flush)
    sector_bytes = k1_bytes - fs.scan_sum_bytes(zero_words, n, 1)
    print(f"K1 on all-zero words {fixed_ms:.4f} ms (L2 flushed); the "
          f"{sector_bytes} B of payload sectors take the other "
          f"{k1_ms - fixed_ms:.4f} ms, "
          f"{sector_bytes / max(k1_ms - fixed_ms, 1e-9) / 1e6:.1f} GB/s  "
          f"[{card}]")
    luts, keys = k2_calls["Q12"][0]
    lut = luts[0]
    print(f"K2, one lut, at Q12's probe inputs (keys {keys.shape[0]}, lut "
          f"{lut.shape[0]} slots):")
    times["monotone_gather"] = k2_ms, k2_plain_ms = turns(
        lambda: probe.monotone_gather(lut, keys),
        lambda: probe.monotone_gather_reference(lut, keys), flush, card)
    bounds["monotone_gather"] = bound_ms(probe.gather_bytes(keys, 1))
    library["monotone_gather"] = time_cold(
        lambda: lut[keys.to(torch.int64)], 30, flush)
    print(f"K2 {k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms (bare lut[keys] "
          f"gather {library['monotone_gather']:.4f} ms) at n={keys.shape[0]} "
          f"(L2 flushed); bound {bounds['monotone_gather']:.4f} ms, "
          f"{bounds['monotone_gather'] / k2_ms:.3f} of it  [{card}]")
    # the main path's passes: one launch over n luts against the n one-lut
    # launches it replaced
    k2_passes = []
    for name in ("Q12", "Q3"):
        luts, keys = k2_calls[name][0]
        one = time_cold(lambda: probe.monotone_gather_many(luts, keys), 30,
                        flush)
        apart = time_cold(lambda: [probe.monotone_gather(t, keys)
                                   for t in luts], 30, flush)
        bound = bound_ms(probe.gather_bytes(keys, len(luts)))
        k2_passes.append({"query": name, "luts": len(luts), "ms": one,
                          "one_lut_launches_ms": apart, "bound_ms": bound})
        print(f"K2 {name} pass, {len(luts)} luts: {one:.4f} ms in one "
              f"launch vs {apart:.4f} ms in {len(luts)} one-lut launches "
              f"(L2 flushed); bound {bound:.4f} ms, {bound / one:.3f} of it  "
              f"[{card}]")
    k6_ms, k6_plain_ms, bounds["dict_like"] = k6_timing(cat, device, flush,
                                                        card)
    times["dict_like"] = k6_ms, k6_plain_ms
    library["dict_like"] = None
    k7 = k7_timing(device, flush, card)
    k7_ms, k7_plain_ms, bounds["stream_compact"], library["stream_compact"] = \
        k7[K7_SHAPES[0][0]]
    times["stream_compact"] = k7_ms, k7_plain_ms
    k8 = k8_timing(device, flush, card)
    k8_ms, k8_plain_ms, bounds["pk_probe"], library["pk_probe"], _ = \
        k8[K8_SHAPES[0][0]]
    times["pk_probe"] = k8_ms, k8_plain_ms
    del flush

    phase("entry point: benchmarks.q6bench")
    summary, counts = counted(lambda: q6bench.run(cat, device),
                              "q6_words_i32", "q6_mask8_i32")
    print(json.dumps(summary))
    for name in ("q6_words_i32", "q6_mask8_i32"):
        launches[name] = counts[name]
        times[name] = summary["kernels"][name]
        bounds[name] = bound_ms(summary["bytes"][name])
        library[name] = None
    fixed, clean = k3k4_fixed_cost(cat, device, summary, times, card)
    phase("entry point: benchmarks.gather_probe")
    summary, counts = counted(lambda: gather_probe.run(device),
                              "table_gather", "lane_gather")
    print(json.dumps(summary))
    for name in ("table_gather", "lane_gather"):
        launches[name] = counts[name]
        times[name] = summary["kernels"][name]
        bounds[name] = bound_ms(summary["bytes"][name])
        library[name] = summary["library_ms"][name]
    k5_fixed, k5_clean = k5_fixed_cost(device, card)
    fixed.update(k5_fixed)
    clean.update(k5_clean)
    phase(f"verification, EXPLAIN ANALYZE, prepared queries, the deadline "
          f"and out-of-core at SF{args.sf:g}")
    modes = executor_modes(conn, cpu, card)
    del cpu
    print("-- staged against whole plan, the four queries and the 22 texts")
    staged_against_whole_plan(conn, texts, card)
    phase(f"mesh: the parallel steps on a one-rank NCCL group at "
          f"SF{args.sf:g}")
    mesh_steps(conn, q6_revenue, card)
    phase(f"engine on a mesh at SF{args.sf:g}")
    engine = mesh_engine(conn, texts, args.sf, card)
    phase("entry point: shell")
    shell_on_card(device, card)
    # last: it mutates the catalog every earlier phase read
    phase(f"DML, transactions and persistence at SF{args.sf:g}")
    dml = dml_transactions_persistence(conn, card, modes["prepared"],
                                       modes["q6_rows"])
    phase(f"DML, transactions, persistence and the deadline on a mesh at "
          f"SF{args.sf:g}")
    meshed = mesh_dml(dml, args.sf, card)
    del dml["reopened"]
    by_path = {name: {"sql": launches[name],
                      "tpch_plans": plans["launches"][name],
                      "tpch_sql": texts["launches"][name],
                      "windows": windows["launches"][name],
                      "verification": modes["launches"]["verification"][name]
                      + dml["prepared_launches"][name],
                      "external": modes["launches"]["external"][name],
                      "mesh_engine": engine["launches"][name],
                      "dml": dml["launches"][name],
                      "mesh_dml": meshed["launches"][name]}
               for name in ("fused_scan_sum", "monotone_gather")}
    for name in ("dict_like", "stream_compact", "pk_probe"):
        by_path[name] = {"sql": launches[name],
                         "tpch_plans": plans["launches"][name],
                         "tpch_sql": texts["launches"][name]}
    for name, paths in by_path.items():
        launches[name] = sum(paths.values())

    table = [{"name": name, "route": "cuda",
              "source": f"duckdb_cubit_tpu_torch/csrc/{name}.cu",
              "replaces": REPLACES[name], "launches": launches[name],
              # the kernel tests held it to its plain body bit for bit
              "max_abs_err": 0, "ms": times[name][0],
              "plain_ms": times[name][1], "bound_ms": bounds[name],
              "bound_by": "bytes", "library_ms": library[name]}
             for name in REPLACES]
    k2_row = next(r for r in table if r["name"] == "monotone_gather")
    k2_row.update(luts_per_launch=k2_luts, passes=k2_passes)
    k7_row = next(r for r in table if r["name"] == "stream_compact")
    k7_row["shapes"] = {label: {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                                "library_ms": lib}
                        for label, (ms, plain, bnd, lib) in k7.items()}
    k8_row = next(r for r in table if r["name"] == "pk_probe")
    k8_row["shapes"] = {label: {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                                "library_ms": lib, "gather_route_ms": route}
                        for label, (ms, plain, bnd, lib, route)
                        in k8.items()}
    for row in table:
        if row["name"] in by_path:
            row["launches_by_path"] = by_path[row["name"]]
        if row["name"] in fixed:
            row.update(fixed_ms=fixed[row["name"]],
                       clean_l2_ms=clean[row["name"]])
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
