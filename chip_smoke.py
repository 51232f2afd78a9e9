"""GPU smoke run of the PyTorch + CUDA port: TPC-H Q6, Q1, Q12 and Q3 through
the public API, then the reference's three benchmark entry points.

    python3 chip_smoke.py            # SF1 (6,001,215 lineitem rows)
    python3 chip_smoke.py --sf 10    # SF10

Needs one CUDA card, the CUDA toolkit (nvcc) and g++.  Phases, each of which
raises on failure (non-zero exit):

  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: all six kernels from duckdb_cubit_tpu_torch/csrc/, one nvcc
     each, started together: K1 the fused scan-sum, K2 the monotone gather,
     K3 / K4 the Q6 word- and mask-sums with int32 halves, K5a the table
     gather and K5b the lane gather;
  3. kernel parity: each kernel against its plain torch version on the card,
     bit-exact.  K1 in every mode (single, pair, packed), ragged and aligned
     lengths, empty / full / sparse masks, int64 accumulation past 2**31,
     and 32-word tiles all zero, all ones and sparse in turn with word
     counts that are not a multiple of the tile.  K2 on dense keys of
     variable multiplicity, absent slots, sparse keys, out-of-order and
     out-of-range keys (the overflow count must match), a length that is a
     multiple of no block size; over 1, 2, 4, 8 and 9 luts at once; on
     views that start 4, 8 and 12 B past a 16-B boundary and lengths 1, 3,
     5, 127, 129; on keys broken where a warp's span starts, at a quad
     boundary and inside a quad (the count must be 3); and gather_via_sort
     on random keys.  K3 / K4 on a length that is a multiple of 32 but not
     of 1024, all-ones words, a wrapping low half, negative products and
     (K4) every mask byte; on 32 k rows with k a multiple of neither 4, 16
     nor 32 (ragged steps, tiles and K4's scalar tail), all-zero words and
     mask, zero 4-row groups beside nonzero ones, every byte value at every
     position of K4's 16-B mask loads, the views the wrapper takes
     (`words[k:]` with `a[32 k:]`, `mask[16 k:]` with `a[16 k:]`, rows of
     a stack) and one it refuses.  K5a and K5b twice per case (the second
     call finds the scratch the first left).  K5a on tables of 1, 37, 8192
     and 12288 entries (one a view off a 16-B boundary), 1-D and (N/128,
     128) shapes, indices 0 and T-1, ragged lengths, indices out of range
     (the count must match), views 4, 8 and 12 B off a boundary, n = 1, 3,
     5, 127, 129 and a bad index at each position of a 16-B load; K5b on 1,
     3, 7, 64 and 100 table rows (100 takes the plain kernel), row counts
     that are and are not multiples of them and of the grid's warps, bad
     lane indices at each position of a 16-B load, and indices and a table
     4 B off a boundary;
  4. main path: connect(sf, device="cuda"), every table / index tensor on the
     card.  Q6 (and an off-bin-edge variant), Q1, Q12 and Q3 through
     conn.sql() against numpy oracles on the generated columns (Q6 also
     against its known answer).  Each query runs with the launch counts set
     to 0 just before it and read just after: K1 must launch in Q6; K2
     exactly once in Q12 (the probe with the o_orderpriority value lut: 2
     luts) and once in Q3 (the lineitem -> orders join: the row lut and 3
     value luts).  Each kernel is then compared with its plain version on
     the inputs the main path gave it;
  5. timing: each query end to end (median of warm runs), the device busy
     share of each from torch.profiler with its top device kernels, the
     device time of the PK probe's prelude beside K2's, and each kernel
     alone against its plain version at the main path's shapes with the L2
     cache flushed, beside its bound (the bytes it must move at 3.35 TB/s)
     and the one PyTorch call that computes the same function, where there
     is one; K2's 2- and 4-lut passes against the one-lut launches they
     replaced;
  6. entry points, each with every launch count set to 0 just before it
     and read just after, on the catalog already loaded:
     `benchmarks.q6bench` (64 random word variants over lineitem; K3 and
     K4 must launch; then K3 on all-zero words and K4 on an all-zero mask,
     L2 flushed: their fixed cost beside their time at variant 0, and that
     time after a flush that leaves the L2 clean),
     `benchmarks.gather_probe` (N = 2**22, T = 2**13; K5a
     and K5b must launch; then K5a on 128 indices and K5b on one row, L2
     flushed: their fixed cost, beside one torch kernel on one element, and
     their time at N = 2**22 after a clean-L2 flush) and `bench` (32 Q6
     variants and the l_orderkey ->
     orders probes; K1 and K2 must launch).  Each checks its own results
     and prints its times.

The line before the last holds the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
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
}
# relative tolerance of DOUBLE cells against the numpy oracle: the engine
# and numpy sum floats in different orders
DOUBLE_RTOL = 1e-9
# warm runs behind each end-to-end and profiled time
RUNS = 20


def phase(name: str):
    print(f"== {name}", flush=True)


def oracle_q6(lineitem, ship_lo: str, qty_lt_cents: int) -> str:
    """Q6 from the host columns with numpy: independent of both engines."""
    from duckdb_cubit_tpu_torch.exec.result import format_decimal
    from duckdb_cubit_tpu_torch.types import date_to_days

    col = {n: c.host.astype(np.int64) for n, c in lineitem.columns.items()
           if n in ("l_shipdate", "l_discount", "l_quantity",
                    "l_extendedprice")}
    sel = ((col["l_shipdate"] >= date_to_days(ship_lo))
           & (col["l_shipdate"] < date_to_days("1995-01-01"))
           & (col["l_discount"] >= 5) & (col["l_discount"] <= 7)
           & (col["l_quantity"] < qty_lt_cents))
    total = int((col["l_extendedprice"][sel] * col["l_discount"][sel]).sum())
    return format_decimal(total, 4)


def k1_parity_cases(device):
    """K1: (label, words, payloads, packed) on the card, made from a seed."""
    from duckdb_cubit_tpu_torch.ops import bitmap as bm
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs

    rng = np.random.default_rng(0)
    cases = []
    for n in (8192 * 9, 8192 * 9 + 77, 1 << 20):
        for density, tag in ((0.0, "empty"), (1.0, "full"), (0.03, "3%")):
            mask = rng.random(n) < density
            a = rng.integers(0, 10_500_000, n).astype(np.int32)
            b = rng.integers(0, 11, n).astype(np.int32)
            words = bm.pack_mask(torch.as_tensor(mask, device=device),
                                 bm.num_words(n))
            ta = torch.as_tensor(a, device=device)
            tb = torch.as_tensor(b, device=device)
            cases += [(f"single n={n} {tag}", words, [ta], False),
                      (f"pair n={n} {tag}", words, [ta, tb], False),
                      (f"packed n={n} {tag}", words,
                       [fs.pack_columns(ta, tb)], True)]
    # products near 2**31 over 2**24 rows: the sum needs int64
    n = 1 << 24
    mask = rng.random(n) < 0.5
    a = rng.integers(2**23, 2**24, n).astype(np.int32)
    b = rng.integers(120, 128, n).astype(np.int32)
    words = bm.pack_mask(torch.as_tensor(mask, device=device), bm.num_words(n))
    ta, tb = torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)
    cases += [(f"pair n=2^24 near-2^31 products", words, [ta, tb], False),
              (f"packed n=2^24 near-2^31 products", words,
               [fs.pack_columns(ta, tb)], True)]
    # the kernel's 32-word tiles all zero, all ones and 3% in turn; word
    # counts that are not a multiple of the tile, rows not of 32
    for n in (1, 31, 32 * 33 + 5, 1024 * 7 + 999, (1 << 20) + 1024 * 5 + 17):
        mask = rng.random(n) < 0.03
        for t in range(0, n, 1024):
            if (t // 1024) % 3 < 2:
                mask[t:t + 1024] = (t // 1024) % 3 == 1
        a = rng.integers(0, 2**24, n).astype(np.int32)
        b = rng.integers(0, 256, n).astype(np.int32)
        words = bm.pack_mask(torch.as_tensor(mask, device=device),
                             bm.num_words(n))
        ta = torch.as_tensor(a, device=device)
        tb = torch.as_tensor(b, device=device)
        cases += [(f"single n={n} tile edges", words, [ta], False),
                  (f"pair n={n} tile edges", words, [ta, tb], False),
                  (f"packed n={n} tile edges", words,
                   [fs.pack_columns(ta, tb)], True)]
    return cases


def _code(table, column: str, value: str) -> int:
    """A string's code in a column's sorted dictionary."""
    d = table.columns[column].dictionary
    i = int(np.searchsorted(d, value.encode()))
    if i >= len(d) or d[i] != value.encode():
        raise AssertionError(f"{value!r} not in {column}'s dictionary")
    return i


def oracle_q1(lineitem) -> list[list]:
    """Q1 from the host columns with numpy; DOUBLE cells as floats."""
    from duckdb_cubit_tpu_torch.exec.result import format_decimal
    from duckdb_cubit_tpu_torch.types import date_to_days

    c = {n: lineitem.columns[n].host.astype(np.int64)
         for n in ("l_returnflag", "l_linestatus", "l_shipdate", "l_quantity",
                   "l_extendedprice", "l_discount", "l_tax")}
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


def _orders_row_of(orders, keys: np.ndarray) -> np.ndarray:
    okey = orders.columns["o_orderkey"].host.astype(np.int64)
    lut = np.full(int(okey.max()) + 1, -1, np.int64)
    lut[okey] = np.arange(len(okey))
    return lut[keys]


def oracle_q12(lineitem, orders) -> list[list]:
    """Q12 from the host columns with numpy (join through a key lut)."""
    from duckdb_cubit_tpu_torch.types import date_to_days

    li = {n: lineitem.columns[n].host.astype(np.int64)
          for n in ("l_orderkey", "l_shipmode", "l_shipdate", "l_commitdate",
                    "l_receiptdate")}
    prio = orders.columns["o_orderpriority"].host.astype(np.int64)[
        _orders_row_of(orders, li["l_orderkey"])]
    high = np.isin(prio, [_code(orders, "o_orderpriority", "1-URGENT"),
                          _code(orders, "o_orderpriority", "2-HIGH")])
    sel = ((li["l_commitdate"] < li["l_receiptdate"])
           & (li["l_shipdate"] < li["l_commitdate"])
           & (li["l_receiptdate"] >= date_to_days("1994-01-01"))
           & (li["l_receiptdate"] < date_to_days("1995-01-01")))
    rows = []
    for mode in ("MAIL", "SHIP"):
        m = sel & (li["l_shipmode"] == _code(lineitem, "l_shipmode", mode))
        rows.append([mode, str(int((m & high).sum())),
                     str(int((m & ~high).sum()))])
    return rows


def oracle_q3(customer, orders, lineitem) -> list[list]:
    """Q3 from the host columns with numpy (lineitem is sorted by
    l_orderkey, so a group is a run)."""
    from duckdb_cubit_tpu_torch.exec.result import format_decimal
    from duckdb_cubit_tpu_torch.types import date_to_days, days_to_date

    if not lineitem.columns["l_orderkey"].is_sorted:
        raise AssertionError("lineitem is not sorted by l_orderkey")
    cust = customer.columns["c_custkey"].host.astype(np.int64)
    seg = customer.columns["c_mktsegment"].host
    building = np.zeros(int(cust.max()) + 1, bool)
    building[cust[seg == _code(customer, "c_mktsegment", "BUILDING")]] = True
    okey = orders.columns["o_orderkey"].host.astype(np.int64)
    odate = orders.columns["o_orderdate"].host.astype(np.int64)
    oship = orders.columns["o_shippriority"].host.astype(np.int64)
    ocust = orders.columns["o_custkey"].host.astype(np.int64)
    cut = date_to_days("1995-03-15")
    order_ok = np.zeros(int(okey.max()) + 1, bool)
    order_ok[okey[(odate < cut) & building[ocust]]] = True
    lk = lineitem.columns["l_orderkey"].host.astype(np.int64)
    sel = (lineitem.columns["l_shipdate"].host.astype(np.int64) > cut) \
        & order_ok[lk]
    keys = lk[sel]
    rev = lineitem.columns["l_extendedprice"].host.astype(np.int64)[sel] * (
        100 - lineitem.columns["l_discount"].host.astype(np.int64)[sel])
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    sums = np.add.reduceat(rev, starts)
    ukeys = keys[starts]
    orow = _orders_row_of(orders, ukeys)
    top = np.lexsort((odate[orow], -sums))[:10]
    return [[str(int(ukeys[i])), format_decimal(int(sums[i]), 4),
             days_to_date(int(odate[orow[i]])).isoformat(),
             str(int(oship[orow[i]]))] for i in top]


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


def k2_parity_cases():
    """K2: (label, lut, keys) as numpy int32, made from a seed."""
    rng = np.random.default_rng(1)

    def strided_lut(size, stride):
        lut = np.full(size, -1, np.int32)
        present = np.arange(0, size, stride)
        lut[present] = rng.permutation(len(present)).astype(np.int32)
        return present, lut

    cases = []
    present, lut = strided_lut(6_000_001, 4)
    # sorted FK keys against a PK lut: every present key 1-7 times
    dense = np.repeat(present, rng.integers(1, 8, len(present)))
    cases.append(("dense keys, multiplicity 1-7", lut, dense))
    # every slot of a quarter-full lut: three keys in four hit -1
    cases.append(("absent slots (-1)", lut,
                  np.arange(1000, 4_001_000, dtype=np.int64)))
    # one key in 97 slots, twice each
    cases.append(("sparse keys (stride 97)", lut,
                  np.repeat(np.arange(0, 6_000_001, 97), 2)))
    broken = np.sort(rng.integers(0, 6_000_001, 3_000_000))
    broken[1_000_000] = broken[999_999] - 1        # smaller than before it
    broken[2_000_000] = 6_000_001                  # past the lut's end
    cases.append(("out-of-order and out-of-range keys", lut, broken))
    # no block size divides it
    cases.append(("ragged length 1,000,003", lut,
                  np.sort(rng.integers(0, 6_000_001, 1_000_003))))
    return [(label, lut, keys.astype(np.int32)) for label, lut, keys in cases]


def kernel_modules():
    """kernel name -> (wrapper module, its CudaKernel, its count's name)."""
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs
    from duckdb_cubit_tpu_torch.ops import gather_forms as gf
    from duckdb_cubit_tpu_torch.ops import probe
    from duckdb_cubit_tpu_torch.ops import q6_variants as qv

    return {"fused_scan_sum": (fs, fs.KERNEL, "launch_count"),
            "monotone_gather": (probe, probe.KERNEL, "launch_count"),
            "q6_words_i32": (qv, qv.WORDS_KERNEL, "words_launch_count"),
            "q6_mask8_i32": (qv, qv.MASK8_KERNEL, "mask8_launch_count"),
            "table_gather": (gf, gf.TABLE_KERNEL, "table_launch_count"),
            "lane_gather": (gf, gf.LANE_KERNEL, "lane_launch_count")}


def reset_counts():
    for module, _, count in kernel_modules().values():
        setattr(module, count, 0)


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: getattr(module, count)
            for name, (module, _, count) in kernel_modules().items()}


def build_kernels():
    """Every kernel, one nvcc each, started together."""
    kernels = {name: kernel for name, (_, kernel, _) in
               kernel_modules().items()}

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


def k1_parity(device) -> int:
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs

    max_err = 0
    for label, words, payloads, packed in k1_parity_cases(device):
        got = fs.fused_scan_sum(words, payloads, packed)
        want = fs.fused_scan_sum_reference(words, payloads, packed)
        torch.cuda.synchronize()
        err = abs(int(got) - int(want))
        max_err = max(max_err, err)
        print(f"  K1 {label:40s} kernel={int(got)} plain={int(want)}")
        if err:
            raise AssertionError(f"K1 disagrees with plain ({label})")
    return max_err


def k2_compare(label: str, luts: list, keys: torch.Tensor):
    """K2 against its plain body on one input, bit-exact, every lut; ->
    (max |error|, the kernel's overflow count)."""
    from duckdb_cubit_tpu_torch.ops import probe

    outs, ovf = probe.monotone_gather_many(luts, keys)
    want, want_ovf = probe.monotone_gather_many_reference(luts, keys)
    torch.cuda.synchronize()
    err = max(int((outs.to(torch.int64) - want).abs().max()) if len(keys)
              else 0, abs(int(ovf) - int(want_ovf)))
    print(f"  K2 {label:44s} n={len(keys)} luts={len(luts)} "
          f"overflow kernel={int(ovf)} plain={int(want_ovf)} max_err={err}")
    if err:
        raise AssertionError(f"K2 disagrees with plain ({label})")
    return err, int(ovf)


def value_luts(lut: torch.Tensor, count: int, seed: int) -> list:
    """`count` key-space value luts beside a row lut (random values, 0 at
    the absent slots, as the PK index builds them)."""
    g = torch.Generator(device=lut.device).manual_seed(seed)
    return [torch.where(lut >= 0, torch.randint(
        -2**31, 2**31 - 1, lut.shape, generator=g, device=lut.device,
        dtype=torch.int32), 0) for _ in range(count)]


def k2_parity(device) -> int:
    from duckdb_cubit_tpu_torch.ops import probe

    max_err = 0

    def check(label, luts, keys, bad=0):
        nonlocal max_err
        err, ovf = k2_compare(label, luts, keys)
        max_err = max(max_err, err)
        if ovf != bad:
            raise AssertionError(f"K2 counted {ovf} bad keys, expected "
                                 f"{bad} ({label})")

    for label, lut, keys in k2_parity_cases():
        k = np.asarray(keys, np.int64)
        bad = (k < 0) | (k >= len(lut))
        bad[1:] |= k[1:] < k[:-1]
        check(label, [torch.as_tensor(lut, device=device)],
              torch.as_tensor(keys, device=device), int(bad.sum()))
    lut = torch.as_tensor(k2_parity_cases()[0][1], device=device)
    dense = torch.as_tensor(k2_parity_cases()[0][2], device=device)
    luts = [lut] + value_luts(lut, 8, seed=5)
    # one pass over 1, 2, 4 and 8 luts; 9 luts take two launches
    for m in (1, 2, 4, 8, 9):
        check(f"dense keys, {m} luts", luts[:m], dense)
    # views that start 4, 8 and 12 B past a 16-B boundary, and lengths that
    # fill no quad, no warp span and no block
    for off in (1, 2, 3):
        check(f"keys[{off}:], 3 luts", luts[:3], dense[off:])
    for n in (1, 3, 5, 127, 129, 1_000_003):
        check(f"n={n}, 2 luts", luts[:2], dense[:n])
        check(f"n={n} from keys[1:], 2 luts", luts[:2], dense[1:n + 1])
    # broken keys where a warp span starts (index 128 k: lane 0 reads the
    # predecessor from memory), at a quad boundary (the predecessor comes
    # by shuffle) and inside a quad; and the same keys from keys[1:], which
    # moves every boundary by one key
    broken = dense[:1_000_000].clone()
    for i in (128 * 1000, 4 * 30001, 4 * 60001 + 2):
        broken[i] = broken[i - 1] - 1
    check("broken at a span, a quad and inside a quad", luts[:4], broken, 3)
    check("the same broken keys from keys[1:]", luts[:4], broken[1:], 3)
    rng = np.random.default_rng(2)
    keys = torch.as_tensor(rng.integers(0, len(lut), 2_000_000)
                           .astype(np.int32), device=device)
    got, ovf = probe.gather_via_sort(lut, keys)
    want, want_ovf = probe.gather_via_sort(lut.cpu(), keys.cpu())
    err = max(int((got.cpu().to(torch.int64) - want).abs().max()),
              abs(int(ovf) - int(want_ovf)))
    print(f"  K2 gather_via_sort, random keys             n={len(keys)} "
          f"overflow={int(ovf)} max_err={err}")
    if err or int(ovf):
        raise AssertionError("gather_via_sort disagrees with plain")
    return max(max_err, err)


def _pair_err(label: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Bit-exact check of two int32 [hi, lo] pairs; -> max |error|."""
    torch.cuda.synchronize()
    g, w = got.cpu().tolist(), want.cpu().tolist()
    err = max(abs(a - b) for a, b in zip(g, w))
    print(f"  {label:52s} kernel={g} plain={w}")
    if err:
        raise AssertionError(f"{label}: kernel disagrees with plain")
    return err


def k3k4_parity(device) -> tuple[int, int]:
    """K3 and K4 against their plain bodies: -> (K3 max err, K4 max err)."""
    from duckdb_cubit_tpu_torch.ops import bitmap as bm
    from duckdb_cubit_tpu_torch.ops import q6_variants as qv

    rng = np.random.default_rng(3)

    def dev(a):
        return torch.as_tensor(a, device=device)

    cases = []
    n = 32 * 733 * 3    # a multiple of 32, not of 1024
    words = rng.integers(0, 2**32, n // 32, dtype=np.uint32).view(np.int32)
    cases.append(("random words, Q6-like payloads", words,
                  rng.integers(0, 10_500_000, n), rng.integers(0, 11, n)))
    n = 1 << 20
    ones = np.full(n // 32, -1, np.int32)
    cases.append(("all-ones words, Q6-like payloads", ones,
                  rng.integers(0, 10_500_000, n), rng.integers(0, 11, n)))
    # prod & 0xFFFF near 65535 on 2**20 rows: the low half wraps 2**32
    cases.append(("all-ones words, low half wraps", ones,
                  rng.integers(60_000, 65_536, n), np.ones(n, np.int64)))
    words = rng.integers(0, 2**32, n // 32, dtype=np.uint32).view(np.int32)
    cases.append(("random words, negative and wrapping products", words,
                  rng.integers(-2**31, 2**31, n), rng.integers(-2**31, 2**31,
                                                               n)))
    k3_err = k4_err = 0
    for label, w, a, b in cases:
        w, a, b = dev(w), dev(a.astype(np.int32)), dev(b.astype(np.int32))
        k3_err = max(k3_err, _pair_err(
            f"K3 {label}", qv.q6_words_i32(w, a, b),
            qv.q6_words_i32_reference(w, a, b)))
        m = bm.expand(w, a.shape[0]).to(torch.int8)
        k4_err = max(k4_err, _pair_err(
            f"K4 {label}", qv.q6_mask8_i32(m, a, b),
            qv.q6_mask8_i32_reference(m, a, b)))
    n = 1 << 20
    m = dev(rng.integers(-128, 128, n).astype(np.int8))
    a = dev(rng.integers(-2**31, 2**31, n).astype(np.int32))
    b = dev(rng.integers(-2**31, 2**31, n).astype(np.int32))
    k4_err = max(k4_err, _pair_err("K4 every mask byte in -128..127",
                                   qv.q6_mask8_i32(m, a, b),
                                   qv.q6_mask8_i32_reference(m, a, b)))
    k3_new, k4_new = k3k4_new_paths(device, rng)
    return max(k3_err, k3_new), max(k4_err, k4_new)


def zero_group_words(rng, k: int) -> np.ndarray:
    """k random words with each 4-bit group (4 rows) zeroed at random: zero
    groups beside nonzero ones; int32 bit patterns."""
    words = rng.integers(0, 2**32, k, dtype=np.uint64)
    keep = (rng.random((k, 8)) < 0.5).astype(np.uint64)
    nibbles = np.uint64(0xF) << (np.uint64(4) * np.arange(8, dtype=np.uint64))
    return (words & (keep * nibbles).sum(1, dtype=np.uint64)) \
        .astype(np.uint32).view(np.int32)


def signed_mask(rng, words: np.ndarray) -> np.ndarray:
    """A nonzero signed byte in -128..127 where a word's bit is set, 0
    elsewhere: the int8 mask of the same rows."""
    bits = (words.view(np.uint32)[:, None] >> np.arange(32, dtype=np.uint32)) \
        & 1
    vals = rng.integers(-128, 128, bits.size)
    vals[vals == 0] = 1
    return np.where(bits.reshape(-1) != 0, vals, 0).astype(np.int8)


def k3k4_new_paths(device, rng) -> tuple[int, int]:
    """K3 / K4 on the paths of their Hopper design: ragged steps, tiles and
    tails, zero selectors, zero 4-row groups beside nonzero ones, every byte
    value at every position of a 16-B mask load, and the views the wrapper
    takes (and one it refuses); -> (K3 max err, K4 max err)."""
    from duckdb_cubit_tpu_torch.ops import bitmap as bm
    from duckdb_cubit_tpu_torch.ops import q6_variants as qv

    err = {"K3": 0, "K4": 0}

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    def k3(label, w, a, b):
        err["K3"] = max(err["K3"], _pair_err(
            f"K3 {label}", qv.q6_words_i32(w, a, b),
            qv.q6_words_i32_reference(w, a, b)))

    def k4(label, m, a, b):
        err["K4"] = max(err["K4"], _pair_err(
            f"K4 {label}", qv.q6_mask8_i32(m, a, b),
            qv.q6_mask8_i32_reference(m, a, b)))

    def payload(n):
        return dev(rng.integers(-2**31, 2**31, n).astype(np.int32))

    # 32 k rows, k a multiple of neither 4, 16 nor 32: K3's last step and
    # tile are ragged, K4 ends in a scalar tail (its steps are 512 rows)
    for k in (1, 3, 6, 18, 37, 1001, 100_003):
        n = 32 * k
        words = zero_group_words(rng, k)
        w, a, b = dev(words), payload(n), payload(n)
        k3(f"n=32*{k}, zero 4-row groups beside nonzero", w, a, b)
        k4(f"n=32*{k}, 0/1 mask of the same words", bm.expand(
            w, n).to(torch.int8), a, b)
        k4(f"n=32*{k}, signed mask, zero 4-row groups",
           dev(signed_mask(rng, words)), a, b)
    n = 1 << 20
    a, b = payload(n), payload(n)
    k3("all-zero words", dev(np.zeros(n // 32, np.int32)), a, b)
    k4("all-zero mask", dev(np.zeros(n, np.int8)), a, b)
    # byte j of 16-B load s is (s + 37 j) mod 256: every value at every
    # position of the loads
    s, j = np.arange(n // 16)[:, None], np.arange(16)[None, :]
    k4("every byte value at every position of a 16-B load",
       dev(((s + 37 * j) % 256).astype(np.uint8).view(np.int8).reshape(-1)),
       a, b)
    # views: a word holds 128 B of each payload, so words[k:] with a[32 k:]
    # stays aligned, as do mask[16 k:] with a[16 k:] and the rows of a
    # stack (q6bench passes words[v] and masks[v])
    n = 32 * 4099
    words = dev(zero_group_words(rng, 3 * n // 32).reshape(3, n // 32))
    masks = dev(rng.integers(-128, 128, (3, n)).astype(np.int8))
    a, b = payload(n), payload(n)
    for k in (1, 3):
        k3(f"words[{k}:], a[{32 * k}:], b[{32 * k}:]", words[0, k:],
           a[32 * k:], b[32 * k:])
        k4(f"mask[{16 * k}:], a[{16 * k}:], b[{16 * k}:]", masks[0, 16 * k:],
           a[16 * k:], b[16 * k:])
    k3("row 2 of a (3, n/32) words stack", words[2], a, b)
    k4("row 2 of a (3, n) mask stack", masks[2], a, b)
    try:
        qv.q6_mask8_i32(masks[0, 4:], a[4:], b[4:])
    except ValueError as e:
        print(f"  K4 mask[4:], a[4:], b[4:] refused: {e}")
    else:
        raise AssertionError("K4 took a view off a 16-B boundary")
    return err["K3"], err["K4"]


def _gather_err(label: str, got, want) -> int:
    """Bit-exact check of two (out, bad) results; -> max |error|."""
    (out, bad), (w_out, w_bad) = got, want
    torch.cuda.synchronize()
    err = max(int((out.to(torch.int64) - w_out).abs().max()),
              abs(int(bad) - int(w_bad)))
    print(f"  {label:52s} n={out.numel()} bad kernel={int(bad)} "
          f"plain={int(w_bad)} max_err={err}")
    if err:
        raise AssertionError(f"{label}: kernel disagrees with plain")
    return err


def k5_parity(device) -> tuple[int, int]:
    """K5a and K5b against their plain bodies, each case called twice (the
    second call finds the scratch the first left): -> (K5a err, K5b err)."""
    from duckdb_cubit_tpu_torch.ops import gather_forms as gf

    rng = np.random.default_rng(4)
    err = {"K5a": 0, "K5b": 0}

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def check(kernel, label, tab, idx, bad=None):
        fn, plain = {"K5a": (gf.table_gather, gf.table_gather_reference),
                     "K5b": (gf.lane_gather, gf.lane_gather_reference)}[kernel]
        for call in (1, 2):
            got = fn(tab, idx)
            err[kernel] = max(err[kernel], _gather_err(
                f"{kernel} {label} (call {call})", got, plain(tab, idx)))
            if bad is not None and int(got[1]) != bad:
                raise AssertionError(f"{kernel} counted {int(got[1])} bad "
                                     f"indices, expected {bad} ({label})")

    def table(t):
        return dev(rng.integers(-2**31, 2**31, t).astype(np.int32))

    for t, n in ((8192, 1_000_003), (37, 70_001), (gf.MAX_TABLE, 1 << 22),
                 (1, 4099)):
        idx = rng.integers(0, t, n).astype(np.int32)
        idx[:2] = (0, t - 1)
        idx[-2:] = (t - 1, 0)
        check("K5a", f"T={t} 1-D", table(t), dev(idx), 0)
    tab2 = dev(rng.integers(-2**31, 2**31, (64, 128)).astype(np.int32))
    check("K5a", "T=8192 (64, 128) table, (2**15, 128) indices", tab2,
          dev(rng.integers(0, 8192, (1 << 15, 128)).astype(np.int32)), 0)
    idx = rng.integers(0, 8192, 100_000).astype(np.int32)
    idx[[5, 500, 99_999]] = (-1, 8192, -2**31)
    check("K5a", "three indices out of range", tab2, dev(idx), 3)
    # the paths of the Hopper design: views 4, 8 and 12 B off a 16-B
    # boundary (scalar head), lengths that fill no int4 or one and a bit
    # (scalar tail), a bad index at each position of a 16-B load, a table
    # that is itself a view off a boundary (copied entry by entry)
    tab = table(8192)
    base = rng.integers(0, 8192, 1_000_003).astype(np.int32)
    idx = dev(base)
    for off in (1, 2, 3):
        check("K5a", f"idx[{off}:]", tab, idx[off:], 0)
    for n in (1, 3, 5, 127, 129):
        check("K5a", f"n={n}", tab, idx[:n], 0)
        check("K5a", f"n={n} from idx[1:]", tab, idx[1:n + 1], 0)
    worst = base.copy()
    worst[[4000, 4101, 4202, 4303]] = (8192, -1, 9000, -2**31)
    worst_idx = dev(worst)
    check("K5a", "a bad index at each position of an int4", tab, worst_idx,
          4)
    check("K5a", "the same from idx[1:]", tab, worst_idx[1:], 4)
    big = table(gf.MAX_TABLE + 1)
    check("K5a", "T=MAX_TABLE from tab[1:] (16-B misaligned table)",
          big[1:], dev(rng.integers(0, gf.MAX_TABLE, 333_333)
                       .astype(np.int32)), 0)

    # K5b: rows that divide the grid's warp count (64) and rows that do
    # not (1 divides everything; 3, 7 and 100 do not divide 132 * 32), R a
    # multiple of no warp count; 100 rows (51 KB) take the plain kernel
    for rows, r in ((64, 1 << 15), (64, 1001), (3, 1 << 12), (1, 999),
                    (3, 1001), (7, 999), (7, 8453), (64, 4224 * 2 + 77),
                    (100, 1001)):
        tab = dev(rng.integers(-2**31, 2**31, (rows, 128)).astype(np.int32))
        li = dev(rng.integers(0, 128, (r, 128)).astype(np.int32))
        check("K5b", f"rows={rows} R={r}", tab, li, 0)
    check("K5b", "rows=7 R=1", tab[:7], li[:1], 0)
    li = rng.integers(0, 128, (999, 128)).astype(np.int32)
    li[[0, 10, 998], [0, 127, 64]] = (128, -1, 1000)
    tab = tab[:64]
    check("K5b", "three lane indices out of range", tab, dev(li), 3)
    li[500, 40:44] = (128, -1, 1 << 30, -2**31)
    check("K5b", "a bad lane index at each position of an int4", tab,
          dev(li), 7)
    # lane indices and a table 4 B off a 16-B boundary: the plain kernel
    flat = dev(rng.integers(0, 128, 1001 * 128 + 1).astype(np.int32))
    tflat = dev(rng.integers(-2**31, 2**31, 3 * 128 + 1).astype(np.int32))
    check("K5b", "lane_idx and tab 4 B off a boundary, rows=3 R=1001",
          tflat[1:].view(3, 128), flat[1:].view(1001, 128), 0)
    return err["K5a"], err["K5b"]


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


def counted(run, *must_launch):
    """`run()` with every launch count set to 0 just before it and read just
    after; raises unless each kernel named in `must_launch` launched.
    -> (run's result, launches by kernel name)."""
    reset_counts()
    result = run()
    counts = read_counts()
    for name in must_launch:
        if counts[name] < 1:
            raise AssertionError(f"{name} did not launch: {counts}")
    return result, counts


def main_path_inputs(conn, sql: str) -> list:
    """The (luts, keys) of every K2 call a query makes (a separate run: the
    recording wrapper is not the counted main path)."""
    from duckdb_cubit_tpu_torch.ops import probe

    calls = []
    real = probe.monotone_gather_many

    def recording(luts, keys):
        calls.append((list(luts), keys))
        return real(luts, keys)
    probe.monotone_gather_many = recording
    try:
        conn.sql(sql).strings()
    finally:
        probe.monotone_gather_many = real
    return calls


def pk_probe_profile(conn, sql: str) -> tuple[float, float]:
    """Device ms per call of the first kernel-path `HashJoin._pk_probe` of a
    query, from torch.profiler, split into (K2's own kernel, the rest: the
    key widening and clamp, the liveness scatter and the lut-sized where)."""
    from duckdb_cubit_tpu_torch.plan.physical import HashJoin

    seen = []
    real = HashJoin._pk_probe

    def recording(self, *args):
        result = real(self, *args)
        if result[2] is not None and not seen:
            seen.append((self, *args))
        return result
    HashJoin._pk_probe = recording
    try:
        conn.sql(sql).strings()
    finally:
        HashJoin._pk_probe = real
    join, *args = seen[0]
    kernels, _ = device_kernel_times(lambda: real(join, *args), RUNS)
    k2 = sum(ms for name, ms in kernels.items() if "monotone_gather" in name)
    return k2, sum(kernels.values()) - k2


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

    from duckdb_cubit_tpu_torch import bench
    from duckdb_cubit_tpu_torch.api import connect
    from duckdb_cubit_tpu_torch.benchmarks import gather_probe, q6bench
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs
    from duckdb_cubit_tpu_torch.ops import probe

    phase("build")
    build_kernels()

    phase("kernel parity (bit-exact)")
    err = {"fused_scan_sum": k1_parity(device),
           "monotone_gather": k2_parity(device)}
    err["q6_words_i32"], err["q6_mask8_i32"] = k3k4_parity(device)
    err["table_gather"], err["lane_gather"] = k5_parity(device)

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

    launches = {}
    rows, counts = counted(lambda: conn.sql(Q6).strings(), "fused_scan_sum")
    launches["fused_scan_sum"] = counts["fused_scan_sum"]
    expect = oracle_q6(lineitem, "1994-01-01", 2400)
    print(f"Q6 = {rows}, numpy oracle = {expect}, K1 launches = "
          f"{launches['fused_scan_sum']}")
    if rows != [[expect]]:
        raise AssertionError("Q6 disagrees with the numpy oracle")
    known = KNOWN_Q6.get(args.sf)
    if known is not None and expect != known:
        raise AssertionError(f"Q6 {expect} != known answer {known}")
    rows2 = conn.sql(Q6_OFF_EDGE).strings()
    expect2 = oracle_q6(lineitem, "1994-01-10", 2350)
    print(f"Q6 off-edge = {rows2}, numpy oracle = {expect2}")
    if rows2 != [[expect2]]:
        raise AssertionError("off-edge Q6 disagrees with the numpy oracle")

    oracles = {"Q1": lambda: oracle_q1(lineitem),
               "Q12": lambda: oracle_q12(lineitem, orders),
               "Q3": lambda: oracle_q3(cat.table("customer"), orders,
                                       lineitem)}
    # luts of each K2 launch: one launch per PK join on sorted keys, with
    # the row lut and every value lut the join reads
    k2_luts = {"Q1": [], "Q12": [2], "Q3": [4]}
    launches["monotone_gather"] = 0
    for name, sql in (("Q1", Q1), ("Q12", Q12), ("Q3", Q3)):
        print(conn.explain(sql))
        rows, counts = counted(lambda: conn.sql(sql).strings())
        k2_launches = counts["monotone_gather"]
        want = oracles[name]()
        print(f"{name}: {len(rows)} rows, K2 launches = {k2_launches}")
        for row in rows[:4]:
            print("   ", row)
        if not rows_agree(rows, want):
            raise AssertionError(f"{name} disagrees with the numpy oracle: "
                                 f"{rows} vs {want}")
        if k2_launches != len(k2_luts[name]):
            raise AssertionError(f"{name} launched K2 {k2_launches} times, "
                                 f"expected {len(k2_luts[name])}")
        launches["monotone_gather"] += k2_launches
    print(f"Q1, Q12, Q3 equal their numpy oracles; K2 launches "
          f"{launches['monotone_gather']}")

    # each kernel on the main path's own inputs, against its plain version
    words, payloads, packed = bench.q6_kernel_inputs(conn)
    if int(fs.fused_scan_sum(words, payloads, packed)) != \
            int(fs.fused_scan_sum_reference(words, payloads, packed)):
        raise AssertionError("K1 disagrees with plain on Q6's inputs")
    print(f"K1 on Q6 inputs: words {tuple(words.shape)} payload "
          f"{tuple(payloads[0].shape)} packed={packed}; kernel == plain")
    k2_calls = {}
    for name, sql in (("Q12", Q12), ("Q3", Q3)):
        k2_calls[name] = main_path_inputs(conn, sql)
        got = [len(luts) for luts, _ in k2_calls[name]]
        if got != k2_luts[name]:
            raise AssertionError(f"{name} gathered {got} luts per K2 call, "
                                 f"expected {k2_luts[name]}")
        for luts, keys in k2_calls[name]:
            err["monotone_gather"] = max(err["monotone_gather"], k2_compare(
                f"{name} probe (l_orderkey), {len(luts)} luts", luts,
                keys)[0])

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
    phase("entry point: bench")
    line, counts = counted(lambda: bench.run(cat, device, args.sf),
                           "fused_scan_sum", "monotone_gather")
    print(json.dumps(line))
    print(f"bench launches: K1 {counts['fused_scan_sum']}, K2 "
          f"{counts['monotone_gather']}")

    table = [{"name": name, "route": "cuda",
              "source": f"duckdb_cubit_tpu_torch/csrc/{name}.cu",
              "replaces": REPLACES[name], "launches": launches[name],
              "max_abs_err": err[name], "ms": times[name][0],
              "plain_ms": times[name][1], "bound_ms": bounds[name],
              "bound_by": "bytes", "library_ms": library[name]}
             for name in REPLACES]
    k2_row = next(r for r in table if r["name"] == "monotone_gather")
    k2_row.update(luts_per_launch=k2_luts, passes=k2_passes)
    for row in table:
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
