"""GPU smoke run of the PyTorch + CUDA port: TPC-H Q6, Q1, Q12 and Q3 through
the public API.

    python3 chip_smoke.py            # SF1 (6,001,215 lineitem rows)
    python3 chip_smoke.py --sf 10    # SF10

Needs one CUDA card, the CUDA toolkit (nvcc) and g++.  Phases, each of which
raises on failure (non-zero exit):

  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: both kernels from duckdb_cubit_tpu_torch/csrc/, one nvcc each,
     started together: K1 the fused scan-sum, K2 the monotone gather;
  3. kernel parity: each kernel against its plain torch version on the card,
     bit-exact.  K1 in every mode (single, pair, packed), ragged and aligned
     lengths, empty / full / sparse masks, int64 accumulation past 2**31.
     K2 on dense keys of variable multiplicity, absent slots, sparse keys,
     out-of-order and out-of-range keys (the overflow count must match),
     a length that is a multiple of no block size, and gather_via_sort on
     random keys;
  4. main path: connect(sf, device="cuda"), every table / index tensor on the
     card.  Q6 (and an off-bin-edge variant), Q1, Q12 and Q3 through
     conn.sql() against numpy oracles on the generated columns (Q6 also
     against its known answer).  Each query runs with the launch counts set
     to 0 just before it and read just after: K1 must launch in Q6, K2 at
     least twice in Q12 (the probe and the o_orderpriority value fetch) and
     at least once in Q3.  Each kernel is then compared with its plain
     version on the inputs the main path gave it;
  5. timing: each query end to end (median of warm runs), the device busy
     share of each from torch.profiler with its top device kernels, and
     each kernel alone against its plain version at the main path's shapes
     with the L2 cache flushed.

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
REPLACES_K1 = "duckdb_cubit_tpu/ops/pallas_kernels.py:148"
REPLACES_K2 = "duckdb_cubit_tpu/ops/pallas_probe.py:170"
# relative tolerance of DOUBLE cells against the numpy oracle: the engine
# and numpy sum floats in different orders
DOUBLE_RTOL = 1e-9
L2_FLUSH_BYTES = 256 << 20
# warm runs behind each end-to-end and profiled time
RUNS = 20


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


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


def device_busy_share(fn, iters: int) -> tuple[float, float, str]:
    """(device kernel ms, wall ms, top kernels) over `iters` calls of `fn`,
    from torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    names = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / iters:.4f} ms"
                      for e in top)
    return device_ms / iters, wall_ms / iters, names


def time_cold(fn, iters: int, flush: torch.Tensor) -> float:
    """Median ms of `fn` with the L2 cache flushed before each call."""
    times = []
    for _ in range(iters):
        flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_warm(fn, iters: int) -> float:
    """Mean ms of `fn` over back-to-back calls (inputs may sit in L2)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def build_kernels():
    """Both kernels, one nvcc each, started together."""
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs
    from duckdb_cubit_tpu_torch.ops import probe

    kernels = {"fused_scan_sum": fs.KERNEL, "monotone_gather": probe.KERNEL}

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


def k2_compare(label: str, lut: torch.Tensor, keys: torch.Tensor):
    """K2 against its plain body on one input, bit-exact; -> (max |error|,
    the kernel's overflow count)."""
    from duckdb_cubit_tpu_torch.ops import probe

    out, ovf = probe.monotone_gather(lut, keys)
    want, want_ovf = probe.monotone_gather_reference(lut, keys)
    torch.cuda.synchronize()
    err = max(int((out.to(torch.int64) - want).abs().max()) if len(keys)
              else 0, abs(int(ovf) - int(want_ovf)))
    print(f"  K2 {label:40s} n={len(keys)} lut={len(lut)} "
          f"overflow kernel={int(ovf)} plain={int(want_ovf)} max_err={err}")
    if err:
        raise AssertionError(f"K2 disagrees with plain ({label})")
    return err, int(ovf)


def k2_parity(device) -> int:
    from duckdb_cubit_tpu_torch.ops import probe

    max_err = 0
    for label, lut, keys in k2_parity_cases():
        err, ovf = k2_compare(label, torch.as_tensor(lut, device=device),
                              torch.as_tensor(keys, device=device))
        max_err = max(max_err, err)
        if label.startswith("out-of-order"):
            if ovf < 2:
                raise AssertionError("K2 did not count the broken keys")
        elif ovf:
            raise AssertionError(f"K2 overflowed on sorted keys ({label})")
    rng = np.random.default_rng(2)
    lut = torch.as_tensor(k2_parity_cases()[0][1], device=device)
    keys = torch.as_tensor(rng.integers(0, len(lut), 2_000_000)
                           .astype(np.int32), device=device)
    got, ovf = probe.gather_via_sort(lut, keys)
    want, want_ovf = probe.gather_via_sort(lut.cpu(), keys.cpu())
    err = max(int((got.cpu().to(torch.int64) - want).abs().max()),
              abs(int(ovf) - int(want_ovf)))
    print(f"  K2 gather_via_sort, random keys         n={len(keys)} "
          f"overflow={int(ovf)} max_err={err}")
    if err or int(ovf):
        raise AssertionError("gather_via_sort disagrees with plain")
    return max(max_err, err)


def counted(conn, sql: str):
    """Rows of one query, with each kernel's launch count set to 0 just
    before it and read just after: -> (rows, K1 launches, K2 launches)."""
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs
    from duckdb_cubit_tpu_torch.ops import probe

    fs.launch_count = 0
    probe.launch_count = 0
    rows = conn.sql(sql).strings()
    torch.cuda.synchronize()
    return rows, fs.launch_count, probe.launch_count


def main_path_inputs(conn, sql: str) -> list:
    """The (lut, keys) of every K2 call a query makes (a separate run: the
    recording wrapper is not the counted main path)."""
    from duckdb_cubit_tpu_torch.ops import probe

    calls = []
    real = probe.monotone_gather

    def recording(lut, keys):
        calls.append((lut, keys))
        return real(lut, keys)
    probe.monotone_gather = recording
    try:
        conn.sql(sql).strings()
    finally:
        probe.monotone_gather = real
    return calls


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
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs
    from duckdb_cubit_tpu_torch.ops import probe

    phase("build")
    build_kernels()

    phase("kernel parity (bit-exact)")
    k1_err = k1_parity(device)
    k2_err = k2_parity(device)

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

    rows, k1_launches, _ = counted(conn, Q6)
    expect = oracle_q6(lineitem, "1994-01-01", 2400)
    print(f"Q6 = {rows}, numpy oracle = {expect}, K1 launches = {k1_launches}")
    if rows != [[expect]]:
        raise AssertionError("Q6 disagrees with the numpy oracle")
    known = KNOWN_Q6.get(args.sf)
    if known is not None and expect != known:
        raise AssertionError(f"Q6 {expect} != known answer {known}")
    if k1_launches < 1:
        raise AssertionError("Q6 did not launch the fused scan-sum kernel")
    rows2 = conn.sql(Q6_OFF_EDGE).strings()
    expect2 = oracle_q6(lineitem, "1994-01-10", 2350)
    print(f"Q6 off-edge = {rows2}, numpy oracle = {expect2}")
    if rows2 != [[expect2]]:
        raise AssertionError("off-edge Q6 disagrees with the numpy oracle")

    oracles = {"Q1": lambda: oracle_q1(lineitem),
               "Q12": lambda: oracle_q12(lineitem, orders),
               "Q3": lambda: oracle_q3(cat.table("customer"), orders,
                                       lineitem)}
    least_k2 = {"Q1": 0, "Q12": 2, "Q3": 1}
    k2_launches = 0
    for name, sql in (("Q1", Q1), ("Q12", Q12), ("Q3", Q3)):
        print(conn.explain(sql))
        rows, _, launches = counted(conn, sql)
        want = oracles[name]()
        print(f"{name}: {len(rows)} rows, K2 launches = {launches}")
        for row in rows[:4]:
            print("   ", row)
        if not rows_agree(rows, want):
            raise AssertionError(f"{name} disagrees with the numpy oracle: "
                                 f"{rows} vs {want}")
        if launches < least_k2[name]:
            raise AssertionError(f"{name} launched K2 {launches} times, "
                                 f"expected at least {least_k2[name]}")
        k2_launches += launches
    print(f"Q1, Q12, Q3 equal their numpy oracles; K2 launches {k2_launches}")

    # each kernel on the main path's own inputs, against its plain version
    plan = conn.binder.bind_sql(Q6)
    conn.executor.execute(plan)
    agg = next(op for op in conn.executor.plan.walk()
               if type(op).__name__ == "GroupAggregate")
    words = agg.children[0]._words
    payloads, packed = agg._kernel
    if int(fs.fused_scan_sum(words, payloads, packed)) != \
            int(fs.fused_scan_sum_reference(words, payloads, packed)):
        raise AssertionError("K1 disagrees with plain on Q6's inputs")
    print(f"K1 on Q6 inputs: words {tuple(words.shape)} payload "
          f"{tuple(payloads[0].shape)} packed={packed}; kernel == plain")
    q12_calls = main_path_inputs(conn, Q12)
    for i, (lut, keys) in enumerate(q12_calls):
        label = "Q12 probe (l_orderkey)" if i == 0 \
            else f"Q12 value fetch {i}"
        k2_err = max(k2_err, k2_compare(label, lut, keys)[0])

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

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=device)

    def turns(kernel, plain):
        """plain, kernel, kernel, plain: -> (kernel ms, plain ms), the
        better of each pair, L2 flushed."""
        timings = {}
        for name, fn in (("plain", plain), ("kernel", kernel),
                         ("kernel2", kernel), ("plain2", plain)):
            timings[name] = (time_cold(fn, 30, flush), time_warm(fn, 50))
        for name, (cold, warm) in timings.items():
            print(f"  {name:8s} cold (L2 flushed, device time) {cold:.4f} ms"
                  f"   back to back (host launch included) {warm:.4f} ms  "
                  f"[{card}]")
        return (min(timings["kernel"][0], timings["kernel2"][0]),
                min(timings["plain"][0], timings["plain2"][0]))

    print("K1 at Q6's inputs:")
    k1_ms, k1_plain_ms = turns(
        lambda: fs.fused_scan_sum(words, payloads, packed),
        lambda: fs.fused_scan_sum_reference(words, payloads, packed))
    n = payloads[0].shape[0]
    nominal = n * (4 + 0.125 if packed else 4 * len(payloads) + 0.125)
    print(f"K1 {k1_ms:.4f} ms vs plain {k1_plain_ms:.4f} ms at n={n} "
          f"(L2 flushed); effective {nominal / k1_ms / 1e6:.1f} GB/s of "
          f"{nominal / n:.3f} B/row nominal traffic  [{card}]")
    lut, keys = q12_calls[0]
    print(f"K2 at Q12's probe inputs (keys {keys.shape[0]}, lut "
          f"{lut.shape[0]} slots):")
    k2_ms, k2_plain_ms = turns(
        lambda: probe.monotone_gather(lut, keys),
        lambda: probe.monotone_gather_reference(lut, keys))
    bare_ms = time_cold(lambda: lut[keys.to(torch.int64)], 30, flush)
    print(f"K2 {k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms (bare lut[keys] "
          f"gather {bare_ms:.4f} ms) at n={keys.shape[0]} (L2 flushed); "
          f"{keys.shape[0] * 12 / k2_ms / 1e6:.1f} GB/s of 12 B/key nominal "
          f"traffic  [{card}]")

    print(json.dumps({"kernels": [
        {"name": "fused_scan_sum", "route": "cuda",
         "source": "duckdb_cubit_tpu_torch/csrc/fused_scan_sum.cu",
         "replaces": REPLACES_K1, "launches": k1_launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "monotone_gather", "route": "cuda",
         "source": "duckdb_cubit_tpu_torch/csrc/monotone_gather.cu",
         "replaces": REPLACES_K2, "launches": k2_launches,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
