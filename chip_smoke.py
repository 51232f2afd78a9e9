"""GPU smoke run of the PyTorch + CUDA port: TPC-H Q6 through the public API.

    python3 chip_smoke.py            # SF1 (6,001,215 lineitem rows)
    python3 chip_smoke.py --sf 10    # SF10

Needs one CUDA card, the CUDA toolkit (nvcc) and g++.  Phases, each of which
raises on failure (non-zero exit):

  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: the fused scan-sum kernel from duckdb_cubit_tpu_torch/csrc/;
  3. kernel parity: the kernel against its plain torch version on the card,
     bit-exact, in every mode (single, pair, packed), ragged and aligned
     lengths, empty / full / sparse masks, and int64 accumulation past 2**31;
  4. main path: connect(sf, device="cuda"), every table / index tensor on the
     card, Q6 and an off-bin-edge Q6 variant through conn.sql() against a
     numpy oracle on the generated columns (and Q6 against its known
     answer); the kernel's launch count must rise during the query, and the
     kernel is compared with its plain version on Q6's own inputs;
  5. timing: Q6 end to end (median of warm runs), kernel alone against the
     plain version alone at Q6's shapes, effective GB/s.

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
# TPC-H Q6 answers: SF1 is the specification's published answer; SF10 is the
# reference package's result, checked there against a numpy oracle
KNOWN_Q6 = {1.0: "123141078.2283", 10.0: "1230113636.0101"}
REPLACES = "duckdb_cubit_tpu/ops/pallas_kernels.py:148"
L2_FLUSH_BYTES = 256 << 20
# warm Q6 runs behind each end-to-end and profiled time
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


def parity_cases(device):
    """(label, words, payloads, packed) on the card, made from a seed."""
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
    from duckdb_cubit_tpu_torch.ops import bitmap as bm
    from duckdb_cubit_tpu_torch.ops import fused_scan as fs

    phase("build")
    t0 = time.perf_counter()
    fs.build()
    print(f"fused_scan_sum built in {time.perf_counter() - t0:.2f} s")
    for line in fs.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    phase("kernel parity (bit-exact)")
    max_err = 0
    for label, words, payloads, packed in parity_cases(device):
        got = fs.fused_scan_sum(words, payloads, packed)
        want = fs.fused_scan_sum_reference(words, payloads, packed)
        torch.cuda.synchronize()
        err = abs(int(got) - int(want))
        max_err = max(max_err, err)
        print(f"  {label:40s} kernel={int(got)} plain={int(want)}")
        if err:
            raise AssertionError(f"kernel disagrees with plain ({label})")
    print(f"parity launches: {fs.launch_count}")

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
    lineitem = conn.catalog.table("lineitem")
    print(f"lineitem rows {lineitem.num_rows}, capacity {lineitem.capacity}")
    print(conn.explain(Q6))

    fs.launch_count = 0
    rows = conn.sql(Q6).strings()
    torch.cuda.synchronize()
    launches = fs.launch_count
    expect = oracle_q6(lineitem, "1994-01-01", 2400)
    print(f"Q6 = {rows}, numpy oracle = {expect}, launches = {launches}")
    if rows != [[expect]]:
        raise AssertionError("Q6 disagrees with the numpy oracle")
    known = KNOWN_Q6.get(args.sf)
    if known is not None and expect != known:
        raise AssertionError(f"Q6 {expect} != known answer {known}")
    if launches < 1:
        raise AssertionError("Q6 did not launch the fused scan-sum kernel")
    rows2 = conn.sql(Q6_OFF_EDGE).strings()
    expect2 = oracle_q6(lineitem, "1994-01-10", 2350)
    print(f"Q6 off-edge = {rows2}, numpy oracle = {expect2}")
    if rows2 != [[expect2]]:
        raise AssertionError("off-edge Q6 disagrees with the numpy oracle")

    # the kernel on Q6's own inputs, against its plain version
    plan = conn.binder.bind_sql(Q6)
    conn.executor.execute(plan)
    agg = next(op for op in conn.executor.plan.walk()
               if type(op).__name__ == "GroupAggregate")
    words = agg.children[0]._words
    payloads, packed = agg._kernel
    got = fs.fused_scan_sum(words, payloads, packed)
    want = fs.fused_scan_sum_reference(words, payloads, packed)
    if int(got) != int(want):
        raise AssertionError("kernel disagrees with plain on Q6's inputs")
    print(f"Q6 inputs: words {tuple(words.shape)} payload "
          f"{tuple(payloads[0].shape)} packed={packed}; kernel == plain")

    phase("timing")
    print("card:", card)
    e2e = []
    for _ in range(RUNS + 2):
        t0 = time.perf_counter()
        conn.sql(Q6).strings()
        e2e.append((time.perf_counter() - t0) * 1e3)
    e2e_ms = statistics.median(e2e[2:])
    n = payloads[0].shape[0]
    print(f"Q6 end to end: median {e2e_ms:.3f} ms over {RUNS} warm runs "
          f"({lineitem.num_rows / e2e_ms / 1e6:.3f} Grow/s)  [{card}]")
    dev_ms, wall_ms, top = device_busy_share(lambda: conn.sql(Q6).strings(),
                                             RUNS)
    print(f"Q6 profiled: device kernels {dev_ms:.4f} ms of {wall_ms:.4f} ms "
          f"wall per query, device busy share {dev_ms / wall_ms:.4f}  [{card}]")
    print(f"  top device kernels per query: {top}")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    kernel = lambda: fs.fused_scan_sum(words, payloads, packed)  # noqa: E731
    plain = lambda: fs.fused_scan_sum_reference(words, payloads, packed)  # noqa: E731
    timings = {}
    for name, fn in (("plain", plain), ("kernel", kernel), ("kernel2", kernel),
                     ("plain2", plain)):
        timings[name] = (time_cold(fn, 30, flush), time_warm(fn, 50))
    ms = min(timings["kernel"][0], timings["kernel2"][0])
    plain_ms = min(timings["plain"][0], timings["plain2"][0])
    nominal = n * (4 + 0.125 if packed else 4 * len(payloads) + 0.125)
    for name, (cold, warm) in timings.items():
        print(f"  {name:8s} cold (L2 flushed, device time) {cold:.4f} ms   "
              f"back to back (host launch included) {warm:.4f} ms  [{card}]")
    print(f"kernel {ms:.4f} ms vs plain {plain_ms:.4f} ms at n={n} "
          f"(L2 flushed); effective {nominal / ms / 1e6:.1f} GB/s of "
          f"{nominal / n:.3f} B/row nominal traffic  [{card}]")

    print(json.dumps({"kernels": [{
        "name": "fused_scan_sum", "route": "cuda",
        "source": "duckdb_cubit_tpu_torch/csrc/fused_scan_sum.cu",
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
