"""The yardstick of the kernels' roofline shares.

The least bytes a query's plan must move, counted from its inputs (each
input byte read once, each output byte written once), whatever kernels
implement it, over the card's published memory bandwidth.  The two byte
rules are frozen copies of the engine's own (`ops.fused_scan.
scan_sum_bytes` and `ops.probe.gather_bytes`), taking the benchmark's own
arrays instead of the engine's tensors.
"""

from __future__ import annotations

import numpy as np

from .reference.queries import add_months, days

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s (700 W)
PEAK_BYTES_PER_S = 3.35e12


def scan_sum_bytes(mask: np.ndarray, n_payloads: int) -> int:
    """A masked sum over n rows through a bitmap: the words that cover the
    rows (4 B each), and per payload column one 32-B sector for each
    nonzero byte of them (a word byte selects 8 rows, 32 B of int32
    payload)."""
    n = len(mask)
    words = (n + 31) // 32
    pad = np.zeros(words * 32, dtype=bool)
    pad[:n] = mask
    nonzero = int(np.count_nonzero(pad.reshape(-1, 8).any(axis=1)))
    return 4 * words + 32 * nonzero * n_payloads


def gather_bytes(keys: np.ndarray, n_luts: int) -> int:
    """A key-to-row probe of `n_luts` tables: each key read once (4 B),
    each output written once (4 B a key and table), and one 32-B table
    sector per 8 distinct keys and table (primary-key tables of TPC-H order
    keys: 8 of every 32 slots filled)."""
    n = len(keys)
    distinct = len(np.unique(keys))
    return 4 * n + 4 * n * n_luts + 32 * n_luts * (distinct >> 3)


def q6_bytes(db, p: dict) -> int:
    """Q6: the scan over the rows its predicate selects, summing
    l_extendedprice * l_discount (two payload columns)."""
    li = db.table("lineitem")
    ship = np.asarray(li["l_shipdate"])
    disc = np.asarray(li["l_discount"])
    lo, hi = days(p["date"]), days(add_months(p["date"], 12))
    mask = ((ship >= lo) & (ship < hi) & (disc >= p["discount"] - 1)
            & (disc <= p["discount"] + 1)
            & (np.asarray(li["l_quantity"]) < p["quantity"] * 100))
    return scan_sum_bytes(mask, 2)


def q12_bytes(db, p: dict) -> int:
    """Q12: the three date columns read over the rows that the indexed
    predicates (ship mode, receipt-date range) leave, and the probe of the
    surviving rows' order keys into the orders' row and priority tables."""
    li = db.table("lineitem")
    mode = np.asarray(li["l_shipmode"])
    receipt = np.asarray(li["l_receiptdate"])
    commit = np.asarray(li["l_commitdate"])
    lo, hi = days(p["date"]), days(add_months(p["date"], 12))
    cand = (((mode == p["shipmode1"].encode())
             | (mode == p["shipmode2"].encode()))
            & (receipt >= lo) & (receipt < hi))
    keep = cand & (commit < receipt) & (np.asarray(li["l_shipdate"]) < commit)
    return (scan_sum_bytes(cand, 3)
            + gather_bytes(np.asarray(li["l_orderkey"])[keep], 2))


BYTES = {6: q6_bytes, 12: q12_bytes}


def share_pct(n_bytes: int, device_s: float) -> float | None:
    """The bound's time over the measured device time, in percent."""
    if device_s <= 0:
        return None
    return 100.0 * (n_bytes / PEAK_BYTES_PER_S) / device_s
