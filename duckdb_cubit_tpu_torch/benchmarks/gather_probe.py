"""Gather forms from a small table on the card: the port of
`benchmarks/pallas_gather_probe.py`.

    python -m duckdb_cubit_tpu_torch.benchmarks.gather_probe

The reference's inputs (numpy `default_rng(0)`): N = 2**22 int32 indices
in [0, T), a T = 2**13 int32 table (32 KB) and N lane indices in [0, 128).
Its forms, each checked bit for bit against its plain torch body:

  A   table_gather, 1-D table and indices           (kernel K5a, for `kA`)
  A2  table_gather, (T/128, 128) and (N/128, 128)   (kernel K5a, for `kA2`)
  C   table_gather, the shapes of A2                (kernel K5a, for `kC`)
  B   lane_gather, out[r, c] = tab2[r % 64, li[r, c]]  (kernel K5b, for `kB`)
  D   the plain torch gather `tab[idx]`, standing in for the reference's
      XLA take baseline

`kC`'s one-hot compare / select / sum is Mosaic's way to a gather without a
gather instruction; on the card it is the same gather as A2, so C is the
same call.  On the card each form is timed with CUDA events, with the L2
cache flushed and back to back, in ms and Mrow/s, and each kernel against
its plain body.  The reference logs a failed form and goes on; here any
failed check raises.  On a CPU device the checks run and nothing is timed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import gather_forms as gf
from . import timing

N = 1 << 22
T = 1 << 13


def inputs(n: int, t: int, device):
    """-> (idx (n,), table (t,), lane_idx (n/128, 128)), int32."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, t, n).astype(np.int32)
    table = rng.integers(0, 1 << 30, t).astype(np.int32)
    lane_idx = rng.integers(0, gf.LANES, n).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (idx, table, lane_idx.reshape(-1, gf.LANES)))


def run(device) -> dict:
    """Check every form and, on the card, time them; -> a summary (times
    are None off the card)."""
    device = torch.device(device)
    idx, table, li2 = inputs(N, T, device)
    idx2 = idx.reshape(-1, gf.LANES)
    tab2 = table.reshape(-1, gf.LANES)
    cases = {
        "A": (lambda: gf.table_gather(table, idx),
              lambda: gf.table_gather_reference(table, idx)),
        "A2": (lambda: gf.table_gather(tab2, idx2),
               lambda: gf.table_gather_reference(tab2, idx2)),
        "C": (lambda: gf.table_gather(tab2, idx2),
              lambda: gf.table_gather_reference(tab2, idx2)),
        "B": (lambda: gf.lane_gather(tab2, li2),
              lambda: gf.lane_gather_reference(tab2, li2)),
    }
    for name, (fn, plain) in cases.items():
        (out, bad), (want, want_bad) = fn(), plain()
        if int(bad) or int(want_bad) or not torch.equal(out, want):
            raise AssertionError(f"gather form {name} disagrees with its "
                                 f"plain body (bad indices {int(bad)})")
    gathered = table[idx.to(torch.int64)]
    if not torch.equal(gathered, gf.table_gather(table, idx)[0]):
        raise AssertionError("form D disagrees with form A")
    print(f"gather_probe: N={N} T={T}: A, A2, C, B equal their plain bodies "
          f"and D, bit for bit")
    # bytes each kernel must move (its bound): indices read and outputs
    # written once, and the table once
    summary = {"n": N, "table": T, "forms": {}, "kernels": {},
               "bytes": {"table_gather": 8 * N + 4 * T,
                         "lane_gather": 8 * N + 4 * T},
               "library_ms": {}}
    if device.type != "cuda":
        return summary
    card = timing.card_line()
    flush = timing.flush_buffer(device)
    fns = {name: fn for name, (fn, _) in cases.items()}
    fns["D"] = lambda: table[idx.to(torch.int64)]
    for name, fn in fns.items():
        cold = timing.time_cold(fn, 30, flush)
        warm = timing.time_warm(fn, 50)
        summary["forms"][name] = {"ms_cold": cold, "ms_warm": warm,
                                  "rows_per_s": N / cold * 1e3}
        print(f"  {name:3s} {cold:.4f} ms (L2 flushed)  {N / cold / 1e3:.1f} "
              f"Mrow/s   back to back {warm:.4f} ms  [{card}]")
    # one library call per kernel: form D's `tab[idx]` for K5a, and for
    # K5b `torch.gather` along the lane axis of the table rows, repeated by a
    # stride-0 view (its int64 index made before timing)
    summary["library_ms"]["table_gather"] = summary["forms"]["D"]["ms_cold"]
    rows = tab2.shape[0]
    tab3 = tab2.expand(li2.shape[0] // rows, rows, gf.LANES)
    li3 = li2.to(torch.int64).reshape(tab3.shape)
    if not torch.equal(torch.gather(tab3, 2, li3).reshape(li2.shape),
                       gf.lane_gather(tab2, li2)[0]):
        raise AssertionError("torch.gather disagrees with form B")
    summary["library_ms"]["lane_gather"] = timing.time_cold(
        lambda: torch.gather(tab3, 2, li3), 30, flush)
    print(f"  torch.gather along the lanes (K5b's library call) "
          f"{summary['library_ms']['lane_gather']:.4f} ms (L2 flushed)  "
          f"[{card}]")
    print("gather_probe: K5a (form A) against its plain body")
    summary["kernels"]["table_gather"] = timing.turns(
        cases["A"][0], cases["A"][1], flush, card)
    print("gather_probe: K5b (form B) against its plain body")
    summary["kernels"]["lane_gather"] = timing.turns(
        cases["B"][0], cases["B"][1], flush, card)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
