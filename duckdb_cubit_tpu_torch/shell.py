"""Interactive SQL shell over the port's `Connection`.

Counterpart of the reference's `tools/shell.py` (the analog of the reference
DuckDB's CLI, tools/shell/): a REPL with dot-commands for the catalog,
timing, EXPLAIN and the TPC-H queries.  Statements may span lines up to a
`;`; a failing one prints `error: ...`; at most 100 rows are shown (40 for
`\\tpch`).

    python -m duckdb_cubit_tpu_torch.shell [--sf 0.01] [--device cuda|cpu]

Commands: `\\q` quit, `\\d` tables and indexes, `\\timing` on / off,
`\\explain <sql>`, `\\tpch <n>`.  The device is the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import time

from .api import connect


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=None,
                    help="load TPC-H at this scale factor")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the tables live (default: the card)")
    args = ap.parse_args(argv)

    print("duckdb_cubit_tpu_torch shell — \\q quit, \\d tables, \\timing, "
          "\\explain <sql>, \\tpch <n>")
    t0 = time.time()
    conn = connect(sf=args.sf, device=args.device)
    if args.sf is not None:
        print(f"TPC-H sf{args.sf} loaded in {time.time()-t0:.1f}s")
    timing = True
    buf = []
    while True:
        try:
            prompt = "sql> " if not buf else "...> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not buf and line.startswith("\\"):
            cmd, *rest = line.split(None, 1)
            if cmd in ("\\q", "\\quit"):
                break
            if cmd == "\\d":
                for name, t in conn.catalog.tables.items():
                    idx = ",".join(t.indexes) or "-"
                    print(f"{name:12} {t.num_rows:>12} rows  indexes: {idx}")
                continue
            if cmd == "\\timing":
                timing = not timing
                print(f"timing {'on' if timing else 'off'}")
                continue
            if cmd == "\\explain" and rest:
                print(conn.explain(rest[0]))
                continue
            if cmd == "\\tpch" and rest:
                t0 = time.time()
                res = conn.tpch_query(int(rest[0]))
                out = res.strings()
                dt = time.time() - t0
                for r in out[:40]:
                    print(" | ".join(r))
                print(f"({len(out)} rows{f', {dt:.3f}s' if timing else ''})")
                continue
            print(f"unknown command {cmd}")
            continue
        buf.append(line)
        joined = "\n".join(buf)
        if not joined.rstrip().endswith(";") and line.strip() != "":
            continue
        buf = []
        sql = joined.strip().rstrip(";")
        if not sql:
            continue
        try:
            t0 = time.time()
            res = conn.sql(sql)
            rows = res.strings()
            dt = time.time() - t0
            for r in rows[:100]:
                print(" | ".join(r))
            extra = f", {dt:.3f}s" if timing else ""
            if res.status and not rows:
                print(f"{res.status}{f' ({dt:.3f}s)' if timing else ''}")
            else:
                print(f"({len(rows)} rows{extra})")
        except Exception as e:
            print(f"error: {e}")


if __name__ == "__main__":
    main()
