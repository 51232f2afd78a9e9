"""Golden-answer harness: diff engine output against the reference answers.

The analog of the reference's sqllogictest answer-diff (reference
test/sql/tpch/tpch_sf01.test_slow comparing PRAGMA tpch(i) with
<FILE>:extension/tpch/dbgen/answers/...).  Answers are read directly from the
read-only reference mount; numeric cells compare with a tight relative
tolerance (covering double formatting differences), everything else exactly.
"""

from __future__ import annotations

import os

ANSWER_DIR = "/root/reference/extension/tpch/dbgen/answers"


def answers_available() -> bool:
    return os.path.isdir(ANSWER_DIR)


def load_answer(sf, query: int):
    sf_name = {0.01: "sf0.01", 0.1: "sf0.1", 1: "sf1", 1.0: "sf1",
               100: "sf100", 100.0: "sf100"}[sf]
    path = os.path.join(ANSWER_DIR, sf_name, f"q{query:02d}.csv")
    with open(path) as f:
        lines = f.read().rstrip("\n").split("\n")
    header = lines[0].split("|")
    rows = [line.split("|") for line in lines[1:]]
    return header, rows


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def cells_equal(got: str, want: str, rel_tol: float = 1e-9) -> bool:
    if got == want:
        return True
    if _is_number(got) and _is_number(want):
        g, w = float(got), float(want)
        if g == w:
            return True
        return abs(g - w) <= rel_tol * max(abs(g), abs(w), 1e-300)
    return False


def compare(got_rows: list[list[str]], sf, query: int,
            ordered: bool = True) -> list[str]:
    """-> list of mismatch descriptions (empty = pass)."""
    header, want_rows = load_answer(sf, query)
    problems = []
    if len(got_rows) != len(want_rows):
        problems.append(
            f"row count: got {len(got_rows)}, want {len(want_rows)}")
        return problems
    if not ordered:
        got_rows = sorted(got_rows)
        want_rows = sorted(want_rows)
    for i, (g, w) in enumerate(zip(got_rows, want_rows)):
        if len(g) != len(w):
            problems.append(f"row {i}: column count {len(g)} != {len(w)}")
            continue
        for j, (gc, wc) in enumerate(zip(g, w)):
            if not cells_equal(gc, wc):
                problems.append(
                    f"row {i} col {header[j] if j < len(header) else j}: "
                    f"got {gc!r}, want {wc!r}")
                if len(problems) > 10:
                    return problems
    return problems
