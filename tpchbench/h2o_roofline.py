"""The byte rule of db-benchmark's roofline share (`h2o10_roofline`).

Question 10 groups every row of `x` by its six keys and sums `v3`: the
least it must move is its seven input columns read once, each at the width
the engine stores it (`stored_width`).  The output (about one row a row) is
left out, so the share is a floor of what the question moves; over the
card's published bandwidth (`roofline.share_pct`).
"""

from __future__ import annotations

import numpy as np

Q10_COLUMNS = ("id1", "id2", "id3", "id4", "id5", "id6", "v3")


def stored_width(values: np.ndarray) -> int:
    """Bytes a value of the column held on the card: a string column's
    dictionary codes and an integer column at the narrowest signed width
    that holds them with one value of headroom at either end (the
    engine's storage codec), a DOUBLE at 8."""
    if values.dtype.kind == "f":
        return 8
    if values.dtype.kind == "S":
        lo, hi = 0, len(np.unique(values)) - 1
    else:
        lo, hi = int(values.min()), int(values.max())
    for t in (np.int8, np.int16, np.int32):
        info = np.iinfo(t)
        if info.min < lo and hi < info.max:
            return np.dtype(t).itemsize
    return 8


def h2o10_bytes(x: dict) -> int:
    return sum(stored_width(x[c]) * len(x[c]) for c in Q10_COLUMNS)


BYTES = {10: h2o10_bytes}
