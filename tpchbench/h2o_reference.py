"""db-benchmark's ten group-by questions in plain PyTorch: the reference of
the `h2o` suite (`suites/h2o.py`).

Each question is computed straight from its definition over the table `x`
of the groupby task (`id1`-`id3` strings "id001" / "id0000000001", `id4`-
`id6`, `v1`, `v2` integers, `v3` a DOUBLE), with no kernel and nothing of
the engine under test: groups by `torch.unique` over the key tuple (the six
keys of question 10 as two int64 halves), medians by sorting each group's
values, corr by the two-pass centred formula, the top two of a partition by
sorting it.  It runs where `device` says: the CPU in the tests, the card in
a run.  Values are held in `dtype`: float64 for the reference, float32 for
the control.

`answer(n, data)` gives question n's whole answer, `{column: tensor}`, the
key columns as the ids' integers and NULL as NaN; `checksum(n, answer)`
the one row the benchmark's statement returns for it: the answer's row
count, then the sum of each of its `terms` (NULLs skipped).
"""

from __future__ import annotations

import numpy as np
import torch

# a float32 matrix product may otherwise run in TF32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KEYS = ("id1", "id2", "id3", "id4", "id5", "id6")
# the keys that are integers (the others are strings)
INT_KEYS = ("id4", "id5", "id6")
# per question: its group keys, and db-benchmark's checksum columns with
# their kinds ("x" an integer compared as text, "f" a DOUBLE)
QUESTIONS = {
    1: (("id1",), (("v1", "x"),)),
    2: (("id1", "id2"), (("v1", "x"),)),
    3: (("id3",), (("v1", "x"), ("v3", "f"))),
    4: (("id4",), (("v1", "f"), ("v2", "f"), ("v3", "f"))),
    5: (("id6",), (("v1", "x"), ("v2", "x"), ("v3", "f"))),
    6: (("id4", "id5"), (("median_v3", "f"), ("sd_v3", "f"))),
    7: (("id3",), (("range_v1_v2", "x"),)),
    8: (("id6",), (("largest2_v3", "f"),)),
    9: (("id2", "id4"), (("r2", "f"),)),
    10: (KEYS, (("v3", "f"), ("count", "x"))),
}


def id_numbers(ids: np.ndarray, device) -> torch.Tensor:
    """"id" and zero-padded digits -> the number (int64, on `device`)."""
    raw = torch.as_tensor(ids.view(np.uint8).reshape(len(ids), -1),
                          device=device)
    out = torch.zeros(len(ids), dtype=torch.int64, device=device)
    for j in range(2, raw.shape[1]):
        out = out * 10 + (raw[:, j].to(torch.int64) - 48)
    return out


def load(x: dict, device, dtype=torch.float64) -> dict:
    """The table as tensors on `device`: the keys as int64, the values in
    `dtype`."""
    out = {}
    for name in KEYS:
        a = x[name]
        out[name] = id_numbers(a, device) if a.dtype.kind == "S" else \
            torch.as_tensor(a, device=device).to(torch.int64)
    for name in ("v1", "v2", "v3"):
        out[name] = torch.as_tensor(np.asarray(x[name]), device=device).to(
            dtype)
    return out


def _groups(data: dict, keys: tuple):
    """-> (group of each row, the keys' columns of each group)."""
    cols = [data[k] for k in keys]
    if len(cols) == 1:
        uniq, inv = torch.unique(cols[0], return_inverse=True)
        return inv, {keys[0]: uniq}
    # the keys side by side in two int64 halves, three keys at most a half
    # (each id below 2**20, so a half below 2**60); two halves by their
    # ranks, one above the other
    halves = []
    for part in (cols[:3], cols[3:]):
        if part:
            h = part[0]
            for c in part[1:]:
                h = h * (1 << 20) + c
            halves.append(torch.unique(h, return_inverse=True)[1])
    inv = halves[0]
    if len(halves) == 2:
        inv = torch.unique(inv * (int(halves[1].max()) + 1) + halves[1],
                           return_inverse=True)[1]
    g = int(inv.max()) + 1
    first = torch.full((g,), len(inv), dtype=torch.int64, device=inv.device)
    first.scatter_reduce_(0, inv, torch.arange(len(inv), device=inv.device),
                          reduce="amin")
    return inv, {k: c[first] for k, c in zip(keys, cols)}


def _sum(inv, g, v):
    return torch.zeros(g, dtype=v.dtype, device=v.device).index_add_(0, inv,
                                                                     v)


def _count(inv, g, dtype):
    return torch.bincount(inv, minlength=g).to(dtype)


def _group_sorted(inv, g, v):
    """Each group's values in ascending order, one run a group:
    -> (values, run starts, counts)."""
    by_value = torch.sort(v, stable=True).indices
    by_group = torch.sort(inv[by_value], stable=True).indices
    counts = torch.bincount(inv, minlength=g)
    starts = torch.cumsum(counts, 0) - counts
    return v[by_value[by_group]], starts, counts


def answer(n: int, data: dict) -> dict:
    keys, _ = QUESTIONS[n]
    v1, v2, v3 = data["v1"], data["v2"], data["v3"]
    dt = v3.dtype
    if n == 8:
        # the two largest v3 of each id6 partition
        by_value = torch.sort(v3, descending=True, stable=True).indices
        by_part = torch.sort(data["id6"][by_value], stable=True)
        rows = by_value[by_part.indices]
        part = by_part.values
        counts = torch.unique_consecutive(part, return_counts=True)[1]
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(len(part), device=part.device) \
            - torch.repeat_interleave(starts, counts)
        keep = rank < 2
        return {"id6": part[keep], "largest2_v3": v3[rows[keep]]}
    inv, out = _groups(data, keys)
    g = len(next(iter(out.values())))
    cnt = _count(inv, g, dt)
    if n in (1, 2):
        out["v1"] = _sum(inv, g, v1)
    elif n == 3:
        out["v1"] = _sum(inv, g, v1)
        out["v3"] = _sum(inv, g, v3) / cnt
    elif n == 4:
        for name, v in (("v1", v1), ("v2", v2), ("v3", v3)):
            out[name] = _sum(inv, g, v) / cnt
    elif n == 5:
        for name, v in (("v1", v1), ("v2", v2), ("v3", v3)):
            out[name] = _sum(inv, g, v)
    elif n == 6:
        s, starts, counts = _group_sorted(inv, g, v3)
        lo = s[starts + (counts - 1) // 2]
        hi = s[starts + counts // 2]
        out["median_v3"] = (lo + hi) / 2
        mean = _sum(inv, g, v3) / cnt
        dev = v3 - mean[inv]
        var = _sum(inv, g, dev * dev) / (cnt - 1)
        out["sd_v3"] = torch.where(cnt > 1, torch.sqrt(var),
                                   torch.full_like(var, torch.nan))
    elif n == 7:
        hi = torch.full((g,), -torch.inf, dtype=dt, device=v1.device)
        lo = torch.full((g,), torch.inf, dtype=dt, device=v1.device)
        out["range_v1_v2"] = (hi.scatter_reduce_(0, inv, v1, reduce="amax")
                              - lo.scatter_reduce_(0, inv, v2, reduce="amin"))
    elif n == 9:
        # centred on the mean as n x - sum(x), which integers keep exact
        x, y = v1, v2
        dx = cnt[inv] * x - _sum(inv, g, x)[inv]
        dy = cnt[inv] * y - _sum(inv, g, y)[inv]
        sxy, sxx, syy = (_sum(inv, g, a * b)
                         for a, b in ((dx, dy), (dx, dx), (dy, dy)))
        r = sxy / torch.sqrt(sxx * syy)
        out["r2"] = torch.where((sxx > 0) & (syy > 0), r * r,
                                torch.full_like(r, torch.nan))
    else:
        out["v3"] = _sum(inv, g, v3)
        out["count"] = cnt
    return out


def terms(n: int) -> list:
    """Question n's checksum terms, `(alias, column, weight, kind)`, each
    the sum over the answer of `column`, times the answer's column `weight`
    where that is not None.  First db-benchmark's own, the sum of each
    checksum column; then, for each such column, the sum of its squares
    and its sums weighted by each integer key of the question.  A column's
    plain sum is often its input's total (every row lands in some group);
    the squares change when rows move between groups, the key-weighted
    sums when a group's values go to another group's key."""
    keys, cols = QUESTIONS[n]
    out = [(c, c, None, kind) for c, kind in cols]
    for c, kind in cols:
        out += [(f"{c}_{w}", c, w, kind)
                for w in (c, *(k for k in keys if k in INT_KEYS))]
    return out


def checksum(n: int, ans: dict) -> list:
    """[row count, then each term's sum]: Python ints for "x" terms,
    floats for "f"; a sum with no value is None."""
    first = next(iter(ans.values()))
    row = [len(first)]
    for _, name, weight, kind in terms(n):
        v = ans[name] if weight is None else ans[name] * ans[weight]
        v = v[~torch.isnan(v)]
        if len(v) == 0:
            row.append(None)
            continue
        s = v.sum()
        row.append(int(round(float(s))) if kind == "x" else float(s))
    return row
