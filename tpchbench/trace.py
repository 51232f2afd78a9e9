"""Reading a torch.profiler trace of the window.

`collect(prof)` keeps two kinds of events, both on the profiler's clock in
nanoseconds: the device's activities (kernels, copies, sets) and the
harness's own spans (`record_function` ranges named `window`, `sql:qNN`,
`strings:qNN`, `rf1`, `rf2`).  The rest of the trace (every host-side op)
is dropped unread.
"""

from __future__ import annotations

import bisect

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIXES = ("window", "sql:", "strings:", "rf1", "rf2")


def _ev(e, what: str):
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return f()
    return getattr(e, f"{what}_us")() * 1000


def collect(prof) -> dict:
    device, spans, kinds = [], [], {}
    for e in prof.profiler.kineto_results.events():
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        on_device = "cuda" in str(e.device_type()).lower()
        name = e.name()
        kinds[(kind, on_device)] = kinds.get((kind, on_device), 0) + 1
        if name.startswith(SPAN_PREFIXES):
            # the host's range; its projection onto the device timeline
            # (a "gpu_user_annotation") is no device work
            if not on_device:
                start = _ev(e, "start")
                spans.append((name, start, start + _ev(e, "duration")))
        elif on_device and (kind in DEVICE_KINDS or not kind):
            start = _ev(e, "start")
            device.append((name, start, start + _ev(e, "duration")))
    device.sort(key=lambda x: x[1])
    spans.sort(key=lambda x: x[1])
    return {"device": device, "spans": spans,
            "kinds": {f"{k}/{'device' if d else 'host'}": n
                      for (k, d), n in sorted(kinds.items())}}


def window(tr: dict) -> tuple[int, int] | None:
    w = [s for s in tr["spans"] if s[0] == "window"]
    return (w[0][1], w[0][2]) if w else None


def busy_intervals(tr: dict, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of the device's activities, clipped to [lo, hi]."""
    out: list[list[int]] = []
    for _, s, e in tr["device"]:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(tr: dict) -> float | None:
    w = window(tr)
    if w is None:
        return None
    return sum(e - s for s, e in busy_intervals(tr, *w)) / 1e9


def idle_pct(tr: dict | None) -> float | None:
    """The traced window's share, in percent, with nothing on the device;
    None where the trace holds no device activity (a run on the CPU)."""
    if tr is None or not tr["device"]:
        return None
    w = window(tr)
    if w is None:
        return None
    return 100.0 * (1.0 - busy_s(tr) / ((w[1] - w[0]) / 1e9))


def device_s_in(tr: dict, prefixes: tuple[str, ...]) -> tuple[float, int]:
    """Device seconds of every activity that starts inside a span whose
    name is one of `prefixes`, and the number of `sql:` spans among them."""
    starts = [ds for _, ds, _ in tr["device"]]
    cum = [0]
    for _, ds, de in tr["device"]:
        cum.append(cum[-1] + de - ds)
    spans = [s for s in tr["spans"] if s[0] in prefixes]
    total = 0
    for _, s, e in spans:
        total += cum[bisect.bisect_left(starts, e)] - cum[
            bisect.bisect_left(starts, s)]
    return total / 1e9, sum(1 for s in spans if s[0].startswith("sql:"))


def top_device_ops(tr: dict, k: int = 10) -> list:
    w = window(tr)
    acc: dict[str, int] = {}
    for name, s, e in tr["device"]:
        if w is None or w[0] <= s < w[1]:
            acc[name] = acc.get(name, 0) + (e - s)
    top = sorted(acc.items(), key=lambda x: -x[1])[:k]
    return [[name[:200], ns / 1e9] for name, ns in top]


def idle_gaps(tr: dict, k: int = 10) -> list:
    """The longest stretches with nothing on the device, each named by the
    harness span open at its middle ("between" where none is)."""
    w = window(tr)
    if w is None:
        return []
    busy = busy_intervals(tr, *w)
    edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    inner = [s for s in tr["spans"] if s[0] != "window"]
    starts = [a for _, a, _ in inner]
    out = []
    for s, e in gaps[:k]:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = inner[i][0] if i >= 0 and mid < inner[i][2] else "between"
        out.append([name, (e - s) / 1e9])
    return out
