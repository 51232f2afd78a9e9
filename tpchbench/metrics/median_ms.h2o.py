"""median_ms.h2o: the card's milliseconds in the engine's `db.agg.median`
spans (a quantile's sort by group and value, timed by the span's CUDA
events, attribute `device_ms`) per execution of db-benchmark's question
6.  None where the spans carry no device time (an engine that records
none, a run on the CPU)."""

from tpchbench import spans


def read(rec):
    h = spans.held(rec)
    if h is None:
        return None
    ms = []
    for s, k in zip(h.spans, h.holder):
        if s[0] == "db.agg.median" and k is not None and k >= 0 \
                and h.harness[k][0] == "sql:h2o06" \
                and "device_ms" in (s[5] or {}):
            ms.append(s[5]["device_ms"])
    n = spans.runs(h, "sql:h2o06")
    return sum(ms) / n if ms and n else None
