"""Query profiler: per-operator timing + cardinality tree.

Counterpart of `duckdb_cubit_tpu/exec/profiler.py`.  `PhysicalOperator.
execute` wraps each operator's run in `operator(op)` when the context holds
a profiler, waits for the card inside it (`torch.cuda.synchronize`, so an
operator's time holds its own kernels and its children's) and records the
live row count.  `render` prints the tree as EXPLAIN ANALYZE shows it,
`to_json` the same tree as JSON.
"""

from __future__ import annotations

import contextlib
import json
import time


class QueryProfiler:
    def __init__(self, enabled: bool = True, measure_cardinality: bool = True):
        self.enabled = enabled
        self.measure_cardinality = measure_cardinality
        self.records: dict[int, dict] = {}
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def operator(self, op):
        rec = self.records.setdefault(
            id(op), {"name": op.describe(), "time": 0.0, "cardinality": None,
                     "children": [id(c) for c in op.children]})
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec["time"] += time.perf_counter() - t0

    def record_cardinality(self, op, count: int):
        self.records[id(op)]["cardinality"] = count

    def render(self, root) -> str:
        lines = []

        def walk(op, depth):
            rec = self.records.get(id(op))
            if rec:
                card = rec["cardinality"]
                lines.append("  " * depth + f"{rec['name']}  "
                             f"[{rec['time']*1e3:.2f} ms"
                             + (f", {card} rows]" if card is not None else "]"))
            for c in op.children:
                walk(c, depth + 1)

        walk(root, 0)
        if self.phases:
            lines.append("phases: " + ", ".join(
                f"{k}={v*1e3:.2f}ms" for k, v in self.phases.items()))
        return "\n".join(lines)

    def to_json(self, root) -> str:
        def node(op):
            rec = self.records.get(id(op), {})
            return {
                "name": rec.get("name", op.describe()),
                "time_ms": rec.get("time", 0.0) * 1e3,
                "cardinality": rec.get("cardinality"),
                "children": [node(c) for c in op.children],
            }
        return json.dumps({"plan": node(root), "phases": self.phases})
