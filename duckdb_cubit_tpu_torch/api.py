"""User-facing connection API.

Counterpart of `duckdb_cubit_tpu/api.py`: `Connection.sql()` drives parse ->
bind -> optimize -> execute over the port's device tensors.  The device is
the card unless the caller asks for another: `connect(sf)` and
`Connection(...)` default to `device="cuda"` (and raise where there is no
card; nothing falls back to the CPU), `device="cpu"` runs the plain torch
bodies.  Every table of the catalog must live on the connection's device.
This slice runs SELECT statements; other statements, meshes and
transactions come later.
"""

from __future__ import annotations

import torch

from .exec import result as R
from .exec.executor import Executor
from .sql.binder import Binder
from .storage.table import Catalog


class Result:
    """A SELECT's rows, materialized on the host on request."""

    def __init__(self, relation):
        self.relation = relation

    def rows(self) -> list[tuple]:
        _, rows, _ = R.materialize(self.relation)
        return rows

    def strings(self) -> list[list[str]]:
        return R.to_strings(self.relation)

    def __repr__(self):
        rows = self.strings()
        head = [" | ".join(r) for r in rows[:20]]
        more = f"\n... ({len(rows)} rows)" if len(rows) > 20 else ""
        return "\n".join(head) + more


class Connection:
    def __init__(self, catalog: Catalog | None = None, config=None, *,
                 device="cuda"):
        from .config import EngineConfig

        self.device = torch.device(device)
        self.catalog = catalog if catalog is not None else Catalog()
        self._check_device(self.catalog)
        self.config = config if config is not None else EngineConfig()
        self.executor = Executor(self.catalog, self.config)
        self.binder = Binder(self.catalog, self.executor)

    def _check_device(self, catalog: Catalog):
        for t in catalog.tables.values():
            if t.device != self.device:
                raise ValueError(f"table {t.name} is on {t.device}, the "
                                 f"connection on {self.device}")

    # -------------------------------------------------------------- data in
    def load_tpch(self, sf: float = 0.01):
        from .tpch import load

        self.catalog = load.load_catalog(sf, device=self.device)
        self.executor = Executor(self.catalog, self.config)
        self.binder = Binder(self.catalog, self.executor)
        return self

    # ------------------------------------------------------------- querying
    def sql(self, query: str) -> Result:
        from .sql import ast as A
        from .sql.parser import parse_statement

        stmt = parse_statement(query)
        if not isinstance(stmt, A.SelectStmt):
            raise NotImplementedError(
                f"{type(stmt).__name__} statements: not ported yet")
        if self.config.query_timeout_s > 0:
            raise NotImplementedError("query_timeout_s: not ported yet")
        plan = self.binder.bind(stmt)
        return Result(self.executor.execute(plan))

    def explain(self, query: str) -> str:
        plan = self.binder.bind_sql(query)
        return self.explain_plan(plan)

    def explain_plan(self, plan) -> str:
        """Operator tree + pipeline decomposition (EXPLAIN)."""
        from .exec.executor import build_pipelines
        from .plan import optimizer as opt

        plan = opt.optimize(plan, self.catalog)
        lines = []

        def walk(op, d):
            lines.append("  " * d + op.describe())
            for c in op.children:
                walk(c, d + 1)

        walk(plan, 0)
        pipelines = build_pipelines(plan)
        lines.append(f"-- pipelines ({len(pipelines)}):")
        for i, p in enumerate(pipelines):
            deps = [pipelines.index(d) for d in p.dependencies]
            dep_s = f" deps={deps}" if deps else ""
            lines.append(f"  [{i}]{dep_s} {p.describe()}")
        return "\n".join(lines)


def connect(sf: float | None = None, *, device="cuda") -> Connection:
    """Open a connection whose tensors live on `device` (the card unless the
    caller asks for "cpu"); with `sf`, load the TPC-H catalog at that scale
    factor."""
    conn = Connection(device=device)
    if sf is not None:
        conn.load_tpch(sf)
    return conn
