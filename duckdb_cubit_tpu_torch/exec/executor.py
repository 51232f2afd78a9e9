"""Query executor: pipeline construction + eager driving.

Counterpart of `duckdb_cubit_tpu/exec/executor.py`.  A pipeline is a
maximal chain of mask-preserving operators ending in a breaker (join build,
aggregate, sort); `build_pipelines` gives the decomposition that `explain`
prints.  Execution is the reference's eager path: optimize, then run the
operator tree once over device tensors.  PyTorch runs eagerly, so the
reference's staged and whole-plan compiled modes (jit-compiled programs per
pipeline) have no counterpart here.
"""

from __future__ import annotations

import dataclasses

from ..plan import optimizer as opt
from ..plan.physical import ExecContext, PhysicalOperator, Relation


@dataclasses.dataclass
class Pipeline:
    """source -> operators -> sink chain."""
    operators: list
    dependencies: list

    def describe(self):
        return " -> ".join(op.describe() for op in self.operators)


def build_pipelines(root: PhysicalOperator) -> list[Pipeline]:
    """Break the operator tree at pipeline breakers.

    Build sides / blocking children become child pipelines that must
    complete before the parent pipeline runs.
    """
    pipelines: list[Pipeline] = []

    def walk(op) -> Pipeline:
        deps = []
        chain = []

        def descend(o):
            for blocked in o.blocking_children():
                deps.append(walk(blocked))
            streaming_children = [c for c in o.children
                                  if c not in o.blocking_children()]
            for c in streaming_children:
                if c.is_pipeline_breaker():
                    deps.append(walk(c))
                else:
                    descend(c)
            chain.append(o)

        descend(op)
        p = Pipeline(chain, deps)
        pipelines.append(p)
        return p

    walk(root)
    return pipelines


class Executor:
    """Optimizes a plan and runs it eagerly over device tensors."""

    def __init__(self, catalog, config=None):
        self.catalog = catalog
        self.config = config

    def execute(self, plan: PhysicalOperator, optimize: bool = True) -> Relation:
        if optimize:
            plan = opt.optimize(plan, self.catalog)
        self.plan = plan
        return plan.execute(ExecContext(self.catalog, self.config))
