"""Query executor: pipeline construction + eager driving.

Counterpart of `duckdb_cubit_tpu/exec/executor.py`.  A pipeline is a
maximal chain of mask-preserving operators ending in a breaker (join build,
aggregate, sort); `build_pipelines` gives the decomposition that `explain`
prints.  Execution is the reference's eager path: optimize, prepare (host
decisions, cached per plan signature), then run the operator tree over
device tensors.  Deferred runtime checks are read after the run, in one
device -> host transfer; a recoverable failure flips the operator that
raised it to its plain path (or doubles a join's expansion capacity) and
the query runs again.  PyTorch runs eagerly, so the reference's staged and
whole-plan compiled modes (jit-compiled programs per pipeline) have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

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
    """Optimizes a plan, prepares it and runs it eagerly over device
    tensors."""

    # bounded LRU of prepared plans (class-level so connections share it; a
    # table's new version or row count makes a new key, and old entries age
    # out)
    _prepare_cache: OrderedDict = OrderedDict()
    CACHE_LIMIT = 256
    # operator attributes produced by prepare() (host decisions and the
    # device tensors derived from them)
    _PREP_ATTRS = ("_words", "_decode_cap", "_pk", "_reverse_pk",
                   "_vlut_cols", "_fk_dense", "_kernel")
    # runs of one query, the first one included
    MAX_ATTEMPTS = 9

    def __init__(self, catalog, config=None):
        self.catalog = catalog
        self.config = config
        # how many runs were repeated after a recoverable check failed
        self.retry_count = 0

    def execute(self, plan: PhysicalOperator, optimize: bool = True) -> Relation:
        if optimize:
            plan = opt.optimize(plan, self.catalog)
        self.plan = plan
        self._prepare(plan)
        failed: list = []
        for _attempt in range(self.MAX_ATTEMPTS):
            rel = self._execute_eager(plan)
            failed = self._failed_checks(rel.checks)
            if not failed:
                rel.checks = []
                return rel
            if not self._handle_failed_checks(failed, list(plan.walk())):
                raise RuntimeError(f"runtime check failed: {failed}")
            self.retry_count += 1
            # the flipped switch is part of the signature: a new entry
            self._prepare(plan)
        raise RuntimeError(f"retry limit exceeded: {failed}")

    @staticmethod
    def _cache_put(cache, key, value):
        cache[key] = value
        cache.move_to_end(key)
        while len(cache) > Executor.CACHE_LIMIT:
            cache.popitem(last=False)

    def _catalog_version(self):
        cfg = self.config.plan_key() if self.config is not None else ()
        return (cfg, self.catalog.placement,
                tuple(sorted((name, t.uid, t.version, t.num_rows)
                             for name, t in self.catalog.tables.items())))

    def _prepare(self, plan: PhysicalOperator):
        """Host-side decisions, cached per (plan signature, catalog
        version): a repeated query skips the decisions and the device work
        they cause (index words, the fused kernel's widened and packed
        payload)."""
        ops = list(plan.walk())
        key = (plan.signature(), self._catalog_version())
        prep = Executor._prepare_cache.get(key)
        if prep is None:
            plan.prepare(ExecContext(self.catalog, self.config))
            Executor._cache_put(Executor._prepare_cache, key, [
                {a: getattr(op, a) for a in Executor._PREP_ATTRS
                 if hasattr(op, a)}
                for op in ops])
        else:
            Executor._prepare_cache.move_to_end(key)
            for op, attrs in zip(ops, prep):
                for a, v in attrs.items():
                    setattr(op, a, v)

    def _execute_eager(self, plan: PhysicalOperator) -> Relation:
        ctx = ExecContext(self.catalog, self.config)
        for i, op in enumerate(plan.walk()):
            ctx.check_tags.setdefault(id(op), i)
        rel = plan.execute(ctx)
        # runtime assertions accumulate on the context
        rel.checks = list(ctx.checks)
        return rel

    @staticmethod
    def _failed_checks(checks) -> list[str]:
        """Names of the checks that failed (one device -> host read)."""
        if not checks:
            return []
        flags = torch.stack([ok for _, ok in checks]).tolist()
        return [name for (name, _), ok in zip(checks, flags) if not ok]

    # the expansion regrow: doubled, at least MIN_CAP, at most MAX_CAP
    MIN_CAP = 1 << 13
    MAX_CAP = 1 << 28

    @staticmethod
    def _handle_failed_checks(failed, ops) -> bool:
        """Recoverable-check handler for names `kind#tag` and
        `kind#tag#cap`: flips the operator named by each failed check to its
        plain path, or regrows its capacity.  Returns False when any failure
        is not recoverable (the caller raises)."""
        for name in failed:
            parts = name.split("#")
            if len(parts) not in (2, 3):
                return False
            kind, tag = parts[0], int(parts[1])
            cap = int(parts[2]) if len(parts) == 3 else 0
            if not 0 <= tag < len(ops):
                return False
            if kind == "pkprobe":
                # the monotone gather's precondition broke: plain lut path
                ops[tag]._no_kernel_probe = True
            elif kind == "unique":
                # duplicate build keys: the expansion join
                ops[tag]._force_expand = True
            elif kind == "expansion":
                # the join produced more pairs than its capacity holds
                new_cap = max(cap * 2, Executor.MIN_CAP)
                if new_cap > Executor.MAX_CAP:
                    return False
                ops[tag]._cap_override = new_cap
            else:
                return False
        return True
