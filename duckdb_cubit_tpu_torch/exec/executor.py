"""Query executor: pipelines, staged and whole-plan driving, verification
and out-of-core chunking.

Counterpart of `duckdb_cubit_tpu/exec/executor.py`.  A pipeline is a
maximal chain of mask-preserving operators ending in a breaker (join build,
aggregate, sort); `build_pipelines` gives the decomposition that `explain`
prints.  Every mode optimizes the plan, then prepares it (host decisions,
cached per plan signature) and runs its operators over device tensors.
PyTorch runs eagerly, so where the reference compiles a program (the whole
plan, or one per stage) the port runs the same operators eagerly.

- **Staged** (the default, `staged_execution = True`): one stage per
  pipeline.  A stage's inputs are the relations of its boundary children,
  each run as a stage of its own first (all siblings before the first count
  is read) and compacted to its true cardinality in a power-of-two bucket
  (`_compact_relation`: one device -> host count per boundary), except the
  inputs a direct-address path needs aligned to their base table and the
  probe side of a join that guesses its expansion capacity from it
  (`_needs_alignment`, `_expands`).  The
  relations are put into the stage's context (`ExecContext._cache`) and the
  stage root runs.  A failed recoverable check (`pkprobe`, `unique`,
  `expansion`) flips or regrows the operator it names, by its position in
  the stage's operator list, and runs that stage again.
- **Whole plan** (`staged_execution = False`, and EXPLAIN ANALYZE's
  profiled run): the operator tree over base-table capacities, the
  recoverable checks read after the run and the whole query run again.
- **Verification** (`enable_verification`): independent legs that must
  agree (`_execute_verified`).
- **Out of core** (`force_external`, or a `memory_limit` below a stage's
  estimated working set): an aggregate stage's driving scan is split into
  row ranges, each pass yields partial aggregates and a merge pass
  re-aggregates them (`_run_stage_chunked`); zone maps skip ranges no row
  of which can pass the scan's filters.  Not on a mesh.

On a catalog sharded over a mesh (`parallel/shard.py`) every rank runs the
same plan and every host read of sharded data is a collective, so all ranks
take the same branch: the deferred checks are ANDed over the mesh before
their one read, a stage boundary's compaction count is the largest block's
(every rank picks the same bucket, blocks stay equal in size), and a
sharded root is gathered, so `execute` returns the same relation on every
rank.  A radix-exchange join's bucket overflow (`exq`) doubles its quotas.
Under a query deadline on a mesh (`api.Connection.sql`) the alarm only sets
a flag; each of those collectives carries it too (a MAX over the ranks),
so every rank raises `QueryTimeoutError` at the same one.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from ..plan import optimizer as opt
from ..plan.physical import (ExecContext, PhysicalOperator, RelColumn,
                             Relation)
from ..types import TypeId
from . import profiler as PROF
from .profiler import QueryProfiler


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


def bucket_count(n: int, minimum: int = 1 << 13) -> int:
    """Round a cardinality up to a power of two (>= one row-pad block): the
    capacity a compacted stage input gets."""
    p = minimum
    while p < n:
        p <<= 1
    return p


def copy_plan(plan: PhysicalOperator) -> PhysicalOperator:
    """A deep copy of an operator tree (verification's unoptimized leg runs
    its own copy, taken before `optimize` rewrites the tree in place).
    Tensors and numpy arrays the operators or their expressions hold (a
    prepared plan's index words and kernel payloads, dictionaries) are
    shared, not copied: the copy's host decisions are made again."""
    memo: dict = {}

    def share(v, depth=0):
        if isinstance(v, (torch.Tensor, np.ndarray)):
            memo[id(v)] = v
        elif depth > 64:
            return
        elif isinstance(v, (list, tuple)):
            for x in v:
                share(x, depth + 1)
        elif isinstance(v, dict):
            for x in v.values():
                share(x, depth + 1)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                share(getattr(v, f.name, None), depth + 1)

    for op in plan.walk():
        for v in vars(op).values():
            share(v)
    return copy.deepcopy(plan, memo)


def _double_columns(rel: Relation) -> list[bool]:
    return [c.dtype.id == TypeId.DOUBLE for c in rel.columns.values()]


def _sorted_rows(rows: list) -> list:
    return sorted(map(tuple, rows))


def _legs_agree(a: list, b: list, doubles: list[bool]) -> bool:
    """Two legs' rows (each sorted by `_sorted_rows`): every cell equal as
    text, except the cells of DOUBLE columns, which agree within the 1e-9
    relative tolerance of `tpch/answers.cells_equal`.  The legs sum floats
    in different orders (FK-dense, dense and sort-based grouping;
    `index_add_` on the card adds float64 through atomics in no fixed
    order), so a DOUBLE cell may differ in its last bits between two
    correct legs; integer and decimal sums are exact, and compared
    exactly."""
    from ..tpch.answers import cells_equal

    if a == b:
        return True
    if len(a) != len(b) or not any(doubles):
        return False

    def key(row):
        exact = tuple(c for c, d in zip(row, doubles) if not d)
        approx = tuple(float("-inf") if c == "NULL" else float(c)
                       for c, d in zip(row, doubles) if d)
        return exact, approx

    for ra, rb in zip(sorted(a, key=key), sorted(b, key=key)):
        if len(ra) != len(rb):
            return False
        for ca, cb, d in zip(ra, rb, doubles):
            if ca != cb and not (d and cells_equal(ca, cb)):
                return False
    return True


class Executor:
    """Optimizes a plan, prepares it and runs it: staged (the default),
    whole plan, verified or out of core (module docstring)."""

    # bounded LRU of prepared plans (class-level so connections share it; a
    # table's new version or row count makes a new key, and old entries age
    # out).  An entry holds only `_PREP_ATTRS` and is written once the
    # decisions are all made, so a query cut short (QueryTimeoutError)
    # leaves no half-written entry and no regrown capacity in the cache.
    _prepare_cache: OrderedDict = OrderedDict()
    CACHE_LIMIT = 256
    # operator attributes produced by prepare() (host decisions and the
    # device tensors derived from them)
    _PREP_ATTRS = ("_words", "_decode_cap", "_pk", "_reverse_pk",
                   "_vlut_cols", "_fk_dense", "_kernel")
    # runs of one query (or one stage), the first one included
    MAX_ATTEMPTS = 9

    def __init__(self, catalog, config=None):
        self.catalog = catalog
        self.config = config
        # how many runs (of a stage, or of the whole plan) were repeated
        # after a recoverable check failed
        self.retry_count = 0
        # out of core: chunk passes run, and chunks the zone maps skipped
        self.external_passes = 0
        self.external_chunks_skipped = 0
        # stage inputs compacted to their cardinality (one count read each)
        self.compacted_boundaries = 0
        # prepare-cache lookups that found the plan's decisions, and those
        # that made them
        self.prepare_hits = 0
        self.prepare_misses = 0
        self.plan = None
        # the last profiled run's QueryProfiler (EXPLAIN ANALYZE)
        self.profiler = None
        # the last verified query: [(leg, seconds)], and whether its legs
        # agreed exactly, DOUBLE cells included
        self.last_legs: list = []
        self.legs_exact = None
        # a mesh query's deadline (api._QueryDeadline, flag only), set by
        # the connection while the query runs
        self.deadline = None

    def execute(self, plan: PhysicalOperator, profile: bool = False,
                optimize: bool = True, verify: bool | None = None
                ) -> Relation:
        """Run `plan`.  `profile=True` runs the whole plan with a
        `QueryProfiler` (`self.profiler`).  `verify` defaults to the
        session's `enable_verification` (never for a profiled run);
        `verify=False` runs one leg whatever the session says (DML row
        matching)."""
        if verify is None:
            verify = (not profile and self.config is not None
                      and self.config.enable_verification)
        profiler = QueryProfiler() if profile else None
        # optimize() rewrites the tree in place, so the unoptimized leg
        # needs its own copy taken BEFORE optimization
        raw_plan = copy_plan(plan) if (verify and optimize) else None
        if optimize:
            with PROF.span("db.optimize"):
                plan = opt.optimize(plan, self.catalog)
        self.plan = plan
        self.profiler = profiler
        if verify:
            return self._execute_verified(plan, raw_plan)
        if profile or not self._staged():
            return self._execute_whole(plan, profiler)
        return self._execute_staged(plan)

    @property
    def mesh(self):
        return getattr(self.catalog, "mesh", None)

    def _replicated(self, rel: Relation) -> Relation:
        """The result whole on every rank (a sharded root is gathered)."""
        if not rel.sharded:
            return rel
        from ..parallel.shard import gather_relation

        out = gather_relation(rel, self.mesh)
        out.checks = []
        return out

    def _staged(self) -> bool:
        return self.config is None or self.config.staged_execution

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
        with PROF.span("db.prepare") as sp:
            ops = list(plan.walk())
            key = (plan.signature(), self._catalog_version())
            prep = Executor._prepare_cache.get(key)
            sp.set(hit=prep is not None)
            if prep is None:
                self.prepare_misses += 1
                plan.prepare(ExecContext(self.catalog, self.config))
                Executor._cache_put(Executor._prepare_cache, key, [
                    {a: getattr(op, a) for a in Executor._PREP_ATTRS
                     if hasattr(op, a)}
                    for op in ops])
            else:
                self.prepare_hits += 1
                Executor._prepare_cache.move_to_end(key)
                for op, attrs in zip(ops, prep):
                    for a, v in attrs.items():
                        setattr(op, a, v)

    # ---------------------------------------------------- whole-plan path
    def _execute_eager(self, plan: PhysicalOperator, profiler=None,
                       verify_mode: bool = False) -> Relation:
        ctx = ExecContext(self.catalog, self.config, profiler)
        ctx.verify_mode = verify_mode
        for i, op in enumerate(plan.walk()):
            ctx.check_tags.setdefault(id(op), i)
        if profiler is not None:
            with profiler.phase("execute"):
                rel = plan.execute(ctx)
        else:
            rel = plan.execute(ctx)
        # runtime assertions accumulate on the context
        rel.checks = list(ctx.checks)
        return rel

    def _execute_whole(self, plan: PhysicalOperator, profiler=None,
                       verify_mode: bool = False) -> Relation:
        """The whole plan over base-table capacities; after a recoverable
        check fails, the whole plan runs again."""
        self._prepare(plan)
        failed: list = []
        for _attempt in range(self.MAX_ATTEMPTS):
            if profiler is not None:
                profiler.records.clear()
            rel = self._execute_eager(plan, profiler, verify_mode)
            failed = self._failed_checks(rel.checks)
            if not failed:
                rel.checks = []
                return self._replicated(rel)
            if not self._handle_failed_checks(failed, list(plan.walk())):
                raise RuntimeError(f"runtime check failed: {failed}")
            self.retry_count += 1
            # the flipped switch is part of the signature: a new entry
            self._prepare(plan)
        raise RuntimeError(f"retry limit exceeded: {failed}")

    def _deadline_flag(self) -> torch.Tensor | None:
        """Whether this rank's alarm went off, as a 0-d int64 tensor on the
        mesh's device; None unless a mesh query runs under a deadline."""
        if self.deadline is None or self.mesh is None:
            return None
        return torch.tensor(int(self.deadline.expired),
                            device=self.mesh.device)

    def poll_deadline(self):
        """On a mesh under a deadline: raise `QueryTimeoutError` on every
        rank when any rank's alarm went off (one MAX over the mesh, which
        every rank must reach).  Nothing elsewhere."""
        flag = self._deadline_flag()
        if flag is None:
            return
        from ..parallel.shard import all_reduce

        if int(all_reduce(flag, self.mesh, "max")):
            raise self.deadline.error()

    def _failed_checks(self, checks) -> list[str]:
        """Names of the checks that failed (one device -> host read; on a
        mesh the flags are ANDed over the ranks first, so every rank retries
        the same operators, and under a deadline the same read carries the
        alarm's flag)."""
        flag = self._deadline_flag()
        if not checks and flag is None:
            return []
        flags = [ok for _, ok in checks]
        if flag is not None:
            flags.append(flag == 0)
        flags = torch.stack(flags)
        with PROF.wait("checks"):
            if self.mesh is not None:
                from ..parallel.shard import all_ok

                flags = all_ok(flags, self.mesh)
            flags = flags.tolist()
        if flag is not None and not flags.pop():
            raise self.deadline.error()
        return [name for (name, _), ok in zip(checks, flags) if not ok]

    # the expansion regrow: doubled, at least MIN_CAP, at most MAX_CAP
    MIN_CAP = 1 << 13
    MAX_CAP = 1 << 28

    @staticmethod
    def _handle_failed_checks(failed, ops) -> bool:
        """Recoverable-check handler for names `kind#tag` and
        `kind#tag#cap`: flips the operator named by each failed check (`tag`
        is its position in `ops`) to its plain path, or regrows its
        capacity.  Returns False when any failure is not recoverable (the
        caller raises)."""
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
            elif kind == "exq":
                # a radix-exchange bucket overflowed: double the
                # per-destination quotas of both sides
                quotas = [a for a in ("_exq_build", "_exq_probe")
                          if getattr(ops[tag], a, None)]
                if not quotas:
                    return False
                for a in quotas:
                    setattr(ops[tag], a, getattr(ops[tag], a) * 2)
            else:
                return False
        return True

    # ------------------------------------------------------- verification
    def _leg(self, name: str, run):
        """One verification leg, timed with its rows on the host."""
        from .result import to_strings

        t0 = time.perf_counter()
        rel = run()
        rows = to_strings(rel)
        self.last_legs.append((name, time.perf_counter() - t0))
        return rel, rows

    def _execute_verified(self, plan, raw_plan=None):
        """PRAGMA enable_verification: the query through independent legs
        that must agree (`_legs_agree`: DOUBLE cells within 1e-9):

          1. the production path: staged (or the whole plan when
             `staged_execution` is off);
          2. the whole optimized plan, eagerly;
          3. the UNOPTIMIZED plan (copied before `optimize`), eagerly, in
             verify_mode: no CUBIT index matching, no PK / reverse-PK
             direct-address joins, no single-match sort-merge probe, no
             FK-dense grouping, no fused scan-sum, so neither K1 nor K2
             launches and an index or fast-path fault cannot confirm
             itself;
          4. `exec/pyverify.py` over the unoptimized plan, row by row in
             Python, when every base table has at most `pyverify_max_rows`
             rows, so a fault in a torch operation shared by legs 1-3
             cannot confirm itself either.

        `verification_legs = "light"` (the sqllogic runner) skips leg 1:
        leg 2 gives the result."""
        self.last_legs, self.legs_exact = [], None
        light = (self.config is not None
                 and getattr(self.config, "verification_legs", "all")
                 == "light")
        if light:
            result, a = self._leg("eager", lambda: self._execute_whole(plan))
        else:
            result, a = self._leg(
                "production", lambda: self._execute_staged(plan)
                if self._staged() else self._execute_whole(plan))
            _, b = self._leg("eager", lambda: self._execute_whole(plan))
            sa, sb = _sorted_rows(a), _sorted_rows(b)
            self.legs_exact = sa == sb
            if not _legs_agree(sa, sb, _double_columns(result)):
                raise RuntimeError(
                    "verification failed: staged and eager results differ "
                    f"(staged {len(a)} rows, eager {len(b)} rows)")
        if raw_plan is not None:
            _, c = self._leg("unoptimized", lambda: self._execute_whole(
                raw_plan, verify_mode=True))
            sa, sc = _sorted_rows(a), _sorted_rows(c)
            self.legs_exact = sa == sc and self.legs_exact is not False
            if not _legs_agree(sa, sc, _double_columns(result)):
                raise RuntimeError(
                    "verification failed: optimized and unoptimized results "
                    f"differ (optimized {len(a)} rows, unoptimized {len(c)} "
                    "rows)")
            t0 = time.perf_counter()
            if self._pyverify(raw_plan, result, a):
                self.last_legs.append(("row-by-row",
                                       time.perf_counter() - t0))
        self.plan = plan
        return result

    def _pyverify(self, raw_plan, result, leg1_strings) -> bool:
        """Leg 4: independent row-by-row Python execution (small inputs).
        -> whether it ran."""
        from ..plan.physical import TableScan
        from . import pyverify as PV

        limit = self.config.pyverify_max_rows \
            if self.config is not None else 0
        if limit <= 0 or not PV.supports(raw_plan):
            return False
        scans = [op.table_name for op in raw_plan.walk()
                 if isinstance(op, TableScan)]
        if any(self.catalog.table(t).num_rows > limit for t in scans):
            return False
        catalog = self.catalog
        if self.mesh is not None:
            # the tables whole on the host, gathered from their blocks
            from ..parallel.shard import host_catalog

            catalog = host_catalog(self.catalog, scans)
        try:
            rows = PV.run(raw_plan, catalog)
        except PV.Unsupported:
            return False
        names = list(result.columns.keys())
        diff = PV.compare_to_strings(rows, names, leg1_strings)
        if diff is not None:
            raise RuntimeError(
                f"verification failed: independent row-by-row executor "
                f"disagrees: {diff}")
        return True

    # -------------------------------------------------------- staged path
    def _execute_staged(self, plan: PhysicalOperator) -> Relation:
        """One stage per pipeline; see the module docstring."""
        self.plan = plan
        self._prepare(plan)
        rel = self._run_stage(plan, keep_aligned=False)
        rel.checks = []
        return self._replicated(rel)

    def _needs_alignment(self, parent, i) -> bool:
        """Whether child i's output rows must keep their row space:
        direct-address index paths gather / scatter by base row, the PK
        probe's kernel (K2) reads its sorted probe keys in storage order and
        density (`_kernel_probe_side`), and an expanding join guesses its
        pair capacity from its probe side's capacity (`_expands`)."""
        from ..plan.physical import HashJoin
        if i == 0 and self._expands(parent):
            return True
        if isinstance(parent, HashJoin):
            if i == 1 and getattr(parent, "_pk", None) is not None:
                return True
            if i == 0 and getattr(parent, "_reverse_pk", None) is not None:
                return True
            if i == 0 and self._kernel_probe_side(parent):
                return True
        return False

    @staticmethod
    def _expands(join) -> bool:
        """Host check: does this join expand (probe row, build row) pairs
        into a capacity it guesses as its probe side's capacity times
        `join_expansion_factor`?  Its probe side stays uncompacted, so the
        guess, and every regrow it causes, is the whole plan's (a probe
        compacted to its bucket would undershoot where each row has several
        matches, as q21's EXISTS mark joins do, and add a stage retry the
        whole plan does not make).  A difference from the reference, which
        compacts such a probe side and retries."""
        from ..plan.physical import HashJoin, MarkJoin, RangeJoin
        if isinstance(join, (MarkJoin, RangeJoin)):
            return join.out_capacity is None
        if not isinstance(join, HashJoin) or join.out_capacity is not None \
                or getattr(join, "_reverse_pk", None) is not None:
            return False
        pk = getattr(join, "_pk", None) is not None
        if join.join_type in ("semi", "anti"):
            return not pk and len(join.probe_keys) > 2
        return not (join.single_match and join.join_type != "full"
                    and (pk or not getattr(join, "_force_expand", False)))

    def _kernel_probe_side(self, join) -> bool:
        """Host check: does this PK join probe with a sorted storage column
        of the base table its probe side is aligned to?  Such a probe side
        stays uncompacted, so the join launches K2 over the same keys as in
        the whole plan (a compacted probe of fewer than the kernel's
        MIN_KEYS keys would take the plain lut path instead)."""
        from ..plan.physical import static_base_table
        if getattr(join, "_pk", None) is None or \
                getattr(join, "_no_kernel_probe", False):
            return False
        if not (join.single_match or join.join_type in ("semi", "anti")):
            return False
        base = static_base_table(join.children[0])
        if base is None:
            return False
        col = self.catalog.table(base).columns.get(join.probe_keys[0])
        return col is not None and col.is_sorted and col.nulls is None

    def _on_spine(self, parent, i) -> bool:
        """Whether parent's output row space IS child i's row space (the
        mask-preserving chain `static_base_table()` traverses)."""
        from ..plan.physical import (BroadcastScalar, Filter, HashJoin, Limit,
                                     MarkJoin, Project, Window)
        if isinstance(parent, (Filter, Project, Limit, Window,
                               BroadcastScalar, MarkJoin)):
            return i == 0
        if isinstance(parent, HashJoin):
            return i == 0 and (
                parent.join_type in ("semi", "anti")
                or (parent.single_match
                    and not getattr(parent, "_force_expand", False)))
        return False

    def _subtree_selective(self, op) -> bool:
        """Host heuristic: is this subtree's cardinality likely below its
        capacity (worth a compaction boundary before a join consumes it)?"""
        from ..plan.physical import Filter, TableScan
        for o in op.walk():
            if isinstance(o, Filter):
                return True
            if isinstance(o, TableScan) and (o.filters or o.index_filters):
                return True
            if o.is_pipeline_breaker():
                return True
        return False

    def _find_boundaries(self, root, keep_aligned: bool,
                         fuse_joins: bool = False):
        """Stage inputs: every pipeline-breaker descendant, plus join inputs
        whose subtree is selective (those get compacted to their true
        cardinality, so the join's expansion capacity tracks real row
        counts).  `compactable=False` marks inputs that must stay
        base-aligned for a direct-address path.

        `fuse_joins` keeps probe-partitionable hash joins INSIDE the stage
        (their build sides stay resident) so the out-of-core chunker can
        split the probe side.  -> ([(child_op, compactable)], {id(child):
        input slot})."""
        from ..plan.physical import HashJoin, MarkJoin, RangeJoin
        bounds: list = []
        bindex: dict = {}

        def add(c, compactable):
            if id(c) in bindex:
                i = bindex[id(c)]
                bounds[i] = (c, bounds[i][1] and compactable)
            else:
                bindex[id(c)] = len(bounds)
                bounds.append((c, compactable))

        def fuseable(c):
            return (fuse_joins and isinstance(c, HashJoin)
                    and c.join_type in ("inner", "left", "semi", "anti")
                    and getattr(c, "_reverse_pk", None) is None)

        def walk(o, spine_aligned):
            for i, c in enumerate(o.children):
                aligned = (self._needs_alignment(o, i)
                           or (spine_aligned and self._on_spine(o, i)))
                if c.is_pipeline_breaker() and not fuseable(c):
                    add(c, not aligned)
                elif (not aligned and not fuseable(c)
                      and isinstance(o, (HashJoin, RangeJoin, MarkJoin))
                      and self._subtree_selective(c)):
                    add(c, True)
                else:
                    walk(c, aligned)
        walk(root, keep_aligned)
        return bounds, bindex

    def _stage_ops(self, root, bindex):
        """Preorder operators of the stage rooted at `root`, cut at its
        inputs: the list a stage's check tags index."""
        out = []

        def walk(o):
            out.append(o)
            for c in o.children:
                if id(c) not in bindex:
                    walk(c)
        walk(root)
        return out

    def _stage_signature(self, op, bindex) -> str:
        if id(op) in bindex:
            return f"$in{bindex[id(op)]}"
        childs = ",".join(self._stage_signature(c, bindex)
                          for c in op.children)
        return f"{op._self_signature()}({childs})"

    def _run_stage(self, op, keep_aligned: bool = False) -> Relation:
        from ..plan.physical import GroupAggregate, HashJoin

        with PROF.span("db.stage"):
            bounds, bindex = self._find_boundaries(op, keep_aligned)
            chunk = self._chunk_plan(op, bindex)
            cfg = self.config
            if (chunk is None and isinstance(op, GroupAggregate)
                    and cfg is not None
                    and (cfg.force_external or cfg.memory_limit > 0)
                    and any(isinstance(c, HashJoin) for c, _ in bounds)):
                # an out-of-core candidate blocked only by join boundaries:
                # try again with probe-partitionable joins fused into this
                # stage (their build sides stay resident across the chunk
                # passes)
                b2, bi2 = self._find_boundaries(op, keep_aligned,
                                                fuse_joins=True)
                ch2 = self._chunk_plan(op, bi2)
                if ch2 is not None:
                    bounds, bindex, chunk = b2, bi2, ch2
            # run ALL sibling boundary stages before the first compaction
            # reads a count, so the card works through them while the host
            # goes on
            raw = [self._run_stage(c, keep_aligned=not compactable)
                   for c, compactable in bounds]
            brels = [self._compact_relation(r) if compactable else r
                     for (c, compactable), r in zip(bounds, raw)]
            if chunk is not None:
                return self._run_stage_chunked(op, bounds, bindex, brels,
                                               chunk)
            failed: list = []
            for _attempt in range(self.MAX_ATTEMPTS):
                rel = self._stage_eager(op, bounds, bindex, brels)
                failed = self._failed_checks(rel.checks)
                if not failed:
                    rel.checks = []
                    return rel
                if not self._handle_failed_checks(
                        failed, self._stage_ops(op, bindex)):
                    raise RuntimeError(f"runtime check failed: {failed}")
                self.retry_count += 1
                # host decisions can shift (single-match -> expansion
                # changes an ancestor's PK-join eligibility): re-resolve
                # the plan
                self._prepare(self.plan)
            raise RuntimeError(f"capacity retry limit exceeded: {failed}")

    def _stage_eager(self, root, bounds, bindex, brels,
                     chunk=None) -> Relation:
        """Run one stage: its inputs go into the context, each check is
        tagged by its operator's position in `_stage_ops`; `chunk` = (scan,
        lo, hi, row_limit) hands the driving scan one row range and keeps
        the fused scan-sum off."""
        stage_ops = self._stage_ops(root, bindex)
        ctx = ExecContext(self.catalog, self.config)
        ctx.check_tags = {id(o): i for i, o in enumerate(stage_ops)}
        for (c, _), r in zip(bounds, brels):
            ctx._cache[id(c)] = r
        if chunk is not None:
            scan, lo, hi, row_limit = chunk
            ctx.scan_chunks[id(scan)] = (lo, hi, row_limit)
            ctx.no_fused = True
        rel = root.execute(ctx)
        rel.checks = list(ctx.checks)
        return rel

    def _compact_relation(self, rel: Relation) -> Relation:
        """Read the true cardinality (one device -> host count) and gather
        the live rows into a power-of-two bucket, in ascending row order, so
        a sorted column stays sorted (`monotone`, which the monotone gather
        kernel needs, survives the boundary).  Of a row block, the count is
        the largest block's (one MAX over the mesh), so every rank picks the
        same bucket."""
        from ..ops import kernels

        count = rel.mask.sum()
        flag = self._deadline_flag()
        with PROF.wait("count"):
            if rel.sharded or flag is not None:
                from ..parallel.shard import all_reduce

                both = all_reduce(torch.stack(
                    [count, count.new_zeros(()) if flag is None else flag]),
                    self.mesh, "max")
                count, expired = both.tolist()
                if expired:
                    raise self.deadline.error()
            count = int(count)
        cap = bucket_count(count)
        if cap >= rel.capacity:
            return rel
        self.compacted_boundaries += 1
        idx, cnt = kernels.mask_to_indices(rel.mask, cap)
        valid = torch.arange(cap, device=rel.mask.device) < cnt
        # padding slots repeat the last row: masked, and a sorted column
        # stays non-decreasing through them
        safe = torch.clamp(idx, max=rel.capacity - 1)
        cols = {n: RelColumn(c.array[safe], c.dtype, c.dictionary, c.domain,
                             None if c.valid is None else c.valid[safe],
                             monotone=c.monotone)
                for n, c in rel.columns.items()}
        return Relation(cols, valid, cap, rel.sharded)

    # ------------------------------------------- out-of-core (multi-pass)
    def _chunk_plan(self, root, bindex):
        """Decide whether this stage runs in passes (out of core).

        When the stage's estimated working set exceeds `memory_limit` (or
        `force_external` is set), the driving table scan is split into
        row-range chunks, the stage runs once per chunk producing partial
        aggregates, and a merge pass re-aggregates the concatenated
        partials.  -> (scan, n_chunks, (partial_root, materialized,
        merge_root)) or None."""
        cfg = self.config
        if cfg is None:
            return None
        if not cfg.force_external and cfg.memory_limit <= 0:
            return None
        from ..plan.physical import GroupAggregate, HashJoin, TableScan
        if not isinstance(root, GroupAggregate) or not root.aggregates:
            return None
        if self.catalog.placement != "default":
            return None
        stage_ops = self._stage_ops(root, bindex)
        if not any(isinstance(o, TableScan) for o in stage_ops):
            return None
        # the driving scan is the probe-spine leaf: chunking it partitions
        # every join's (probe, build) match pairs exactly once per chunk;
        # other scans (build sides) stay resident
        drive = root
        while drive.children and id(drive.children[0]) not in bindex:
            drive = drive.children[0]
        if not isinstance(drive, TableScan):
            return None
        scan = drive
        if getattr(scan, "_decode_cap", None) is not None:
            return None
        joins = [o for o in stage_ops if isinstance(o, HashJoin)]
        for j in joins:
            # reverse-PK scatters target FULL-table probe row ids: a
            # chunked probe row space would alias them
            if getattr(j, "_reverse_pk", None) is not None:
                return None
        n = self.chunk_count(scan, len(joins))
        if n is None:
            return None
        split = self._split_aggregate(root)
        if split is None:
            return None
        return scan, n, split

    def working_set(self, scan, n_joins: int) -> int:
        """A stage's estimated working set, bytes: its driving scan's
        columns, times 4 for masks and intermediates, plus two
        expansion-sized intermediates per join."""
        table = self.catalog.table(scan.table_name)
        col_bytes = sum(table.columns[c].data.element_size() * table.capacity
                        for c in scan.needed_columns(table))
        return col_bytes * (4 + 2 * n_joins)

    def chunk_count(self, scan, n_joins: int) -> int | None:
        """The passes a stage driven by `scan` takes under this session's
        settings: 4 under `force_external`, else the least power of two
        that brings the working set under `memory_limit`; at least 8192
        rows a chunk.  None: one pass."""
        cfg = self.config
        est = self.working_set(scan, n_joins)
        if cfg.force_external:
            n = 4
        elif est > cfg.memory_limit:
            n = 2
            while est / n > cfg.memory_limit:
                n *= 2
        else:
            return None
        capacity = self.catalog.table(scan.table_name).capacity
        if capacity // n < 8192:
            n = max(1, capacity // 8192)
        return n if n > 1 else None

    def _chunk_maybe_nonempty(self, scan, table, lo: int, hi: int) -> bool:
        """Host-side zone-map pruning for one chunk's row range: False when
        some pushed conjunct is provably unsatisfiable over every block of
        [lo, hi) (per-block min/max, storage/table.py ZONE_BLOCK)."""
        from ..ops import expressions as E
        from ..storage.table import ZONE_BLOCK

        for f in scan.filters:
            for conj in opt.split_conjuncts(f):
                if not isinstance(conj, E.Compare):
                    continue
                left, right, cop = conj.left, conj.right, conj.op
                if isinstance(right, E.Col) and isinstance(left, E.Lit):
                    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                            "==": "==", "!=": "!="}
                    left, right, cop = right, left, flip[cop]
                if not (isinstance(left, E.Col) and isinstance(right, E.Lit)):
                    continue
                c = table.columns.get(left.name)
                if c is None or c.zone_map is None:
                    continue
                b0 = lo // ZONE_BLOCK
                b1 = min(-(-hi // ZONE_BLOCK), len(c.zone_map.mins))
                if b1 <= b0:
                    continue
                v = opt._literal_device_value(right, c.dtype, c.dictionary)
                if v is None:
                    continue
                blo = int(c.zone_map.mins[b0:b1].min())
                bhi = int(c.zone_map.maxs[b0:b1].max())
                if opt._classify_vs_bounds(cop, v, blo, bhi) == "never":
                    return False
        return True

    def _split_aggregate(self, agg):
        """Rewrite a GroupAggregate into (partial, materialized, merge):
        chunk-local partials, then a re-aggregation over their union."""
        from ..ops.expressions import Col as ECol
        from ..plan.physical import (Aggregate, GroupAggregate, Materialized,
                                     Project)

        partial_aggs, merge_aggs, out_exprs = [], [], {}
        need_project = False
        for k in agg.keys:
            out_exprs[k] = k
        for c in agg.carry:
            out_exprs[c] = c
        for a in agg.aggregates:
            if a.kind == "avg":
                s, c = a.name + "__ps", a.name + "__pc"
                partial_aggs.append(Aggregate("sum", a.expr, s))
                partial_aggs.append(Aggregate("count", a.expr, c))
                merge_aggs.append(Aggregate("sum", ECol(s), s))
                merge_aggs.append(Aggregate("sum", ECol(c), c))
                out_exprs[a.name] = ECol(s) / ECol(c)
                need_project = True
            elif a.kind in ("sum", "sum_double", "min", "max", "count"):
                partial_aggs.append(a)
                kind = "sum" if a.kind == "count" else a.kind
                merge_aggs.append(Aggregate(kind, ECol(a.name), a.name))
                out_exprs[a.name] = a.name
            else:
                return None
        partial = GroupAggregate(agg.children[0], agg.keys, partial_aggs,
                                 agg.carry, agg.dense_domain_limit)
        # inherit the resolved host decisions; the fused scan-sum is
        # whole-table shaped, so it stays off in the passes
        partial._fk_dense = getattr(agg, "_fk_dense", None)
        partial._kernel = None
        mat = Materialized()
        merge = GroupAggregate(mat, agg.keys, merge_aggs, agg.carry,
                               agg.dense_domain_limit)
        merge._fk_dense = None
        merge._kernel = None
        root = Project(merge, out_exprs) if need_project else merge
        return partial, mat, root

    def _run_stage_chunked(self, root, bounds, bindex, brels, chunk):
        """The out-of-core passes over the driving scan's row ranges, then
        the merge pass over the partials (fed to `Materialized`)."""
        scan, n_chunks, (partial_root, mat, merge_root) = chunk
        table = self.catalog.table(scan.table_name)
        cap = table.capacity
        chunk_cap = (-(-cap // n_chunks) + 8191) // 8192 * 8192
        partials = []
        lo = 0
        while lo < cap:
            hi = min(lo + chunk_cap, cap)
            row_limit = max(0, min(table.num_rows - lo, hi - lo))
            if row_limit == 0 or not self._chunk_maybe_nonempty(
                    scan, table, lo, hi):
                # zone-map chunk skip: per-block min / max prove no row of
                # this range can pass the pushed filters
                self.external_chunks_skipped += 1
                lo = hi
                continue
            rel = self._stage_eager(partial_root, bounds, bindex, brels,
                                    chunk=(scan, lo, hi, row_limit))
            failed = self._failed_checks(rel.checks)
            if failed:
                raise RuntimeError(
                    f"runtime check failed in external pass: {failed}")
            partials.append(rel)
            self.external_passes += 1
            lo = hi
        if not partials:
            # every chunk proven empty: one pass over the first chunk gives
            # the empty / zero aggregate its shape
            partials.append(self._stage_eager(
                partial_root, bounds, bindex, brels,
                chunk=(scan, 0, chunk_cap,
                       max(0, min(table.num_rows, chunk_cap)))))
            self.external_passes += 1
        # concatenate the partials and run the merge pass (partials are
        # group-sized, far below a chunk's working set)
        names = list(partials[0].columns.keys())
        mask = torch.cat([p.mask for p in partials])
        cols = {}
        for n in names:
            parts = [p.columns[n] for p in partials]
            arr = torch.cat([c.array for c in parts])
            valid = None
            if any(c.valid is not None for c in parts):
                valid = torch.cat([
                    c.valid if c.valid is not None
                    else torch.ones(c.array.shape[0], dtype=torch.bool,
                                    device=c.array.device)
                    for c in parts])
            c0 = parts[0]
            cols[n] = RelColumn(arr, c0.dtype, c0.dictionary, c0.domain,
                                valid)
        concat = Relation(cols, mask, int(mask.shape[0]))
        ctx = ExecContext(self.catalog, self.config)
        ctx._cache[id(mat)] = concat
        out = merge_root.execute(ctx)
        failed = self._failed_checks(ctx.checks)
        if failed:
            raise RuntimeError(f"runtime check failed in the merge pass: "
                               f"{failed}")
        out.checks = []
        return out


class PreparedQuery:
    """A prepared statement: bound and optimized once.  Each `execute()`
    re-resolves when the catalog version changes (a DML, a SET that keys
    plans), and then pins the catalog state it resolved against: a
    `Catalog.snapshot()` (columns, index words and deleted rows are never
    written in place, so the snapshot keeps that state) with an executor
    of its own.  `run_pinned()` answers from the pinned state even after a
    later DML; a fresh `execute()` sees the new state."""

    def __init__(self, executor: Executor, plan: PhysicalOperator,
                 optimize: bool = True):
        if optimize:
            plan = opt.optimize(plan, executor.catalog)
        self.executor = executor
        self.plan = plan
        self._cached = None  # (catalog version, the pinned executor)

    def execute(self) -> Relation:
        ver = self.executor._catalog_version()
        if self._cached is None or self._cached[0] != ver:
            self._cached = (ver, self._pin())
        return self.run_pinned()

    def _pin(self) -> Executor:
        from ..storage.table import Catalog

        live = self.executor.catalog
        pinned = Catalog()
        pinned.tables, pinned.foreign_keys = live.snapshot()
        pinned.placement, pinned.device = live.placement, live.device
        pinned.mesh = live.mesh
        return Executor(pinned, self.executor.config)

    def run_pinned(self) -> Relation:
        """Run against the pinned catalog state (staged, as the session's
        queries run, unless `staged_execution` is off)."""
        ex = self._cached[1]
        rel = ex.execute(self.plan, optimize=False, verify=False)
        self.executor.retry_count += ex.retry_count
        ex.retry_count = 0
        return rel
