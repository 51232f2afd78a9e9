"""User-facing connection API.

Counterpart of `duckdb_cubit_tpu/api.py`: `Connection.sql()` drives parse ->
bind -> optimize -> execute over the port's device tensors for a SELECT, and
hands every other statement to `sql/statements.py` (CREATE TABLE [AS],
CREATE INDEX, INSERT, DELETE, UPDATE, DROP, SET, BEGIN / COMMIT / ROLLBACK,
EXPLAIN, PRAGMA).  The device is the card unless the caller asks for
another: `connect(sf)` and `Connection(...)` default to `device="cuda"` (and
raise where there is no card; nothing falls back to the CPU),
`device="cpu"` runs the plain torch bodies.  Every table of the catalog must
live on the connection's device.

A transaction is a catalog snapshot (`Catalog.snapshot`): ROLLBACK restores
it.  Durability (`storage/persist.py`): after `attach(path)` every DDL / DML
statement that succeeds, CREATE TABLE AS included, is appended to the
directory's write-ahead log (inside a transaction, buffered until COMMIT),
and `checkpoint()` writes the catalog and truncates the log.

`prepare(sql)` / `prepare_plan(plan)` bind and optimize once; each
`execute()` re-resolves when a table changes (`exec/executor.PreparedQuery`).
`sql(q, profile=True)` and `execute_plan(plan, profile=True)` time every
operator (`conn.executor.profiler`).  `SET query_timeout_s = x` abandons a
SELECT that takes longer with `QueryTimeoutError`.

On a mesh (`connect(sf, device=..., mesh=make_mesh(n))`, called on every
rank of a `torch.distributed` world, e.g. inside `parallel/spawn.run`) the
catalog is sharded (`parallel/shard.py`): each rank holds its row blocks on
the mesh's device, runs the same plans, and gets the same rows back.  The
TPC-H catalog is loaded on the host and each rank copies its blocks to its
card.  DML and transactions change each rank's blocks and the same global
host state on every rank (`storage/dml.py`).  Rank 0 alone writes the
durable directory (`attach`, the write-ahead log, `checkpoint`, which
gathers what only the blocks hold); a database reopens onto a mesh as
`Connection(open_database(path, device="cpu").catalog, device=...,
mesh=mesh)`.  Under `query_timeout_s` the alarm only sets a flag, which the
ranks read together (`Executor.poll_deadline`): every rank raises
`QueryTimeoutError` at the same collective.
"""

from __future__ import annotations

import signal
import threading

import torch

from .exec import profiler as PROF
from .exec import result as R
from .exec.executor import Executor
from .sql import ast as A
from .sql.binder import Binder
from .storage.table import Catalog, from_numpy

# the statements the write-ahead log records (CREATE TABLE AS included: the
# reference leaves it out, so its tables were lost on restart)
_LOGGED = (A.CreateTable, A.CreateTableAs, A.CreateIndex, A.Insert, A.Delete,
           A.Update, A.DropTable)


class Result:
    """A SELECT's rows, materialized on the host on request; or a
    statement's status and its static rows (EXPLAIN, PRAGMA tpch)."""

    def __init__(self, relation, status: str | None = None,
                 static_rows: list | None = None):
        self.relation = relation
        self.status = status
        self._static_rows = static_rows

    def rows(self) -> list[tuple]:
        if self.relation is None:
            return [tuple(r) for r in (self._static_rows or [])]
        _, rows, _ = R.materialize(self.relation)
        return rows

    def strings(self) -> list[list[str]]:
        if self.relation is None:
            return [[str(v) for v in r] for r in (self._static_rows or [])]
        return R.to_strings(self.relation)

    def __repr__(self):
        rows = self.strings()
        if not rows and self.status:
            return self.status
        head = [" | ".join(r) for r in rows[:20]]
        more = f"\n... ({len(rows)} rows)" if len(rows) > 20 else ""
        return "\n".join(head) + more


class QueryTimeoutError(RuntimeError):
    """A SELECT exceeded `config.query_timeout_s`: it is abandoned and the
    session stays usable.  The deadline is a SIGALRM handler, which runs
    only between Python steps: a device wait in progress is not cut short,
    and kernels already queued on the card finish after the exception.  On
    a mesh it is raised at the first collective after the alarm, on every
    rank.  A query cut short leaves no half-set state: the prepare cache is
    written in one step, once a plan's decisions are all made."""


class _QueryDeadline:
    """SIGALRM-based per-query deadline (main thread only; a no-op
    elsewhere: other threads cannot receive SIGALRM).  With `flag_only`
    (on a mesh) the alarm sets `expired` instead of raising: a rank that
    raised inside a collective would leave the others waiting."""

    def __init__(self, seconds: float, flag_only: bool = False):
        self.seconds = seconds
        self.flag_only = flag_only
        self.active = False
        self.expired = False

    def error(self) -> QueryTimeoutError:
        return QueryTimeoutError(
            f"query exceeded {self.seconds:.1f}s deadline "
            f"(SET query_timeout_s = 0 to disable)")

    def __enter__(self):
        off_main = (threading.current_thread()
                    is not threading.main_thread())
        if self.seconds <= 0 or off_main:
            return self

        def on_alarm(signum, frame):
            if self.flag_only:
                self.expired = True
            else:
                raise self.error()

        self._old = signal.signal(signal.SIGALRM, on_alarm)
        signal.setitimer(signal.ITIMER_REAL, self.seconds)
        self.active = True
        return self

    def __exit__(self, *exc):
        if self.active:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, self._old)
        return False


class Connection:
    def __init__(self, catalog: Catalog | None = None, config=None, *,
                 device="cuda", mesh=None):
        from .config import EngineConfig

        self.device = torch.device(device)
        self.mesh = mesh
        self.catalog = catalog if catalog is not None else Catalog()
        if mesh is not None:
            self.device = self._mesh_device(mesh)
            self.catalog = self._placed(self.catalog)
        self._check_device(self.catalog)
        self.catalog.device = self.device
        self.config = config if config is not None else EngineConfig()
        self.executor = Executor(self.catalog, self.config)
        self.binder = Binder(self.catalog, self.executor)
        self._txn_snapshot = None
        self._txn_wal: list[str] | None = None
        # the durable directory (storage/persist.py), None when in memory
        self.db_path: str | None = None
        self._wal_replaying = False

    def _mesh_device(self, mesh) -> torch.device:
        """The mesh's device, which must be the one the caller asked for."""
        want = self.device
        if mesh.device.type != want.type or (
                want.index is not None and mesh.device.index != want.index):
            raise ValueError(f"the mesh is on {mesh.device}, the connection "
                             f"on {want}")
        return mesh.device

    def _placed(self, catalog: Catalog) -> Catalog:
        """`catalog` on the mesh: its tables sharded, or, when it has none
        yet, marked so that the tables registered later are."""
        from .parallel import shard

        if catalog.tables:
            return shard.shard_catalog(catalog, self.mesh)
        return shard.place_catalog(catalog, self.mesh)

    def register_table(self, table):
        """Add a table to the catalog (this rank's copy of it on a mesh)."""
        if self.mesh is not None:
            from .parallel.shard import shard_table

            table = shard_table(table, self.mesh)
        self.catalog.register(table)

    @property
    def writes_files(self) -> bool:
        """Whether this process writes the durable directory: on a mesh,
        rank 0 alone (every rank keeps `db_path`, so all take the same
        branches)."""
        return self.mesh is None or self.mesh.rank == 0

    def attach(self, path: str):
        """Make the connection durable under `path`: later DDL / DML go to
        its write-ahead log.  ":memory:" keeps it in memory (no directory is
        made; the reference creates one named ":memory:")."""
        import os

        if path == ":memory:":
            self.db_path = None
            return self
        if self.writes_files:
            os.makedirs(path, exist_ok=True)
        self.db_path = path
        return self

    def checkpoint(self, path: str | None = None):
        """Write the catalog to disk and truncate the write-ahead log (on a
        mesh: every rank takes part, rank 0 writes, and no rank returns
        before the files are complete)."""
        from .storage.persist import checkpoint

        target = path or self.db_path
        if target is None:
            raise ValueError("no database path: attach(path) first")
        checkpoint(self, target)
        self.db_path = target

    def _check_device(self, catalog: Catalog):
        for t in catalog.tables.values():
            if t.device != self.device:
                raise ValueError(f"table {t.name} is on {t.device}, the "
                                 f"connection on {self.device}")

    # -------------------------------------------------------------- data in
    def register_numpy(self, name: str, columns: dict, schema=None):
        # on a mesh the table is built on the host and each rank copies its
        # block to its device
        self.register_table(from_numpy(
            name, columns, schema,
            device="cpu" if self.mesh is not None else self.device))

    def load_tpch(self, sf: float = 0.01):
        from .tpch import load

        if self.mesh is None:
            self.catalog = load.load_catalog(sf, device=self.device)
        else:
            # a host load, sharded: no rank holds the whole catalog on its
            # device
            self.catalog = self._placed(load.load_catalog(sf, device="cpu"))
        self.catalog.device = self.device
        self.executor = Executor(self.catalog, self.config)
        self.binder = Binder(self.catalog, self.executor)
        return self

    # ------------------------------------------------------------- querying
    def sql(self, query: str, profile: bool = False) -> Result:
        """Run one statement: a SELECT's rows (rendered on request), or
        another statement's status.  The whole call is the span `db.sql`
        (`exec/profiler.py`)."""
        with PROF.statement(self.executor) as root:
            return self._sql(query, profile, root)

    def _sql(self, query: str, profile: bool, root) -> Result:
        from .sql import statements
        from .sql.parser import parse_statement

        with PROF.span("db.parse"):
            stmt = parse_statement(query)
        root.set(kind=_kind(stmt))
        if isinstance(stmt, A.SelectStmt):
            # the deadline covers a SELECT only: DML and transactions are
            # never cut midway
            timeout = self.config.query_timeout_s
            on_mesh = timeout > 0 and self.mesh is not None
            with _QueryDeadline(timeout, flag_only=on_mesh) as deadline:
                # on a mesh the executor reads the alarm's flag, reduced
                # over the ranks, at its collectives
                self.executor.deadline = deadline if on_mesh else None
                try:
                    with PROF.span("db.bind"):
                        plan = self.binder.bind(stmt)
                    rel = self.executor.execute(plan, profile=profile)
                    # the result's count is where a long device queue
                    # blocks: read it inside the deadline when one is set
                    if timeout > 0:
                        with PROF.wait("result"):
                            rel.count()
                        with PROF.wait("deadline"):
                            self.executor.poll_deadline()
                finally:
                    self.executor.deadline = None
            return Result(rel)
        status, rows = statements.execute_statement(self, stmt)
        if (self.db_path and self.writes_files and not self._wal_replaying
                and isinstance(stmt, _LOGGED)):
            # logged only once the statement succeeded; inside a transaction
            # the entries wait for COMMIT, so a rolled-back statement never
            # reaches the log
            if self._txn_wal is not None:
                self._txn_wal.append(query)
            else:
                from .storage.persist import wal_append

                wal_append(self.db_path, query)
        return Result(None, status=status, static_rows=rows)

    # ------------------------------------------------------- transactions
    def begin(self):
        if self._txn_snapshot is not None:
            raise RuntimeError("transaction already active")
        with PROF.span("db.begin"):
            self._txn_snapshot = self.catalog.snapshot()
        self._txn_wal = []

    def commit(self):
        if self._txn_snapshot is None:
            raise RuntimeError("no active transaction")
        with PROF.span("db.commit"):
            if self.db_path and self.writes_files and self._txn_wal:
                from .storage.persist import wal_append

                for q in self._txn_wal:
                    wal_append(self.db_path, q)
        self._txn_snapshot = None
        self._txn_wal = None

    def rollback(self):
        if self._txn_snapshot is None:
            raise RuntimeError("no active transaction")
        with PROF.span("db.rollback"):
            self.catalog.restore(self._txn_snapshot)
        self._txn_snapshot = None
        self._txn_wal = None

    def execute_plan(self, plan, profile: bool = False) -> Result:
        return Result(self.executor.execute(plan, profile=profile))

    def prepare(self, query: str):
        """Parse, bind and optimize once; the returned PreparedQuery's
        `execute()` runs the plan, re-resolving when a table changes."""
        from .exec.executor import PreparedQuery

        return PreparedQuery(self.executor, self.binder.bind_sql(query))

    def prepare_plan(self, plan):
        from .exec.executor import PreparedQuery

        return PreparedQuery(self.executor, plan)

    def tpch_query(self, n: int) -> Result:
        from .tpch import queries

        return Result(queries.run(self.executor, n))

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


def _kind(stmt) -> str:
    """The statement's kind, as the root span `db.sql` records it."""
    if isinstance(stmt, A.SelectStmt):
        return "select"
    if isinstance(stmt, A.TransactionStmt):
        return stmt.kind
    return {A.Insert: "insert", A.Delete: "delete"}.get(type(stmt), "other")


def connect(sf: float | None = None, *, device="cuda",
            mesh=None) -> Connection:
    """Open a connection whose tensors live on `device` (the card unless the
    caller asks for "cpu"); with `sf`, load the TPC-H catalog at that scale
    factor.  With `mesh` (`parallel/mesh.make_mesh`, on `device`), every
    rank that calls it holds its row blocks of the catalog."""
    conn = Connection(device=device, mesh=mesh)
    if sf is not None:
        conn.load_tpch(sf)
    return conn
