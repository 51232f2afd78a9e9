"""Sharded catalogs: the engine's placement on a mesh, and how it executes.

Counterpart of `duckdb_cubit_tpu/parallel/shard.py`.  The reference marks
its arrays with `NamedSharding`s and lets GSPMD insert every collective.
Torch has no such pass, so the port runs **SPMD over ranks**: every rank of
the mesh runs the same plan, and each operator that crosses row blocks makes
one explicit collective on the mesh's process group.

Placement (`shard_table`, `shard_catalog`):

- a table whose capacity divides into `32 * n` is **sharded**: rank r holds
  rows `[r*B, (r+1)*B)` with `B = capacity // n` of every column's data and
  NULL mask, of `deleted`, and words `[r*B/32, (r+1)*B/32)` of every CUBIT
  index's words and cumulative words (`Table.row_offset`, `Table.blocks`);
- any other table (one on a 3-rank mesh, say) is replicated whole, as the
  reference's `_row_spec` replicates an array that does not divide;
- PK luts (and the value luts built from them) are replicated;
- zone maps, dictionaries, domains, `num_rows`, the host mirrors and the
  CUBIT bin counts stay global, so every plan decision reads the same
  values on every rank.

Execution (`plan/physical.py`, `exec/executor.py`):

- a `Relation` is *sharded* (this rank's row block; the global relation is
  the blocks in rank order, for a base-table scan exactly the single-device
  row positions) or *replicated* (the same tensors on every rank);
- row-local operators keep a block sharded: TableScan, Filter, Project,
  BroadcastScalar, a HashJoin's probe side with its build side gathered
  whole (a broadcast join), and the radix-exchange join
  (`parallel/exchange_join.py`), whose sharded sides give a sharded output;
- partial-then-reduce: GroupAggregate, ungrouped or over dense group slots
  that are the same on every rank, computes exact split sums, counts, MIN
  and MAX per block and adds them with one `all_reduce` per kind, giving a
  replicated result;
- every other operator gathers its sharded inputs (`gather_relation`: one
  `all_gather` per column, NULL mask and row mask, in rank order) and runs
  the single-device code, giving a replicated result;
- every host read of sharded data is a collective, so all ranks take the
  same branch: the deferred checks are reduced with MIN, a stage boundary's
  compaction count with MAX;
- `Executor.execute` returns a replicated relation on every rank.

Changes (`storage/dml.py`): every rank runs each statement with the same
global row ids and values, writes the rows of its own block and makes the
same change to the global host state; a CUBIT index merges the bits of its
block's rows and counts every row's delta.  An append that grows a table's
capacity places it anew (`block_bounds` of the new capacity): each rank
cuts its block from the host mirrors and rebuilds the indexes over them.

The source catalog is best a CPU load (`load_catalog(sf, device="cpu")`):
each rank then copies only its blocks to its device.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist

from ..index.cubit import CubitIndex
from ..index.pk import DirectPKIndex
from ..storage.table import Catalog, Table
from .exchange import unwire, wire
from .mesh import Mesh

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def is_shardable(capacity: int, n: int) -> bool:
    """Whether a table of `capacity` rows splits into `n` row blocks whose
    index words split along (each block a multiple of 32 rows)."""
    return capacity % (32 * n) == 0


def block_bounds(capacity: int, mesh: Mesh) -> tuple[int, int, bool]:
    """This rank's (block capacity, first global row, sharded) for a table
    of `capacity` rows: its row block when the capacity divides
    (`is_shardable`), else the whole table."""
    if is_shardable(capacity, mesh.size):
        block = capacity // mesh.size
        return block, mesh.rank * block, True
    return capacity, 0, False


def _place(x: torch.Tensor | None, device) -> torch.Tensor | None:
    """A contiguous copy of its own on `device` (a block never keeps the
    source tensor alive)."""
    if x is None:
        return None
    return x.to(device, copy=True, memory_format=torch.contiguous_format)


def shard_index(ix: CubitIndex, mesh: Mesh, sharded: bool) -> CubitIndex:
    """A CUBIT index over this rank's block (or whole, when its table is
    replicated): its queries then return the block's bits, and its host bin
    counts, which plans read, stay global."""
    out = ix.clone()
    out._query_cache = {}   # cached query words live on the old device
    out.device = mesh.device
    if sharded:
        w = ix.n_words // mesh.size
        lo = mesh.rank * w
        out.words = _place(ix.words[:, lo:lo + w], mesh.device)
        if ix.cum_words is not None:
            out.cum_words = _place(ix.cum_words[:, lo:lo + w], mesh.device)
        out.n_words = w
        out.capacity = ix.capacity // mesh.size
        out.row_offset = lo * 32
    else:
        out.words = _place(ix.words, mesh.device)
        out.cum_words = _place(ix.cum_words, mesh.device)
    return out


def shard_pk(pk: DirectPKIndex, mesh: Mesh) -> DirectPKIndex:
    """A PK index replicated on this rank's device (its value luts are built
    again there, from the global host mirrors)."""
    out = DirectPKIndex(pk.column, _place(pk.lut, mesh.device), pk.max_key,
                        pk.base)
    out._lut_host = pk._lut_host
    return out


def shard_table(table: Table, mesh: Mesh) -> Table:
    """This rank's copy of `table` on the mesh: its row block when the
    capacity divides (`is_shardable`), else the whole table."""
    if table.sharded:
        raise ValueError(f"table {table.name} is already a row block")
    block, lo, sharded = block_bounds(table.capacity, mesh)

    def place(x):
        return None if x is None else _place(x[lo:lo + block], mesh.device)

    t = copy.copy(table)
    t.columns = {}
    for name, c in table.columns.items():
        c2 = copy.copy(c)
        c2.data = place(c.data)
        c2.nulls = place(c.nulls)
        # the host mirrors stay global: value luts, index builds and the
        # row-by-row verifier read them
        if c2.host is None:
            c2.host = c.data[:table.num_rows].cpu().numpy()
        if c.nulls is not None and c2.nulls_host is None:
            c2.nulls_host = c.nulls[:table.num_rows].cpu().numpy()
        t.columns[name] = c2
    t.deleted = place(table.deleted)
    t.indexes = {name: shard_index(ix, mesh, sharded)
                 for name, ix in table.indexes.items()}
    t.pk_indexes = {name: shard_pk(pk, mesh)
                    for name, pk in table.pk_indexes.items()}
    t.unique_keys = list(table.unique_keys)
    t.capacity = block
    t.device = mesh.device
    t.sharded = sharded
    t.row_offset = lo
    t.blocks = mesh.size if sharded else 1
    t.mesh = mesh
    t.uid = next(Table._UIDS)
    return t


def place_catalog(catalog: Catalog, mesh: Mesh) -> Catalog:
    """Mark `catalog` as placed on `mesh` (its tables must be already)."""
    catalog.placement = f"mesh{mesh.size}:{id(mesh)}"
    catalog.mesh = mesh
    catalog.device = mesh.device
    return catalog


def shard_catalog(catalog: Catalog, mesh: Mesh) -> Catalog:
    """A new catalog with every table of `catalog` placed on the mesh; the
    source is left untouched (the prepare cache keys on `placement`, so the
    two never share prepared plans)."""
    out = Catalog()
    for t in catalog.tables.values():
        out.register(shard_table(t, mesh))
    out.foreign_keys = dict(catalog.foreign_keys)
    return place_catalog(out, mesh)


# ------------------------------------------------------------ collectives

def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' blocks of `x` concatenated in rank order (one
    `all_gather`; a bool or int16 tensor travels as its bytes)."""
    send = wire(x)
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send, group=mesh.group)
    return unwire(torch.cat(parts), x.dtype)


def all_reduce(x: torch.Tensor, mesh: Mesh, kind: str = "sum"):
    """`x` reduced over the mesh in place (kind: sum, min or max)."""
    dist.all_reduce(x, op=_OPS[kind], group=mesh.group)
    return x


def all_ok(flags: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A bool tensor ANDed over the mesh (an int MIN)."""
    x = flags.to(torch.int32)
    return all_reduce(x, mesh, "min").to(torch.bool)


def gather_relation(rel, mesh: Mesh):
    """A sharded relation whole on every rank: each column, NULL mask and
    the row mask gathered in rank order.  A replicated relation is returned
    as it is.  No column claims `monotone` after a gather."""
    from ..plan.physical import RelColumn, Relation

    if not rel.sharded:
        return rel
    cols = {n: RelColumn(all_gather_rows(c.array, mesh), c.dtype,
                         c.dictionary, c.domain,
                         None if c.valid is None
                         else all_gather_rows(c.valid, mesh))
            for n, c in rel.columns.items()}
    return Relation(cols, all_gather_rows(rel.mask, mesh),
                    rel.capacity * mesh.size)


def block_of(rel, mesh: Mesh):
    """This rank's row block of a replicated relation whose capacity
    divides into the mesh (no communication: every rank holds it all)."""
    from ..plan.physical import RelColumn, Relation

    if rel.sharded:
        return rel
    b = rel.capacity // mesh.size
    lo, hi = mesh.rank * b, (mesh.rank + 1) * b
    cols = {n: RelColumn(c.array[lo:hi], c.dtype, c.dictionary, c.domain,
                         None if c.valid is None else c.valid[lo:hi],
                         monotone=c.monotone)
            for n, c in rel.columns.items()}
    return Relation(cols, rel.mask[lo:hi], b, sharded=True)


def gather_table(table: Table, mesh: Mesh) -> Table:
    """The whole table on the host of every rank, from its row blocks (the
    row-by-row verifier reads it; it must never read a block as if it were
    the table)."""
    if not table.sharded:
        return table
    t = copy.copy(table)
    t.columns = {}
    for name, c in table.columns.items():
        c2 = copy.copy(c)
        c2.data = all_gather_rows(c.data, mesh).cpu()
        c2.nulls = None if c.nulls is None else \
            all_gather_rows(c.nulls, mesh).cpu()
        t.columns[name] = c2
    t.deleted = None if table.deleted is None else \
        all_gather_rows(table.deleted, mesh).cpu()
    t.indexes, t.pk_indexes = {}, {}
    t.capacity = table.global_capacity
    t.device = torch.device("cpu")
    t.sharded, t.row_offset, t.blocks, t.mesh = False, 0, 1, None
    return t


def host_catalog(catalog: Catalog, names) -> Catalog:
    """A catalog of the named tables whole on the host (`gather_table`)."""
    out = Catalog()
    for name in sorted(set(names)):
        out.register(gather_table(catalog.table(name), catalog.mesh))
    out.foreign_keys = dict(catalog.foreign_keys)
    out.device = torch.device("cpu")
    return out
