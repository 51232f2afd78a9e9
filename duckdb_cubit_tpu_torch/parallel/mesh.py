"""Device mesh and row partitioning on `torch.distributed`.

Counterpart of `duckdb_cubit_tpu/parallel/mesh.py`.  The reference is
single-controller: one process sees every device, a row-sharded array is one
global array placed block by block (GSPMD), and operators run under
`shard_map` with XLA collectives.  The port is SPMD: one process per rank,
each holding its own row block, and every collective is an explicit call on
the mesh's process group.  A function that returns a row-sharded array in
the reference returns the rank's own block here; one that returns a
replicated value returns the same tensor on every rank.

The reference's `row_sharding` and `replicated` are GSPMD placement specs
(`NamedSharding`); torch has no counterpart: a row-sharded value is what
`shard_rows` returns, a replicated one is a tensor every rank holds.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

DATA_AXIS = "d"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over ranks 0..size-1 of the world: its process group,
    this process's rank in it and the device its blocks live on."""
    group: dist.ProcessGroup
    size: int
    rank: int
    device: torch.device


def make_mesh(n_devices: int | None = None, *, backend: str = "nccl",
              device="cuda") -> Mesh | None:
    """A mesh over ranks 0..n-1 of the initialized world (`None`: all of
    it), on a process group of `backend`.  Every rank of the world must call
    it, those outside the mesh included (`new_group` is collective); they
    get None and must run no step.  `device="cuda"` is this rank's card
    (rank modulo the cards the process sees); NCCL without a card raises,
    and nothing falls back to another backend or device."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {device}")
    rank = dist.get_rank()
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a card; none is present")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        # NCCL binds its communicator to the current card
        torch.cuda.set_device(device)
    group = dist.new_group(list(range(n)), backend=backend)
    if rank >= n:
        return None
    return Mesh(group, n, rank, device)


def pad_to_shards(arr: torch.Tensor, n: int) -> torch.Tensor:
    """Pad the rows to a multiple of `n` with copies of the last row."""
    rem = arr.shape[0] % n
    if rem == 0:
        return arr
    return torch.cat([arr, arr[-1:].expand(n - rem, *arr.shape[1:])])


def shard_rows(arr: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's row block of `arr` padded to a multiple of the mesh."""
    padded = pad_to_shards(arr, mesh.size)
    block = padded.shape[0] // mesh.size
    return padded[mesh.rank * block:(mesh.rank + 1) * block].to(mesh.device)


def shard_arrays(arrays: dict, mesh: Mesh,
                 valid_rows: int) -> tuple[dict, torch.Tensor]:
    """This rank's blocks of a column dict, and of the validity mask that
    marks the padded tail invalid."""
    rows = next(iter(arrays.values())).shape[0]
    block = -(-rows // mesh.size)
    start = mesh.rank * block
    mask = torch.arange(start, start + block, device=mesh.device) < valid_rows
    return {k: shard_rows(v, mesh) for k, v in arrays.items()}, mask
