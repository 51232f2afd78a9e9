"""Rank-side case of `tests/test_torch_load.py`: ranks that write and read
the TPC-H disk cache at once.  Imports no jax."""

import hashlib

import torch.distributed as dist

from duckdb_cubit_tpu_torch.tpch import dbgen, load


def digest(catalog) -> dict:
    """Per table: rows and a hash of every column's live host values."""
    out = {}
    for name, t in sorted(catalog.tables.items()):
        h = hashlib.sha256()
        for cname, c in sorted(t.columns.items()):
            h.update(cname.encode())
            h.update(c.data[:t.num_rows].numpy().tobytes())
        out[name] = (t.num_rows, h.hexdigest())
    return out


def concurrent_load(mesh, cache_dir, sf):
    """Every rank generates SF `sf`, then, after a barrier, all write the
    same disk-cache file at once and load the catalog from it."""
    load.DISK_CACHE_DIR = cache_dir
    encoded = load._encode_tables(dbgen.gen_all(sf))
    dist.barrier(group=mesh.group)
    load._save_disk_cache(sf, encoded)
    dist.barrier(group=mesh.group)
    return digest(load.load_catalog(sf, device="cpu", cache=False))
