"""The TPC-H disk cache under concurrent writers: the ranks of a mesh load
the same scale factor at once.

4 gloo ranks (`parallel/spawn.run`) each point the loader's cache directory
at one fresh temporary directory, write SF0.01's cache file at the same
moment (after a barrier), and load the catalog from it.  Every rank must get
the catalog a plain load gives, and no temporary file may be left: each
writer writes a whole file of its own and renames it into place.
"""

import os

from duckdb_cubit_tpu_torch.parallel import spawn
from duckdb_cubit_tpu_torch.tpch import load

import torch_load_ranks as R

SF = 0.01


def test_concurrent_cache_writers(tmp_path):
    cache_dir = str(tmp_path / "cache")
    got = spawn.run(R.concurrent_load, 4, cache_dir, SF, backend="gloo",
                    device="cpu", deadline_s=120)
    want = R.digest(load.load_catalog(SF, device="cpu", cache=False,
                                      disk_cache=False))
    assert all(g == want for g in got)
    assert os.listdir(cache_dir) == [f"tpch_sf{SF}.npz"]
