"""The engine's counter table (`exec/profiler.py`): the profiler imports no
module of the package, every hand-written kernel counts its own launches in
`CudaKernel.launch`, and a statement's `db.sql` root records the table's
change over the statement.  CPU only: a stub stands in for each kernel's
bound launcher."""

import ast
import inspect

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from duckdb_cubit_tpu_torch.api import Connection
from duckdb_cubit_tpu_torch.exec import profiler as PROF
from duckdb_cubit_tpu_torch.ops import (compact, cuda_build, dict_like,
                                        fused_scan, gather_forms, probe,
                                        q6_variants)
from duckdb_cubit_tpu_torch.tpch.load import load_catalog

# the root attributes that PERF.md's layer table and the benchmark's readers
# name
ROOT_NAMES = ("prepare_hits", "prepare_misses", "k1_launches", "k2_launches",
              "retries", "compacted", "dict_entries", "cubit_merges",
              "rows_written", "k6_launches", "pk_probe_rows",
              "sort_probe_rows", "k7_launches", "host_waits")
# name -> (its kernel, its source's stem)
KERNELS = {"k1": (fused_scan.KERNEL, "fused_scan_sum"),
           "k2": (probe.KERNEL, "monotone_gather"),
           "k3": (q6_variants.WORDS_KERNEL, "q6_words_i32"),
           "k4": (q6_variants.MASK8_KERNEL, "q6_mask8_i32"),
           "k5a": (gather_forms.TABLE_KERNEL, "table_gather"),
           "k5b": (gather_forms.LANE_KERNEL, "lane_gather"),
           "k6": (dict_like.KERNEL, "dict_like"),
           "k7": (compact.KERNEL, "stream_compact")}


def test_profiler_imports_no_module_of_the_package():
    tree = ast.parse(inspect.getsource(PROF))
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            imported.append("." * node.level + (node.module or ""))
        elif isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
    assert imported and not [m for m in imported if m.startswith(".")
                             or m.startswith("duckdb_cubit_tpu")], imported


@pytest.mark.parametrize("name", list(KERNELS))
def test_launch_counts_each_launch_that_returned_0(name, monkeypatch):
    """A launcher stub that returns 0 adds exactly 1 to `<name>_launches`
    per `launch()`; one that returns an error raises and adds nothing."""
    kernel, stem = KERNELS[name]
    assert (kernel.name, kernel.stem, kernel.counter) == \
        (name, stem, f"{name}_launches")
    assert kernel in cuda_build.KERNELS
    rcs = []
    monkeypatch.setattr(kernel, "_fn", lambda *args: rcs.pop(0))
    monkeypatch.setattr(cuda_build, "_index", lambda device: 0)
    monkeypatch.setattr(cuda_build, "_raw_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = torch.device("cuda", 0)
    before = PROF.read(kernel.counter)
    rcs += [0, 0]
    kernel.launch(card, 1, 2)
    kernel.launch(card, 1, 2)
    assert PROF.read(kernel.counter) == before + 2
    rcs.append(700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kernel.launch(card, 1, 2)
    assert PROF.read(kernel.counter) == before + 2 and not rcs


def test_counting_an_undeclared_counter_raises():
    with pytest.raises(KeyError):
        PROF.count("no_such_counter")
    assert "no_such_counter" not in PROF.snapshot()


@pytest.mark.parametrize("sql,moved", [
    ("DELETE FROM orders WHERE o_orderkey < 1000",
     {"rows_written", "cubit_merges", "prepare_misses"}),
    ("SELECT count(*) AS n FROM orders "
     "WHERE o_comment LIKE '%special%requests%'",
     {"dict_entries", "prepare_misses", "host_waits"})])
def test_root_records_the_tables_change_over_the_statement(sql, moved):
    """Each counter's delta on the `db.sql` root is the table's change over
    the statement; every name the layer table lists is there, and reads 0
    where nothing counted."""
    conn = Connection(load_catalog(0.01, device="cpu", cache=False),
                      device="cpu")
    PROF.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            before = PROF.snapshot()
            conn.sql(sql)
            after = PROF.snapshot()
        roots = [s[5] for s in PROF.spans() if s[0] == "db.sql"]
    finally:
        PROF.reset()
    (root,) = roots
    assert set(ROOT_NAMES) <= set(root)
    assert {k: root[k] for k in after} == \
        {k: after[k] - before.get(k, 0) for k in after}
    assert all(root[k] > 0 for k in moved)
    assert all(root[k] == 0 for k in ROOT_NAMES if k not in moved)
