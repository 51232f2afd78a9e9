"""The port's benchmark entry points end to end on the CPU: `bench`
(Q6 variants through K1's wrapper, the l_orderkey -> orders probes),
`benchmarks.q6bench` (the six Q6 forms) and `benchmarks.gather_probe` (the
five gather forms), at SF0.01 and the scripts' own N, so that every check
they make runs (on a CPU device they time nothing).  Sums and row ids are
compared exactly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from duckdb_cubit_tpu_torch import bench
from duckdb_cubit_tpu_torch.api import connect
from duckdb_cubit_tpu_torch.benchmarks import gather_probe, q6bench
from duckdb_cubit_tpu_torch.ops import fused_scan as fs
from duckdb_cubit_tpu_torch.ops import q6_variants as qv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def conn():
    return connect(sf=0.01, device="cpu")


def test_bench_runs_its_checks_and_reports_sections(conn, monkeypatch):
    calls = []
    real = fs.fused_scan_sum
    monkeypatch.setattr(fs, "fused_scan_sum",
                        lambda *a: calls.append(a) or real(*a))
    line = bench.run(conn.catalog, "cpu", 0.01)
    assert line["metric"] == "tpch_sf0.01_q6_e2e_rows_per_s"
    q6 = line["sections"]["q6_bitmap_scan"]
    # the canonical variant against Q6 through a default connection (which
    # decodes row ids at SF0.01 and never reaches K1's wrapper)
    assert [[q6["canonical_q6"]]] == conn.sql(bench.Q6).strings() == \
        [["1193053.2253"]]
    assert len(calls) >= bench.Q6_VARIANTS
    assert q6["packed"] and q6["e2e_bytes_per_row"] == 4.875
    assert set(line["sections"]) == {"q6_bitmap_scan", "join_probe",
                                     "join_probe_xla", "join_probe_csr"}
    assert line["value"] is None    # nothing timed off the card
    json.dumps(line)


def test_q6_variant_filters_are_the_references():
    filters = list(bench.q6_variant_filters())
    assert len(filters) == 32
    from duckdb_cubit_tpu_torch.types import date_to_days
    assert filters[bench.CANONICAL] == (
        ("l_shipdate", date_to_days("1994-01-01"),
         date_to_days("1994-12-31")),
        ("l_discount", 5, 7), ("l_quantity", None, 2399))


def test_q6bench_runs_its_checks(conn):
    summary = q6bench.run(conn.catalog, "cpu")
    assert summary["n"] == conn.catalog.table("lineitem").capacity
    assert summary["variants"] == q6bench.NV and summary["forms"] == {}


def test_q6bench_check_counts_wrapped_variants():
    """A wrapped low half is reported, a difference that is not a multiple
    of 2**32 raises."""
    exact = torch.tensor([5, 7 + 2**33, 9], dtype=torch.int64)
    wrapped = torch.tensor([5, 7, 9], dtype=torch.int64)
    results = {"fused_words": exact, "fused_mask8": exact.clone(),
               "fused_mask_i32": wrapped, "pallas_words": wrapped.clone(),
               "pallas_mask8": wrapped.clone()}
    assert q6bench.check(results) == 1
    results["pallas_words"] = wrapped + 1
    with pytest.raises(AssertionError):
        q6bench.check(results)


def test_q6bench_variants_are_the_scripts_words():
    words, masks = q6bench.variants(8192, 2, "cpu")
    want = np.random.default_rng(0).integers(0, 2**32, size=(2, 256),
                                             dtype=np.uint32)
    np.testing.assert_array_equal(words.numpy(), want.view(np.int32))
    bits = (want[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(masks.numpy(), bits.reshape(2, -1))
    assert int(qv.combine(qv.q6_mask8_i32(masks[1], *[
        torch.ones(8192, dtype=torch.int32)] * 2))) == int(bits[1].sum())


def test_gather_probe_runs_its_checks():
    summary = gather_probe.run("cpu")
    assert summary["n"] == gather_probe.N and summary["forms"] == {}


@pytest.mark.parametrize("module", ["bench", "benchmarks.q6bench",
                                    "benchmarks.gather_probe"])
def test_entry_points_refuse_to_run_without_a_card(module, monkeypatch):
    import importlib

    mod = importlib.import_module(f"duckdb_cubit_tpu_torch.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) == 2


def test_drivers_import_without_jax():
    script = (
        "import sys\n"
        "import duckdb_cubit_tpu_torch.bench\n"
        "import duckdb_cubit_tpu_torch.benchmarks.q6bench\n"
        "import duckdb_cubit_tpu_torch.benchmarks.gather_probe\n"
        "import duckdb_cubit_tpu_torch.ops.join\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'duckdb_cubit_tpu')]\n"
        "assert not loaded, loaded\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
