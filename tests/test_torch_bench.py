"""The port's kernel benchmarks end to end on the CPU:
`benchmarks.q6bench` (the six Q6 forms) and `benchmarks.gather_probe` (the
five gather forms), at SF0.01 and the scripts' own N, so that every check
they make runs (on a CPU device they time nothing).  Sums are compared
exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from duckdb_cubit_tpu_torch.api import connect
from duckdb_cubit_tpu_torch.benchmarks import gather_probe, q6bench
from duckdb_cubit_tpu_torch.ops import q6_variants as qv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def conn():
    return connect(sf=0.01, device="cpu")


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


@pytest.mark.parametrize("module", ["benchmarks.q6bench",
                                    "benchmarks.gather_probe"])
def test_entry_points_refuse_to_run_without_a_card(module, monkeypatch):
    import importlib

    mod = importlib.import_module(f"duckdb_cubit_tpu_torch.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) == 2


def test_drivers_import_without_jax():
    script = (
        "import sys\n"
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
