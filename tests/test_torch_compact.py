"""K7, the stream-compaction kernel behind `kernels.mask_to_indices`
(`ops/compact.py`, `csrc/stream_compact.cu`): the wrapper's checks and
device choice here, and on a card the kernel against the plain body, bit
for bit (ids, padding and count).  The plain body is held to the JAX
package in `test_torch_kernels.py`; this file imports no jax."""

import numpy as np
import pytest
import torch

from duckdb_cubit_tpu_torch.exec import profiler as PROF
from duckdb_cubit_tpu_torch.ops import compact, kernels

# (rows, capacity, density): the CPU test's edge cases, then masks of 2**27
# rows at SSB-like densities, then the main path's shapes: SSB SF20's
# lineorder at Q1.1's density and at 0.1%, TPC-H SF1's lineitem at 2%
CASES = [(1000, 1000, 0.1), (1000, 64, 0.02), (500, 2048, 0.5),
         (300, 300, 0.0), (70_001, 65_536, 0.3), (70_001, 1024, 0.5),
         (70_001, 131_072, 0.3), (70_001, 70_001, 1.0), (70_001, 8192, 0.0),
         (70_001, 8192, "last"), (1, 8192, 1.0), (16_385, 16_385, 0.7)]
LARGE = [(2**27, 262_144, 0.001), (2**27, 4_194_304, 0.02),
         (2**27, 2**26, 0.5), (120_000_000, 4_194_304, 0.019),
         (120_000_000, 131_072, 0.001), (6_001_215, 131_072, 0.02)]


def _mask(n: int, density, seed: int) -> np.ndarray:
    if density == "last":
        mask = np.zeros(n, dtype=bool)
        mask[-1] = True
        return mask
    return np.random.default_rng(seed).random(n) < density


def _oracle(mask: np.ndarray, cap: int):
    rows = np.flatnonzero(mask)
    want = np.full(cap, len(mask), dtype=np.int64)
    want[:min(len(rows), cap)] = rows[:cap]
    return want, len(rows)


def test_mask_to_indices_is_the_wrapper():
    assert kernels.mask_to_indices is compact.mask_to_indices


@pytest.mark.parametrize("n,cap,density", CASES[4:])
def test_cpu_runs_plain_body_and_counts_no_launch(n, cap, density):
    mask = _mask(n, density, n + cap)
    before = PROF.read("k7_launches")
    idx, count = compact.mask_to_indices(torch.as_tensor(mask), cap)
    assert PROF.read("k7_launches") == before
    want, total = _oracle(mask, cap)
    assert idx.dtype == torch.int64 and count.dtype == torch.int64
    assert count.ndim == 0 and int(count) == total
    np.testing.assert_array_equal(idx.numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "2d", "noncontiguous", "meta"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    mask = torch.ones(64, dtype=torch.bool)
    arg = {"dtype": mask.to(torch.uint8), "2d": mask.reshape(8, 8),
           "noncontiguous": mask[::2],
           "meta": torch.ones(64, dtype=torch.bool, device="meta")}[bad]
    with pytest.raises((TypeError, ValueError)):
        compact.mask_to_indices(arg, 16)


def test_status_words_count_tiles_from_the_boundary_below():
    base = torch.zeros(3 * compact.TILE_BYTES + 16, dtype=torch.bool)
    assert base.data_ptr() % 16 == 0
    assert compact.status_words(base[:compact.TILE_BYTES]) == 2
    assert compact.status_words(base[1:compact.TILE_BYTES]) == 2
    assert compact.status_words(base[1:compact.TILE_BYTES + 1]) == 3
    assert compact.status_words(base[15:]) == 5


def test_compact_bytes_are_the_mask_and_the_slots():
    assert compact.compact_bytes(120_000_000, 4_194_304) == \
        120_000_000 + 8 * 4_194_304


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal_on_card(mask: torch.Tensor, cap: int):
    before = PROF.read("k7_launches")
    idx, count = compact.mask_to_indices(mask, cap)
    torch.cuda.synchronize()
    assert PROF.read("k7_launches") == before + 1
    want, want_count = compact.mask_to_indices_reference(mask, cap)
    assert idx.dtype == torch.int64 and count.ndim == 0
    assert int(count) == int(want_count)
    assert torch.equal(idx, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap,density", CASES + LARGE)
def test_cuda_kernel_matches_plain_body(cuda_device, n, cap, density):
    mask = torch.as_tensor(_mask(n, density, n + cap), device=cuda_device)
    _equal_on_card(mask, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
def test_cuda_kernel_on_views_off_a_16_byte_boundary(cuda_device, offset):
    base = torch.as_tensor(_mask(70_001 + offset, 0.4, offset),
                           device=cuda_device)
    _equal_on_card(base[offset:], 65_536)
    _equal_on_card(base[offset:offset + 9], 16)


def test_root_span_counts_the_launches(monkeypatch):
    """`k7_launches` on each `db.sql` root is the rise of the counter: on
    the CPU none; with a stand-in that counts as a launch would, one for
    each compaction of the statement."""
    from torch.profiler import ProfilerActivity, profile

    from duckdb_cubit_tpu_torch.api import Connection
    from duckdb_cubit_tpu_torch.tpch.load import load_catalog
    from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL

    conn = Connection(load_catalog(0.01, device="cpu"), device="cpu")
    calls = []

    def counting(mask, cap):
        calls.append(cap)
        PROF.count("k7_launches")
        return compact.mask_to_indices_reference(mask, cap)

    PROF.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            conn.sql(SQL[3]).strings()
            monkeypatch.setattr(kernels, "mask_to_indices", counting)
            conn.sql(SQL[3]).strings()
        roots = [s[5] for s in PROF.spans() if s[0] == "db.sql"]
    finally:
        PROF.reset()
    assert [r["k7_launches"] for r in roots] == [0, len(calls)]
    assert len(calls) >= roots[1]["compacted"] > 0
