"""Fused scan-sum kernel of the torch port against the JAX Pallas kernel.

The JAX side runs the Pallas kernel in interpret mode on the CPU, fed the
bit-plane words of a numpy mask; the port's plain body takes the same mask in
its own word order (`bitmap.pack_mask`).  Integer sums: exact equality.  The
CUDA cases compare the hand-written kernel with the plain body on the card
and skip where there is none; they need no jax, which a card's machine may
not have.
"""

import numpy as np
import pytest
import torch

from duckdb_cubit_tpu_torch.exec import profiler as PROF
from duckdb_cubit_tpu_torch.ops import bitmap as bm
from duckdb_cubit_tpu_torch.ops import fused_scan as fs

try:
    import jax.numpy as jnp

    from duckdb_cubit_tpu.ops import pallas_kernels as pk
except ImportError:     # no jax: only the cuda cases can run
    jnp = pk = None


def _make(n, seed=0, density=0.03, amax=10_500_000, bmax=10):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < density
    a = rng.integers(0, amax, n).astype(np.int32)
    b = rng.integers(0, bmax + 1, n).astype(np.int32)
    return mask, a, b


def _jax_sum(mask, cols, packed, prod_max):
    plan = pk.plan_fused_scan(len(mask), prod_max, packed)
    planes = pk.plane_pack(jnp.asarray(mask), plan)
    if packed:
        payloads = [pk.pack_columns(jnp.asarray(cols[0]), jnp.asarray(cols[1]))]
    else:
        payloads = [jnp.asarray(c) for c in cols]
    return int(pk.fused_scan_sum(planes, payloads, plan, interpret=True))


def _port_inputs(mask, cols, packed, device="cpu"):
    words = bm.pack_mask(torch.as_tensor(mask, device=device),
                         bm.num_words(len(mask)))
    tcols = [torch.as_tensor(c, device=device) for c in cols]
    payloads = [fs.pack_columns(*tcols)] if packed else tcols
    return words, payloads


CASES = [
    # (n, density, columns, packed): the reference's own cases
    pytest.param(1 << 15, 0.03, 2, True, id="packed-2^15"),
    pytest.param(8192 * 9, 0.03, 2, True, id="packed-ragged-grid"),
    pytest.param(1 << 15, 0.03, 1, False, id="single-column"),
    pytest.param(1 << 15, 0.03, 2, False, id="two-columns-unpacked"),
    pytest.param(1 << 15, 0.0, 2, True, id="empty-mask"),
    pytest.param(1 << 15, 1.0, 2, True, id="full-mask"),
]


@pytest.mark.parametrize("n,density,ncols,packed", CASES)
def test_reference_body_matches_pallas_interpret(n, density, ncols, packed):
    mask, a, b = _make(n, density=density)
    cols = [a, b][:ncols]
    prod_max = 10_500_000 * (10 if ncols == 2 else 1)
    expect = int(np.prod([c.astype(np.int64) for c in cols], axis=0)[mask].sum())
    words, payloads = _port_inputs(mask, cols, packed)
    got = fs.fused_scan_sum_reference(words, payloads, packed)
    assert got.dtype == torch.int64 and got.ndim == 0
    assert int(got) == _jax_sum(mask, cols, packed, prod_max) == expect


def test_wrapper_on_cpu_runs_plain_body_and_counts_no_launch():
    mask, a, b = _make(8192 * 9 + 77, seed=3)
    words, payloads = _port_inputs(mask, [a, b], True)
    before = PROF.read("k1_launches")
    got = fs.fused_scan_sum(words, payloads, True)
    assert PROF.read("k1_launches") == before
    assert int(got) == int(fs.fused_scan_sum_reference(words, payloads, True))


def _tile_edge_mask(n, seed):
    """A mask whose 32-word tiles are all zero, all ones and sparse in turn;
    n is a multiple of neither 32 nor 1024 (a ragged word and tile)."""
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.03
    tile = 32 * 32
    for t in range(0, n, tile):
        kind = (t // tile) % 3
        if kind < 2:
            mask[t:t + tile] = kind == 1
    return mask


@pytest.mark.parametrize("n", [1, 31, 33, 32 * 33 + 5, 1024 * 7 + 999])
def test_scan_sum_bytes_match_a_numpy_count(n):
    mask = _tile_edge_mask(n, seed=n)
    words, _ = _port_inputs(mask, [mask.astype(np.int32)], False)
    # two spare words past the rows: not counted
    words = torch.cat([words, torch.full((2,), -1, dtype=torch.int32)])
    padded = np.zeros(bm.num_words(n) * 32, bool)
    padded[:n] = mask
    nonzero_bytes = int(np.packbits(padded).reshape(-1, 1).any(axis=1).sum())
    for cols in (1, 2):
        assert fs.scan_sum_bytes(words, n, cols) == \
            4 * bm.num_words(n) + 32 * nonzero_bytes * cols


@pytest.mark.parametrize("n", [31, 32 * 33 + 5, 1024 * 7 + 999])
def test_reference_body_on_tile_edges_matches_numpy(n):
    mask = _tile_edge_mask(n, seed=n)
    _, a, b = _make(n, seed=n)
    expect = int((a.astype(np.int64) * b)[mask].sum())
    words, payloads = _port_inputs(mask, [a, b], True)
    assert int(fs.fused_scan_sum_reference(words, payloads, True)) == expect


def test_pack_columns_matches_reference_bits():
    a = np.array([0, 1, 2**24 - 1, 12345], np.int32)
    b = np.array([0, 255, 7, 128], np.int32)
    ours = fs.pack_columns(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    ref = np.asarray(pk.pack_columns(jnp.asarray(a), jnp.asarray(b)))
    assert ours.dtype == np.int32
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("bad", ["dtype", "length", "words", "count",
                                 "packed-two", "noncontiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    mask, a, b = _make(1 << 12, seed=1)
    words, (ta, tb) = _port_inputs(mask, [a, b], False)
    args = {"dtype": (words, [ta.to(torch.int64)], False),
            "length": (words, [ta, tb[:-1]], False),
            "words": (words[:-1], [ta], False),
            "count": (words, [ta, tb, ta], False),
            "packed-two": (words, [ta, tb], True),
            "noncontiguous": (words, [ta[::2]], False)}[bad]
    with pytest.raises((TypeError, ValueError)):
        fs.fused_scan_sum(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


MODES = [(1, False), (2, False), (2, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("ncols,packed", MODES)
@pytest.mark.parametrize("n,density", [
    (8192 * 9 + 77, 0.03),
    *[(n, d) for n in (8192 * 9, 8192 * 9 + 77, 1 << 20)
      for d in (0.0, 1.0, 0.03) if (n, d) != (8192 * 9 + 77, 0.03)]])
def test_cuda_kernel_matches_plain_body(cuda_device, n, density, ncols,
                                        packed):
    """Every mode on ragged and aligned lengths, empty, full and sparse
    masks; each call is one launch."""
    mask, a, b = _make(n, seed=2, density=density)
    words, payloads = _port_inputs(mask, [a, b][:ncols], packed, cuda_device)
    before = PROF.read("k1_launches")
    got = fs.fused_scan_sum(words, payloads, packed)
    torch.cuda.synchronize()
    assert PROF.read("k1_launches") == before + 1
    assert int(got) == int(fs.fused_scan_sum_reference(words, payloads, packed))


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_kernel_sums_past_2_31(cuda_device, packed):
    """Products near 2**31 over 2**24 rows, half of them set: the sum needs
    int64."""
    rng = np.random.default_rng(24)
    n = 1 << 24
    mask = rng.random(n) < 0.5
    a = rng.integers(2**23, 2**24, n).astype(np.int32)
    b = rng.integers(120, 128, n).astype(np.int32)
    words, payloads = _port_inputs(mask, [a, b], packed, cuda_device)
    got = fs.fused_scan_sum(words, payloads, packed)
    want = fs.fused_scan_sum_reference(words, payloads, packed)
    assert int(got) == int(want) > 2**31


@pytest.mark.cuda
@pytest.mark.parametrize("ncols,packed", MODES)
@pytest.mark.parametrize("n", [1, 31, 32 * 33 + 5, 1024 * 7 + 999, 1 << 20,
                               (1 << 20) + 1024 * 5 + 17])
def test_cuda_kernel_on_tile_edges(cuda_device, n, ncols, packed):
    """All-zero, all-ones and sparse 32-word tiles; word counts that are not
    a multiple of the tile, and rows that are not a multiple of 32."""
    mask = _tile_edge_mask(n, seed=n)
    _, a, b = _make(n, seed=n)
    words, payloads = _port_inputs(mask, [a, b][:ncols], packed, cuda_device)
    got = fs.fused_scan_sum(words, payloads, packed)
    torch.cuda.synchronize()
    assert int(got) == int(fs.fused_scan_sum_reference(words, payloads, packed))
