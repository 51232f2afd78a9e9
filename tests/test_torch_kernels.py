"""Tensor primitives of the torch port (`ops/kernels.py`) against the JAX
package's: selection vectors, exact split sums and order-preserving keys.
All comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_cubit_tpu.ops import kernels as ref_k
from duckdb_cubit_tpu_torch.ops import kernels as k


@pytest.mark.parametrize("n,cap,density", [(1000, 1000, 0.1), (1000, 64, 0.02),
                                           (500, 2048, 0.5), (300, 300, 0.0)])
def test_mask_to_indices_equal(n, cap, density):
    mask = np.random.default_rng(n + cap).random(n) < density
    idx, count = k.mask_to_indices(torch.as_tensor(mask), cap)
    ridx, rcount = ref_k.mask_to_indices(jnp.asarray(mask), cap)
    assert idx.dtype == torch.int64 and count.ndim == 0
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert int(count) == int(rcount) == int(mask.sum())


def test_masked_sum_exact_past_int64_of_parts():
    rng = np.random.default_rng(3)
    vals = rng.integers(-2**62, 2**62, 4096, dtype=np.int64)
    mask = rng.random(4096) < 0.5
    hi, lo = k.masked_sum_exact(torch.as_tensor(vals), torch.as_tensor(mask))
    rhi, rlo = ref_k.masked_sum_exact(jnp.asarray(vals), jnp.asarray(mask))
    assert (int(hi), int(lo)) == (int(rhi), int(rlo))
    exact = sum(int(v) for v in vals[mask])
    assert k.combine_hi_lo(hi, lo) == exact


@pytest.mark.parametrize("floating", [True, False])
def test_monotone_keys_equal_and_invert(floating):
    rng = np.random.default_rng(4)
    if floating:
        vals = np.concatenate([rng.normal(size=64) * 1e6,
                               [0.0, -0.0, 1.5, -1.5, 1e-300, -1e300]])
    else:
        vals = rng.integers(-2**40, 2**40, 64).astype(np.int64)
    keys = k.monotone_i64(torch.as_tensor(vals))
    rkeys = ref_k.monotone_i64(jnp.asarray(vals))
    assert np.array_equal(keys.numpy(), np.asarray(rkeys))
    order = np.argsort(keys.numpy(), kind="stable")
    assert np.all(np.diff(vals[order]) >= 0)
    back = k.monotone_i64_inverse(keys, floating).numpy()
    assert np.array_equal(back, np.where(vals == 0, 0.0, vals)
                          if floating else vals)


def test_gather_columns_clips_sentinels():
    arrays = {"a": torch.arange(10, dtype=torch.int64) * 3}
    out = k.gather_columns(arrays, torch.tensor([0, 4, 10, 10]))
    ref = ref_k.gather_columns({"a": jnp.arange(10) * 3},
                               jnp.asarray([0, 4, 10, 10]))
    assert out["a"].tolist() == np.asarray(ref["a"]).tolist() == [0, 12, 27, 27]
