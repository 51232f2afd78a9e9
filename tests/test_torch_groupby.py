"""Grouped and sorted-segment primitives of the torch port (`ops/kernels.py`,
`ops/groupby.py`) against the JAX package's, with masked rows and NULL-flag
keys.  Integer results, group ids and representative rows: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_cubit_tpu.ops import groupby as ref_g
from duckdb_cubit_tpu.ops import kernels as ref_k
from duckdb_cubit_tpu_torch.ops import groupby as g
from duckdb_cubit_tpu_torch.ops import kernels as k

I64 = np.iinfo(np.int64)


def _data(n, num_groups, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, num_groups, n).astype(np.int32)
    values = rng.integers(-2**62, 2**62, n, dtype=np.int64)
    mask = rng.random(n) < 0.7
    return codes, values, mask


def _eq(port, ref):
    assert np.array_equal(port.numpy(), np.asarray(ref))


# num_groups on both sides of the small-group limit: unrolled and scatter
GROUPS = [pytest.param(7, id="unrolled"), pytest.param(300, id="scatter")]


@pytest.mark.parametrize("num_groups", GROUPS)
def test_group_sum_exact_and_count(num_groups):
    codes, values, mask = _data(5000, num_groups, num_groups)
    hi, lo = k.group_sum_exact(torch.as_tensor(codes), torch.as_tensor(values),
                               torch.as_tensor(mask), num_groups)
    rhi, rlo = ref_k.group_sum_exact(jnp.asarray(codes), jnp.asarray(values),
                                     jnp.asarray(mask), num_groups)
    _eq(hi, rhi)
    _eq(lo, rlo)
    for gi in range(num_groups):
        sel = mask & (codes == gi)
        assert k.combine_hi_lo(hi[gi], lo[gi]) == sum(int(v) for v in values[sel])
    _eq(k.group_count(torch.as_tensor(codes), torch.as_tensor(mask),
                      num_groups),
        ref_k.group_count(jnp.asarray(codes), jnp.asarray(mask), num_groups))


@pytest.mark.parametrize("num_groups", GROUPS)
@pytest.mark.parametrize("want_max", [False, True], ids=["min", "max"])
def test_group_min_max(num_groups, want_max):
    codes, values, mask = _data(5000, num_groups, 11 + num_groups)
    sentinel = I64.min if want_max else I64.max
    port_fn = k.group_max if want_max else k.group_min
    ref_fn = ref_k.group_max if want_max else ref_k.group_min
    _eq(port_fn(torch.as_tensor(codes), torch.as_tensor(values),
                torch.as_tensor(mask), num_groups, sentinel),
        ref_fn(jnp.asarray(codes), jnp.asarray(values), jnp.asarray(mask),
               num_groups, jnp.int64(sentinel)))


def test_sorted_segments():
    num_groups = 500
    codes, values, mask = _data(8000, num_groups, 21)
    tc, tm = torch.as_tensor(codes), torch.as_tensor(mask)
    gid_sorted, srows = k.sort_by_group(tc, tm)
    rgid, rrows = ref_k.sort_by_group(jnp.asarray(codes), jnp.asarray(mask))
    _eq(gid_sorted, rgid)
    _eq(srows, rrows)
    start, end = k.segment_bounds(gid_sorted, num_groups)
    rstart, rend = ref_k.segment_bounds(rgid, num_groups)
    _eq(start, rstart)
    _eq(end, rend)
    v_sorted = torch.as_tensor(values)[srows]
    m_sorted = tm[srows]
    hi, lo = k.segment_sum_exact(v_sorted, m_sorted, start, end)
    rhi, rlo = ref_k.segment_sum_exact(jnp.asarray(values)[rrows],
                                       jnp.asarray(mask)[rrows], rstart, rend)
    _eq(hi, rhi)
    _eq(lo, rlo)
    _eq(k.segment_count(m_sorted, start, end),
        ref_k.segment_count(jnp.asarray(mask)[rrows], rstart, rend))
    for want_max in (False, True):
        sentinel = I64.min if want_max else I64.max
        _eq(k.segment_minmax(tc, torch.as_tensor(values), tm, num_groups,
                             sentinel, want_max),
            ref_k.segment_minmax(jnp.asarray(codes), jnp.asarray(values),
                                 jnp.asarray(mask), num_groups,
                                 jnp.int64(sentinel), want_max))


def test_mixed_radix_codes():
    rng = np.random.default_rng(31)
    sizes = [3, 7, 5]
    cols = [rng.integers(0, s, 1000).astype(np.uint8) for s in sizes]
    code, total = g.mixed_radix_codes([torch.as_tensor(c) for c in cols],
                                      sizes)
    rcode, rtotal = ref_g.mixed_radix_codes([jnp.asarray(c) for c in cols],
                                            sizes)
    assert total == rtotal == 105 and code.dtype == torch.int32
    _eq(code, rcode)


@pytest.mark.parametrize("with_nulls", [False, True], ids=["keys", "null-flags"])
def test_group_by_sort(with_nulls):
    rng = np.random.default_rng(41)
    n = 6000
    a = rng.integers(0, 40, n).astype(np.int64)
    b = rng.integers(-3, 3, n).astype(np.int64)
    mask = rng.random(n) < 0.8
    keys = [a, b]
    if with_nulls:
        # a NULL-flag key before a value key zeroed under NULL, as
        # GroupAggregate builds them
        null = rng.random(n) < 0.1
        keys = [null.astype(np.int64), np.where(null, 0, a), b]
    out = g.group_by_sort(tuple(torch.as_tensor(x) for x in keys),
                          torch.as_tensor(mask), n)
    ref = ref_g.group_by_sort(tuple(jnp.asarray(x) for x in keys),
                              jnp.asarray(mask), n)
    _eq(out.group_ids, ref.group_ids)
    _eq(out.rep_rows, ref.rep_rows)
    assert int(out.num_groups) == int(ref.num_groups)
    distinct = {tuple(int(x[i]) for x in keys) for i in np.flatnonzero(mask)}
    assert int(out.num_groups) == len(distinct)


def test_lexsort_orders_by_every_key_and_keeps_ties_in_row_order():
    rng = np.random.default_rng(51)
    a = rng.integers(0, 5, 3000)
    b = rng.integers(0, 5, 3000)
    perm = k.lexsort((torch.as_tensor(a), torch.as_tensor(b))).numpy()
    assert np.array_equal(perm, np.lexsort((np.arange(3000), b, a)))
