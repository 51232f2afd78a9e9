"""Monotone gather (kernel K2) of the torch port against the JAX Pallas kernel.

The JAX side runs `duckdb_cubit_tpu.ops.pallas_probe` in interpret mode on
the CPU, as `tests/test_pallas_probe.py` runs it; the port runs its plain
body.  Every comparison is exact (int32 row ids and counts): where the
reference reports no overflow, both outputs must be equal; on sparse keys,
where the reference may overflow, the port must give `lut[keys]` with no
overflow.  The CUDA cases hold the hand-written kernel against the plain
body on the card and skip where there is none; they need no jax, which a
card's machine may not have.
"""

import functools

import numpy as np
import pytest
import torch

from duckdb_cubit_tpu_torch.exec import profiler as PROF
from duckdb_cubit_tpu_torch.index.pk import DirectPKIndex
from duckdb_cubit_tpu_torch.ops import probe

try:
    import jax.numpy as jnp

    from duckdb_cubit_tpu.index.pk import DirectPKIndex as RefPKIndex
    from duckdb_cubit_tpu.ops import pallas_probe as PP
except ImportError:     # no jax: only the cuda cases can run
    jnp = RefPKIndex = PP = None

# keys per grid step of the Pallas kernel (`pallas_probe._BLOCK`)
BLOCK = 1 << 17


def test_block_is_the_pallas_kernels():
    assert PP._BLOCK == BLOCK


def _lut(dom, stride):
    keys = np.arange(0, dom, stride)
    lut = np.full(dom, -1, np.int32)
    lut[keys] = np.arange(len(keys), dtype=np.int32)
    return keys, lut


def _dense_case():
    rng = np.random.default_rng(0)
    keys, lut = _lut(600_000, 4)
    mult = rng.integers(1, 8, len(keys))
    probe_keys = np.sort(np.repeat(keys, mult))[: BLOCK + 777]
    return lut, probe_keys.astype(np.int32)


def _absent_case():
    _, lut = _lut(400_000, 4)
    return lut, np.arange(BLOCK, dtype=np.int32) + 1000


def _sparse_case():
    rng = np.random.default_rng(2)
    _, lut = _lut(4_000_000, 4)
    probe_keys = np.unique(np.sort(rng.integers(0, 4_000_000, BLOCK)))
    probe_keys = np.sort(np.concatenate(
        [probe_keys] * (BLOCK // len(probe_keys) + 1)))[: BLOCK]
    return lut, probe_keys.astype(np.int32)


def _port(lut, keys, device="cpu"):
    out, ovf = probe.monotone_gather(torch.as_tensor(lut, device=device),
                                     torch.as_tensor(keys, device=device))
    return out.cpu().numpy(), int(ovf)


@pytest.mark.parametrize("case", [_dense_case, _absent_case],
                         ids=["dense-variable-multiplicity", "absent-slots"])
def test_matches_pallas_where_it_does_not_overflow(case):
    lut, keys = case()
    ref_out, ref_ovf = PP.monotone_gather(jnp.asarray(lut), jnp.asarray(keys),
                                          interpret=True)
    assert int(ref_ovf) == 0
    out, ovf = _port(lut, keys)
    assert ovf == 0
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    np.testing.assert_array_equal(out, lut[keys])


def test_sparse_keys_are_exact_without_overflow():
    """The TPU kernel's window may overflow on sparse keys; the port
    gathers every sorted in-range key exactly."""
    lut, keys = _sparse_case()
    ref_out, ref_ovf = PP.monotone_gather(jnp.asarray(lut), jnp.asarray(keys),
                                          interpret=True)
    assert int(ref_ovf) > 0 or np.array_equal(np.asarray(ref_out), lut[keys])
    out, ovf = _port(lut, keys)
    assert ovf == 0
    np.testing.assert_array_equal(out, lut[keys])


def _broken_keys(n, lut_size, seed):
    """Sorted keys with one out-of-order key, one negative key and one past
    the lut's end; -> (keys, mask of the keys that break it)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, lut_size, n)).astype(np.int32)
    keys[n // 2] = keys[n // 2 - 1] - 1        # smaller than its predecessor
    keys[n // 3] = -5                          # out of range, and out of order
    keys[-1] = lut_size                        # out of range
    k = keys.astype(np.int64)
    bad = (k < 0) | (k >= lut_size)
    bad[1:] |= k[1:] < k[:-1]
    return keys, bad


@pytest.mark.parametrize("n", [40_000, 100_003])
def test_precondition_breaks_are_counted(n):
    lut_size = 90_000
    _, lut = _lut(lut_size, 3)
    keys, bad = _broken_keys(n, lut_size, seed=n)
    out, ovf = _port(lut, keys)
    assert ovf == int(bad.sum()) == 3
    np.testing.assert_array_equal(out[bad], -1)
    np.testing.assert_array_equal(out[~bad], lut[keys[~bad]])


def test_gather_via_sort_matches_pallas():
    rng = np.random.default_rng(3)
    _, lut = _lut(500_000, 2)
    keys = rng.integers(0, 500_000, BLOCK).astype(np.int32)
    ref_out, ref_ovf = PP.gather_via_sort(jnp.asarray(lut), jnp.asarray(keys),
                                          interpret=True)
    out, ovf = probe.gather_via_sort(torch.as_tensor(lut),
                                     torch.as_tensor(keys))
    assert int(ovf) == 0
    np.testing.assert_array_equal(out.numpy(), lut[keys])
    if int(ref_ovf) == 0:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))


def _value_luts(lut, count, seed):
    """`count` key-space value luts beside a row lut, as
    `DirectPKIndex.device_value_lut` builds them (0 at absent slots)."""
    rng = np.random.default_rng(seed)
    present = lut >= 0
    out = []
    for _ in range(count):
        v = rng.integers(-2**31, 2**31, lut.shape[0]).astype(np.int32)
        v[~present] = 0
        out.append(v)
    return out


def _broken_dense_case():
    """The dense case with a key below its predecessor, a negative key and
    one past the lut's end."""
    lut, keys = _dense_case()
    keys = keys.copy()
    keys[1000] = keys[999] - 1
    keys[5000] = -3
    keys[9000] = lut.shape[0]
    return lut, keys


_MANY_CASES = {"dense": _dense_case, "absent": _absent_case,
               "broken": _broken_dense_case}


@pytest.fixture(scope="module")
def pallas_outs():
    """(luts, keys, the Pallas kernel's (out, overflow) per lut) per case:
    nine luts, the row lut first, each run once through the reference."""
    cache = {}

    def get(case):
        if case not in cache:
            lut, keys = _MANY_CASES[case]()
            luts = [lut] + _value_luts(lut, 8, seed=len(keys))
            ref = [PP.monotone_gather(jnp.asarray(t), jnp.asarray(keys),
                                      interpret=True) for t in luts]
            cache[case] = luts, keys, [(np.asarray(o), int(v))
                                       for o, v in ref]
        return cache[case]
    return get


@pytest.mark.parametrize("n_luts", [1, 2, 4, 9])
@pytest.mark.parametrize("case", list(_MANY_CASES))
def test_many_luts_match_pallas_once_per_lut(pallas_outs, case, n_luts):
    """The many-lut body gives, lut by lut, what the Pallas kernel gives for
    that lut alone, and one overflow: the one-lut overflow."""
    luts, keys, ref = pallas_outs(case)
    luts, ref = luts[:n_luts], ref[:n_luts]
    outs, ovf = probe.monotone_gather_many(
        [torch.as_tensor(t) for t in luts], torch.as_tensor(keys))
    assert tuple(outs.shape) == (n_luts, len(keys))
    one_ovf = int(probe.monotone_gather(torch.as_tensor(luts[0]),
                                        torch.as_tensor(keys))[1])
    assert int(ovf) == one_ovf
    k = keys.astype(np.int64)
    bad = (k < 0) | (k >= len(luts[0]))
    bad[1:] |= k[1:] < k[:-1]
    # broken: the three keys, and the one after the key past the end
    assert one_ovf == int(bad.sum()) == (4 if case == "broken" else 0)
    for j, (ref_out, ref_ovf) in enumerate(ref):
        got = outs[j].numpy()
        if case == "broken":
            # the reference flags the block too; away from the bad keys
            # both give the lut's values
            assert ref_ovf > 0
            np.testing.assert_array_equal(got[bad], -1)
            np.testing.assert_array_equal(got[~bad], ref_out[~bad])
        else:
            assert ref_ovf == 0
            np.testing.assert_array_equal(got, ref_out)
        np.testing.assert_array_equal(
            got, probe.monotone_gather_reference(
                torch.as_tensor(luts[j]), torch.as_tensor(keys))[0].numpy())


def test_many_luts_on_a_view_and_tiny_lengths():
    """keys[1:] (a view that starts 4 B past an allocation) and lengths
    that fill no vector: the plain body is the one-lut body per lut."""
    lut, keys = _broken_dense_case()
    luts = [torch.as_tensor(t) for t in [lut] + _value_luts(lut, 2, 7)]
    tk = torch.as_tensor(keys)
    for view in (tk[1:], tk[995:996], tk[997:1000], tk[998:1003]):
        outs, ovf = probe.monotone_gather_many(luts, view)
        for j, t in enumerate(luts):
            want, want_ovf = probe.monotone_gather_reference(t, view)
            assert torch.equal(outs[j], want) and int(ovf) == int(want_ovf)


def test_many_luts_reject_luts_of_other_lengths():
    lut = torch.arange(100, dtype=torch.int32)
    keys = torch.arange(50, dtype=torch.int32)
    for luts in ([], [lut, lut[:99]], [lut, lut.to(torch.int64)]):
        with pytest.raises((TypeError, ValueError)):
            probe.monotone_gather_many(luts, keys)


def test_gather_bytes_match_a_numpy_count():
    _, keys = _dense_case()
    for n_luts in (1, 2, 4):
        want = (4 * len(keys) + 4 * len(keys) * n_luts
                + 32 * n_luts * (len(np.unique(keys)) >> 3))
        assert probe.gather_bytes(torch.as_tensor(keys), n_luts) == want


@pytest.mark.parametrize("n_keys,lut_size", [
    (100, 1000), (BLOCK // 4 - 1, 1000), (BLOCK // 4, 1000),
    (BLOCK, 0), (BLOCK, 1000), (6_001_215, 6_000_001)])
def test_plan_gates_as_the_reference(n_keys, lut_size):
    assert probe.plan_monotone_gather(n_keys, lut_size) == (
        PP.plan_monotone_gather(n_keys, lut_size) is not None)


def test_wrapper_on_cpu_runs_plain_body_and_counts_no_launch():
    lut, keys = _dense_case()
    before = PROF.read("k2_launches")
    out, ovf = _port(lut, keys)
    assert PROF.read("k2_launches") == before
    np.testing.assert_array_equal(out, lut[keys])


@pytest.mark.parametrize("bad", ["key-dtype", "lut-dtype", "2d",
                                 "noncontiguous", "empty-lut"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    lut = torch.arange(100, dtype=torch.int32)
    keys = torch.arange(50, dtype=torch.int32)
    args = {"key-dtype": (lut, keys.to(torch.int64)),
            "lut-dtype": (lut.to(torch.int64), keys),
            "2d": (lut, keys.reshape(5, 10)),
            "noncontiguous": (lut, keys[::2]),
            "empty-lut": (lut[:0], keys)}[bad]
    with pytest.raises((TypeError, ValueError)):
        probe.monotone_gather(*args)


def test_pk_index_probe_and_value_lut_match_reference():
    rng = np.random.default_rng(5)
    pk_keys = rng.permutation(np.arange(1, 40_000, 3))
    n = len(pk_keys)
    values = rng.integers(-50, 50, n).astype(np.int8)
    ref = RefPKIndex.build("k", pk_keys, n)
    port = DirectPKIndex.build("k", pk_keys, n, device="cpu")
    probe_keys = rng.integers(-10, 40_010, 50_000)
    probe_valid = rng.random(50_000) < 0.9
    build_mask = rng.random(n) < 0.7
    r_row, r_found = ref.probe(jnp.asarray(probe_keys), jnp.asarray(probe_valid),
                               jnp.asarray(build_mask))
    p_row, p_found = port.probe(torch.as_tensor(probe_keys),
                                torch.as_tensor(probe_valid),
                                torch.as_tensor(build_mask))
    np.testing.assert_array_equal(p_row.numpy(), np.asarray(r_row))
    np.testing.assert_array_equal(p_found.numpy(), np.asarray(r_found))
    vlut = port.device_value_lut("v", values)
    assert vlut.dtype == torch.int32
    # the port's slots start at the smallest key, the JAX package's at 0
    assert port.base == 1
    np.testing.assert_array_equal(
        vlut.numpy(), np.asarray(ref.device_value_lut("v", values))[1:])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "absent", "sparse", "broken"])
def test_cuda_kernel_matches_plain_body(cuda_device, case):
    if case == "broken":
        _, lut = _lut(90_000, 3)
        keys, _ = _broken_keys(100_003, 90_000, seed=1)
    else:
        lut, keys = {"dense": _dense_case, "absent": _absent_case,
                     "sparse": _sparse_case}[case]()
    tl = torch.as_tensor(lut, device=cuda_device)
    tk = torch.as_tensor(keys, device=cuda_device)
    before = PROF.read("k2_launches")
    out, ovf = probe.monotone_gather(tl, tk)
    torch.cuda.synchronize()
    assert PROF.read("k2_launches") == before + 1
    want, want_ovf = probe.monotone_gather_reference(tl, tk)
    assert torch.equal(out, want) and int(ovf) == int(want_ovf)


@pytest.mark.cuda
@pytest.mark.parametrize("n_luts", [1, 2, 4, 8, 9])
@pytest.mark.parametrize("case", ["dense", "broken", "view"])
def test_cuda_many_lut_kernel_matches_plain_body(cuda_device, case, n_luts):
    """One launch per 8 luts; every output row and the one overflow equal
    the plain body, on a view that starts 4 B past an allocation too."""
    lut, keys = (_dense_case if case == "dense" else _broken_dense_case)()
    luts = [torch.as_tensor(t, device=cuda_device)
            for t in [lut] + _value_luts(lut, n_luts - 1, 3)]
    tk = torch.as_tensor(keys, device=cuda_device)
    if case == "view":
        tk = tk[1:]
    before = PROF.read("k2_launches")
    outs, ovf = probe.monotone_gather_many(luts, tk)
    torch.cuda.synchronize()
    assert PROF.read("k2_launches") == before + (n_luts + 7) // 8
    want, want_ovf = probe.monotone_gather_many_reference(luts, tk)
    assert torch.equal(outs, want) and int(ovf) == int(want_ovf)


# The kernel at the main path's size: lineitem -> orders at SF1, a lut of
# 6,000,001 slots a quarter full (random row ids), dense sorted keys.

@functools.lru_cache(maxsize=None)
def _sf1_lut():
    """-> (row lut, 8 value luts, the dense keys: every present key 1-7
    times), read-only."""
    rng = np.random.default_rng(1)
    present = np.arange(0, 6_000_001, 4)
    lut = np.full(6_000_001, -1, np.int32)
    lut[present] = rng.permutation(len(present)).astype(np.int32)
    dense = np.repeat(present, rng.integers(1, 8, len(present)))
    return lut, _value_luts(lut, 8, seed=5), dense.astype(np.int32)


def _sf1_keys(kind):
    """The keys of one kind over `_sf1_lut`'s lut, int32."""
    dense = _sf1_lut()[2]
    rng = np.random.default_rng(2)
    if kind == "dense":
        return dense
    if kind == "absent":
        # every slot of a quarter-full lut: three keys in four hit -1
        return np.arange(1000, 4_001_000, dtype=np.int32)
    if kind == "sparse":
        return np.repeat(np.arange(0, 6_000_001, 97, dtype=np.int32), 2)
    if kind == "ragged":
        # no block size divides the length
        return np.sort(rng.integers(0, 6_000_001, 1_000_003)).astype(np.int32)
    if kind == "unordered":
        keys = np.sort(rng.integers(0, 6_000_001, 3_000_000)).astype(np.int32)
        keys[1_000_000] = keys[999_999] - 1
        keys[2_000_000] = 6_000_001
        return keys
    # "broken": a key below its predecessor where a warp's span starts
    # (lane 0 reads the predecessor from memory), at a quad boundary (it
    # comes by shuffle) and inside a quad
    keys = dense[:1_000_000].copy()
    for i in (128 * 1000, 4 * 30001, 4 * 60001 + 2):
        keys[i] = keys[i - 1] - 1
    return keys


# name -> (luts, kind of keys, the slice of the keys' device tensor probed):
# views start 4, 8 and 12 B past a 16-B boundary, lengths fill no quad, no
# warp's span and no block; keys[1:] of the broken keys moves every boundary
SF1_CASES = {
    "dense keys, multiplicity 1-7": (1, "dense", slice(None)),
    "absent slots": (1, "absent", slice(None)),
    "sparse keys (stride 97)": (1, "sparse", slice(None)),
    "out-of-order and out-of-range keys": (1, "unordered", slice(None)),
    "ragged length 1,000,003": (1, "ragged", slice(None)),
    **{f"dense keys, {m} luts": (m, "dense", slice(None))
       for m in (1, 2, 4, 8, 9)},
    **{f"keys[{off}:], 3 luts": (3, "dense", slice(off, None))
       for off in (1, 2, 3)},
    **{f"n={n}, 2 luts": (2, "dense", slice(0, n))
       for n in (1, 3, 5, 127, 129, 1_000_003)},
    **{f"n={n} from keys[1:], 2 luts": (2, "dense", slice(1, n + 1))
       for n in (1, 3, 5, 127, 129, 1_000_003)},
    "broken at a span, a quad and inside a quad": (4, "broken", slice(None)),
    "the same broken keys from keys[1:]": (4, "broken", slice(1, None)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SF1_CASES))
def test_cuda_kernel_at_the_main_paths_size(cuda_device, case):
    """Every output row and the overflow equal the plain body's, and the
    overflow counts the keys that break the precondition."""
    n_luts, kind, view = SF1_CASES[case]
    lut, values, _ = _sf1_lut()
    luts, keys = [lut, *values][:n_luts], _sf1_keys(kind)
    k = keys[view].astype(np.int64)
    bad = (k < 0) | (k >= len(luts[0]))
    bad[1:] |= k[1:] < k[:-1]
    tl = [torch.as_tensor(t, device=cuda_device) for t in luts]
    tk = torch.as_tensor(keys, device=cuda_device)[view]
    outs, ovf = probe.monotone_gather_many(tl, tk)
    want, want_ovf = probe.monotone_gather_many_reference(tl, tk)
    assert torch.equal(outs, want)
    assert int(ovf) == int(want_ovf) == int(bad.sum())
    if kind == "broken":
        assert int(ovf) == 3


@pytest.mark.cuda
def test_cuda_gather_via_sort_matches_the_cpu(cuda_device):
    """Random keys through the sort, the kernel and the scatter back."""
    lut = torch.as_tensor(_sf1_lut()[0], device=cuda_device)
    keys = torch.as_tensor(np.random.default_rng(2).integers(
        0, len(lut), 2_000_000).astype(np.int32), device=cuda_device)
    got, ovf = probe.gather_via_sort(lut, keys)
    want, want_ovf = probe.gather_via_sort(lut.cpu(), keys.cpu())
    assert torch.equal(got.cpu(), want) and int(ovf) == int(want_ovf) == 0


# ----------------------------------------------------------------------
# Key-to-row tables from the smallest key (the port's `base`).  The JAX
# package's tables start at key 0 and refuse a sparse key with a large
# base, so its plans take the sort-merge join there; rows must agree.

def _datekeys(n):
    import datetime
    d0 = datetime.date(1992, 1, 1)
    days = [d0 + datetime.timedelta(days=i) for i in range(n)]
    return np.array([x.year * 10_000 + x.month * 100 + x.day for x in days],
                    dtype=np.int64)


def test_an_offset_table_probes_keys_below_above_absent_and_null():
    keys = np.random.default_rng(9).permutation(_datekeys(2556))
    n = len(keys)
    port = DirectPKIndex.build("d", keys, n, device="cpu")
    assert RefPKIndex.build("d", keys, n) is None
    assert port.base == 19920101 and port.max_key == int(keys.max())
    assert port.span == port.max_key - port.base + 1 <= 1 << 16
    row_of = {int(k): i for i, k in enumerate(keys)}
    probe_keys = np.concatenate([
        keys[:500], [0, -7, 19920100, 19920101, port.max_key,
                     port.max_key + 1, 2**31 - 1, 19920132, 19930230],
        _datekeys(3000)[2500:]])
    valid = np.ones(len(probe_keys), dtype=bool)
    valid[::7] = False
    build_mask = np.ones(n, dtype=bool)
    build_mask[row_of[19920101]] = False
    row, found = port.probe(torch.as_tensor(probe_keys),
                            torch.as_tensor(valid),
                            torch.as_tensor(build_mask))
    want = np.array([row_of.get(int(k), -1) if v else -1
                     for k, v in zip(probe_keys, valid)])
    want[want >= 0] = np.where(build_mask[want[want >= 0]],
                               want[want >= 0], -1)
    np.testing.assert_array_equal(row.numpy(), want)
    np.testing.assert_array_equal(found.numpy(), want >= 0)


def test_a_table_of_few_slots_is_built_however_sparse_and_a_large_one_not():
    few = np.array([5, 40_000, 65_540], dtype=np.int64)
    pk = DirectPKIndex.build("k", few, 3, device="cpu")
    assert (pk.base, pk.span) == (5, 65_536)
    assert DirectPKIndex.build("k", np.array([5, 65_541]), 2,
                               device="cpu") is None
    assert DirectPKIndex.build("k", np.array([3, 9, 3]), 3,
                               device="cpu") is None


def _dml_pair():
    from duckdb_cubit_tpu.api import Connection as RefConnection
    from duckdb_cubit_tpu_torch.api import Connection
    ref, port = RefConnection(), Connection(device="cpu")
    rng = np.random.default_rng(11)
    dkeys = 1_000_000 + rng.permutation(1000)
    dim = ", ".join(f"({k}, {k % 97})" for k in dkeys.tolist())
    fk = np.concatenate([rng.choice(dkeys, 3000), [999_990, 1_002_000, 5,
                                                  999_999, 1_001_000]])
    fact = ", ".join(f"({k}, {i})" for i, k in enumerate(fk.tolist()))
    for c in (ref, port):
        c.sql("CREATE TABLE d (k INTEGER, w INTEGER)")
        c.sql(f"INSERT INTO d VALUES {dim}")
        c.sql("CREATE TABLE f (fk INTEGER, x INTEGER)")
        c.sql(f"INSERT INTO f VALUES {fact}")
    port.sql("CREATE UNIQUE INDEX ON d(k)")
    with pytest.raises(Exception, match="unsuitable"):
        ref.sql("CREATE UNIQUE INDEX ON d(k)")
    return ref, port


JOIN = ("SELECT fk, x, w FROM f, d WHERE fk = k ORDER BY x")
GROUPED = ("SELECT w, count(*) AS n, sum(x) AS s FROM f, d "
           "WHERE fk = k GROUP BY w ORDER BY w")


def test_an_offset_table_through_insert_delete_and_rollback_matches_jax():
    ref, port = _dml_pair()

    def same(expect_base):
        pk = port.catalog.table("d").pk_indexes["k"]
        assert pk.base == expect_base
        assert "single=True" in port.explain(JOIN)
        for q in (JOIN, GROUPED):
            assert port.sql(q).strings() == ref.sql(q).strings(), q

    same(1_000_000)
    for c in (ref, port):
        c.sql("INSERT INTO d VALUES (999990, 1)")      # below the base
    same(999_990)
    for c in (ref, port):
        c.sql("INSERT INTO d VALUES (1002000, 2)")     # past the top
    same(999_990)
    assert port.catalog.table("d").pk_indexes["k"].max_key == 1_002_000
    for c in (ref, port):
        c.sql("BEGIN")
        c.sql("DELETE FROM d WHERE k = 999990 OR k = 1000500")
    same(999_990)
    for c in (ref, port):
        c.sql("ROLLBACK")
    same(999_990)
    assert len(port.sql(JOIN).strings()) == 3002


def test_tpch_dense_keys_keep_base_one_and_the_kernel_route():
    from torch.profiler import ProfilerActivity, profile

    from duckdb_cubit_tpu_torch.api import Connection
    from duckdb_cubit_tpu_torch.exec import profiler as PROF
    from duckdb_cubit_tpu_torch.tpch.load import load_catalog
    from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL

    conn = Connection(load_catalog(0.01, device="cpu", cache=False),
                      device="cpu")
    for t, col in (("orders", "o_orderkey"), ("customer", "c_custkey"),
                   ("part", "p_partkey"), ("supplier", "s_suppkey")):
        pk = conn.catalog.table(t).pk_indexes[col]
        assert pk.base == 1 and pk.span == pk.max_key
    PROF.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            conn.sql(SQL[12]).strings()
        probes = [s for s in PROF.spans() if s[0] == "db.join.pk_probe"]
        roots = [s for s in PROF.spans() if s[0] == "db.sql"]
    finally:
        PROF.reset()
    assert probes and all(s[5]["route"] == "k2" for s in probes)
    assert probes[0][5]["slots"] == conn.catalog.table(
        "orders").pk_indexes["o_orderkey"].span
    assert roots[0][5]["pk_probe_rows"] > 0
    assert roots[0][5]["sort_probe_rows"] == 0
