"""Monotone gather (kernel K2) of the torch port against the JAX Pallas kernel.

The JAX side runs `duckdb_cubit_tpu.ops.pallas_probe` in interpret mode on
the CPU, as `tests/test_pallas_probe.py` runs it; the port runs its plain
body.  Every comparison is exact (int32 row ids and counts): where the
reference reports no overflow, both outputs must be equal; on sparse keys,
where the reference may overflow, the port must give `lut[keys]` with no
overflow.  The CUDA cases hold the hand-written kernel against the plain
body on the card and skip where there is none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_cubit_tpu.index.pk import DirectPKIndex as RefPKIndex
from duckdb_cubit_tpu.ops import pallas_probe as PP
from duckdb_cubit_tpu_torch.index.pk import DirectPKIndex
from duckdb_cubit_tpu_torch.ops import probe


def _lut(dom, stride):
    keys = np.arange(0, dom, stride)
    lut = np.full(dom, -1, np.int32)
    lut[keys] = np.arange(len(keys), dtype=np.int32)
    return keys, lut


def _dense_case():
    rng = np.random.default_rng(0)
    keys, lut = _lut(600_000, 4)
    mult = rng.integers(1, 8, len(keys))
    probe_keys = np.sort(np.repeat(keys, mult))[: PP._BLOCK + 777]
    return lut, probe_keys.astype(np.int32)


def _absent_case():
    _, lut = _lut(400_000, 4)
    return lut, np.arange(PP._BLOCK, dtype=np.int32) + 1000


def _sparse_case():
    rng = np.random.default_rng(2)
    _, lut = _lut(4_000_000, 4)
    probe_keys = np.unique(np.sort(rng.integers(0, 4_000_000, PP._BLOCK)))
    probe_keys = np.sort(np.concatenate(
        [probe_keys] * (PP._BLOCK // len(probe_keys) + 1)))[: PP._BLOCK]
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
    keys = rng.integers(0, 500_000, PP._BLOCK).astype(np.int32)
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
    (100, 1000), (PP._BLOCK // 4 - 1, 1000), (PP._BLOCK // 4, 1000),
    (PP._BLOCK, 0), (PP._BLOCK, 1000), (6_001_215, 6_000_001)])
def test_plan_gates_as_the_reference(n_keys, lut_size):
    assert probe.plan_monotone_gather(n_keys, lut_size) == (
        PP.plan_monotone_gather(n_keys, lut_size) is not None)


def test_wrapper_on_cpu_runs_plain_body_and_counts_no_launch():
    lut, keys = _dense_case()
    before = probe.launch_count
    out, ovf = _port(lut, keys)
    assert probe.launch_count == before
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
    np.testing.assert_array_equal(vlut.numpy(),
                                  np.asarray(ref.device_value_lut("v", values)))


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
    before = probe.launch_count
    out, ovf = probe.monotone_gather(tl, tk)
    torch.cuda.synchronize()
    assert probe.launch_count == before + 1
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
    before = probe.launch_count
    outs, ovf = probe.monotone_gather_many(luts, tk)
    torch.cuda.synchronize()
    assert probe.launch_count == before + (n_luts + 7) // 8
    want, want_ovf = probe.monotone_gather_many_reference(luts, tk)
    assert torch.equal(outs, want) and int(ovf) == int(want_ovf)
