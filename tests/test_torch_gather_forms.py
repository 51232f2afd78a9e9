"""Kernels K5a and K5b (gathers from a small table) of the torch port against
the four Pallas bodies of `benchmarks/pallas_gather_probe.py`.

The script's `main()` is taken out of its source with `ast` (importing the
script would switch jax to 64-bit mode for the whole process) and run with
N = 2**17, T = 2**13 and BLK = 2**14, with `try_kernel` replaced by one that
calls `pl.pallas_call` with the same arguments in interpret mode on the CPU
and keeps each output.  So `kA`, `kA2`, `kB` and `kC` run with the script's
own inputs (numpy `default_rng(0)`) and BlockSpecs.  The port's plain bodies
must equal them exactly (int32, tolerance 0), with no index counted bad.
The CUDA cases hold the hand-written kernels against the plain bodies on
the card and skip where there is none; they need no jax, which a card's
machine may not have.
"""

import ast
import functools
import os
import time

import numpy as np
import pytest
import torch

from duckdb_cubit_tpu_torch.benchmarks import gather_probe
from duckdb_cubit_tpu_torch.exec import profiler as PROF
from duckdb_cubit_tpu_torch.ops import gather_forms as gf

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
except ImportError:     # no jax: only the cuda cases can run
    jax = jnp = pl = None

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "pallas_gather_probe.py")
N, T, BLK = 1 << 17, 1 << 13, 1 << 14


@functools.lru_cache(maxsize=None)
def _script_run() -> dict:
    """name -> (output, input arrays) of each Pallas form of main()."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    results = {}

    def try_kernel(name, kernel, out_shape, grid, in_specs, out_specs, args,
                   rows_per_call):
        f = pl.pallas_call(kernel, out_shape=out_shape, grid=grid,
                           in_specs=in_specs, out_specs=out_specs,
                           interpret=True)
        results[name] = (np.array(f(*args)),
                         tuple(np.array(a) for a in args))

    namespace = {"jax": jax, "jnp": jnp, "np": np, "pl": pl, "time": time,
                 "N": N, "T": T, "BLK": BLK, "try_kernel": try_kernel,
                 "_log": lambda m: None}
    exec(compile(ast.Module(body=[main], type_ignores=[]), SCRIPT, "exec"),
         namespace)
    namespace["main"]()
    return results


FORMS = {"A_take_1d_vmem": "kA", "A2_take_2d_vmem": "kA2",
         "C_onehot_where_sum": "kC"}


@pytest.mark.parametrize("form", sorted(FORMS), ids=FORMS.get)
def test_table_gather_plain_body_equals_pallas_form(form):
    want, (idx, tab) = _script_run()[form]
    out, bad = gf.table_gather(torch.as_tensor(tab), torch.as_tensor(idx))
    assert int(bad) == 0 and out.shape == want.shape
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(out.numpy().reshape(-1),
                                  tab.reshape(-1)[idx.reshape(-1)])


def test_lane_gather_plain_body_equals_pallas_kB():
    want, (li2, tab2) = _script_run()["B_take_along_lanes"]
    out, bad = gf.lane_gather(torch.as_tensor(tab2), torch.as_tensor(li2))
    assert int(bad) == 0
    np.testing.assert_array_equal(out.numpy(), want)
    rows = np.arange(li2.shape[0]) % tab2.shape[0]
    np.testing.assert_array_equal(want, tab2[rows[:, None], li2])


def test_driver_inputs_are_the_scripts():
    """gather_probe.inputs draws what the script's main() draws."""
    idx, table, li2 = gather_probe.inputs(N, T, "cpu")
    _, (s_idx, s_tab) = _script_run()["A_take_1d_vmem"]
    _, (s_li2, _) = _script_run()["B_take_along_lanes"]
    np.testing.assert_array_equal(idx.numpy(), s_idx)
    np.testing.assert_array_equal(table.numpy(), s_tab)
    np.testing.assert_array_equal(li2.numpy(), s_li2)


@pytest.mark.parametrize("fn", ["table", "lane"])
def test_bad_indices_are_counted_never_read(fn):
    rng = np.random.default_rng(3)
    tab2 = torch.as_tensor(rng.integers(0, 1 << 30, (64, 128))
                           .astype(np.int32))
    if fn == "table":
        idx = rng.integers(0, 8192, 1000).astype(np.int32)
        idx[[0, 7, 999]] = (-1, 8192, 2**31 - 1)
        out, bad = gf.table_gather(tab2, torch.as_tensor(idx))
        ok = (idx >= 0) & (idx < 8192)
        want = tab2.numpy().reshape(-1)[np.where(ok, idx, 0)]
    else:
        idx = rng.integers(0, 128, (100, 128)).astype(np.int32)
        idx[[0, 50, 99], [0, 1, 127]] = (-5, 128, 200)
        out, bad = gf.lane_gather(tab2, torch.as_tensor(idx))
        ok = (idx >= 0) & (idx < 128)
        rows = np.arange(100)[:, None] % 64
        want = tab2.numpy()[rows, np.where(ok, idx, 0)]
    assert int(bad) == 3
    np.testing.assert_array_equal(out.numpy(), np.where(ok, want, 0))


@pytest.mark.parametrize("bad", ["table-too-big", "empty-table", "dtype",
                                 "lane-width", "noncontiguous"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    tab = torch.zeros(gf.MAX_TABLE + 1, dtype=torch.int32)
    idx = torch.zeros(256, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        if bad == "table-too-big":
            gf.table_gather(tab, idx)
        elif bad == "empty-table":
            gf.table_gather(tab[:0], idx)
        elif bad == "dtype":
            gf.table_gather(tab[:128], idx.to(torch.int64))
        elif bad == "lane-width":
            gf.lane_gather(tab[:128].reshape(2, 64), idx.reshape(4, 64))
        else:
            gf.lane_gather(tab[:256].reshape(2, 128),
                           idx.reshape(2, 128).t())


def test_wrappers_on_cpu_run_plain_bodies_and_count_no_launch():
    idx, table, li2 = gather_probe.inputs(1 << 12, T, "cpu")
    before = _launches()
    gf.table_gather(table, idx)
    gf.lane_gather(table.reshape(-1, 128), li2)
    assert _launches() == before


def _launches():
    """-> (K5a launches, K5b launches) since import."""
    return PROF.read("k5a_launches"), PROF.read("k5b_launches")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [T, 37, gf.MAX_TABLE])
def test_cuda_kernels_match_plain_bodies(cuda_device, t):
    idx, table, li2 = gather_probe.inputs(N + 128 * 3, t, cuda_device)
    before = _launches()
    got_a = gf.table_gather(table, idx)
    tab2 = table[: t // 128 * 128].reshape(-1, 128) if t >= 128 else \
        table.repeat(128)[:128].reshape(1, 128)
    got_b = gf.lane_gather(tab2, li2)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1)
    for got, want in ((got_a, gf.table_gather_reference(table, idx)),
                      (got_b, gf.lane_gather_reference(tab2, li2))):
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


# The Hopper design's paths, on the plain bodies here (tolerance 0 against
# numpy) and on the kernels where there is a card: the scratch that `bad`
# is counted in is left zero by every launch, views off a 16-B boundary
# take a scalar head, lengths that are no multiple of 4 a scalar tail, and
# K5b's rows need not divide the row count.

def _numpy_table_gather(tab, idx):
    flat = tab.reshape(-1)
    ok = (idx >= 0) & (idx < flat.size)
    return np.where(ok, flat[np.where(ok, idx, 0)], 0), int((~ok).sum())


def _numpy_lane_gather(tab2, li):
    ok = (li >= 0) & (li < gf.LANES)
    rows = np.arange(li.shape[0])[:, None] % tab2.shape[0]
    return np.where(ok, tab2[rows, np.where(ok, li, 0)], 0), int((~ok).sum())


@pytest.mark.parametrize("fn", ["table", "lane"])
def test_bad_count_is_right_on_repeated_calls(fn):
    rng = np.random.default_rng(5)
    tab2 = rng.integers(-2**31, 2**31, (64, 128)).astype(np.int32)
    if fn == "table":
        idx = rng.integers(0, 8192, 4099).astype(np.int32)
        idx[[1, 2, 3, 4]] = (8192, -1, 1 << 30, -2**31)
        call, oracle = gf.table_gather, _numpy_table_gather
    else:
        idx = rng.integers(0, 128, (33, 128)).astype(np.int32)
        idx[5, 4:8] = (128, -1, 1 << 30, -2**31)
        call, oracle = gf.lane_gather, _numpy_lane_gather
    clean = np.where((idx >= 0) & (idx < (8192 if fn == "table" else 128)),
                     idx, 0)
    for case in (idx, idx, clean, idx):
        out, bad = call(torch.as_tensor(tab2), torch.as_tensor(case))
        want, want_bad = oracle(tab2, case)
        assert int(bad) == want_bad
        np.testing.assert_array_equal(out.numpy(), want)
    assert oracle(tab2, idx)[1] == 4


@pytest.mark.parametrize("n", [1, 3, 5, 127, 129, 1001])
@pytest.mark.parametrize("off", [1, 2, 3])
def test_table_gather_views_off_a_16b_boundary(off, n):
    rng = np.random.default_rng(off * 1000 + n)
    tab = rng.integers(-2**31, 2**31, 8192).astype(np.int32)
    base = torch.as_tensor(rng.integers(0, 8192, n + 3).astype(np.int32))
    view = base[off:off + n]
    assert view.data_ptr() % 16 == 4 * off % 16
    out, bad = gf.table_gather(torch.as_tensor(tab), view)
    want, want_bad = _numpy_table_gather(tab, view.numpy())
    assert int(bad) == want_bad == 0
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_out_like_starts_where_the_indices_do(off):
    """The kernels' int4 stores line up with their int4 index loads: the
    wrapper's output starts at the indices' offset from a 16-B boundary."""
    base = torch.arange(1003, dtype=torch.int32)
    view = base[off:off + 999]
    out = gf.out_like(view)
    assert out.shape == view.shape and out.dtype == view.dtype
    assert out.is_contiguous()
    assert out.data_ptr() % 16 == view.data_ptr() % 16


@pytest.mark.parametrize("r", [1, 999, 1001])
@pytest.mark.parametrize("rows", [3, 7])
def test_lane_gather_rows_that_do_not_divide_the_row_count(rows, r):
    rng = np.random.default_rng(rows * 10_000 + r)
    tab2 = rng.integers(-2**31, 2**31, (rows, 128)).astype(np.int32)
    li = rng.integers(0, 128, (r, 128)).astype(np.int32)
    out, bad = gf.lane_gather(torch.as_tensor(tab2), torch.as_tensor(li))
    want, want_bad = _numpy_lane_gather(tab2, li)
    assert int(bad) == want_bad == 0
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 5, 127, 129, 1_000_003])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_cuda_table_gather_views_and_lengths(cuda_device, off, n):
    rng = np.random.default_rng(off * 1000 + n)
    tab = torch.as_tensor(rng.integers(-2**31, 2**31, 8192).astype(np.int32),
                          device=cuda_device)
    idx = rng.integers(0, 8192, n + 3).astype(np.int32)
    idx[off] = -1
    view = torch.as_tensor(idx, device=cuda_device)[off:off + n]
    for _ in range(2):
        out, bad = gf.table_gather(tab, view)
        want, want_bad = gf.table_gather_reference(tab, view)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and int(bad) == int(want_bad) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 999, 1001])
@pytest.mark.parametrize("rows", [1, 3, 7, 64])
def test_cuda_lane_gather_row_shapes(cuda_device, rows, r):
    rng = np.random.default_rng(rows * 10_000 + r)
    tab2 = torch.as_tensor(rng.integers(-2**31, 2**31, (rows, 128))
                           .astype(np.int32), device=cuda_device)
    li = rng.integers(0, 128, (r, 128)).astype(np.int32)
    li[r // 2, :4] = (128, -1, 1 << 30, -2**31)
    li = torch.as_tensor(li, device=cuda_device)
    for _ in range(2):
        out, bad = gf.lane_gather(tab2, li)
        want, want_bad = gf.lane_gather_reference(tab2, li)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and int(bad) == int(want_bad) == 4


def _twice_on_card(fn, tab, idx, bad):
    """`fn` twice (the second call finds the scratch the first left)
    against its plain body: equal outputs, and `bad` indices counted."""
    plain = {gf.table_gather: gf.table_gather_reference,
             gf.lane_gather: gf.lane_gather_reference}[fn]
    want, want_bad = plain(tab, idx)
    for _ in range(2):
        out, got_bad = fn(tab, idx)
        assert torch.equal(out, want)
        assert int(got_bad) == int(want_bad) == bad


def _table_gather_case(case, device):
    """-> (table, indices, bad indices) of a K5a case, made on `device`."""
    rng = np.random.default_rng(TABLE_CASES.index(case))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    if case.startswith("T="):
        t, n = {"T=8192": (8192, 1_000_003), "T=37": (37, 70_001),
                "T=MAX_TABLE": (gf.MAX_TABLE, 1 << 22),
                "T=1": (1, 4099)}[case.split(",")[0]]
        idx = rng.integers(0, t, n).astype(np.int32)
        idx[:2] = (0, t - 1)
        idx[-2:] = (t - 1, 0)
        return dev(rng.integers(-2**31, 2**31, t).astype(np.int32)), \
            dev(idx), 0
    tab2 = dev(rng.integers(-2**31, 2**31, (64, 128)).astype(np.int32))
    if case == "(64, 128) table, (2**15, 128) indices":
        return tab2, dev(rng.integers(0, 8192, (1 << 15, 128))
                         .astype(np.int32)), 0
    if case == "three indices out of range":
        idx = rng.integers(0, 8192, 100_000).astype(np.int32)
        idx[[5, 500, 99_999]] = (-1, 8192, -2**31)
        return tab2, dev(idx), 3
    if case == "MAX_TABLE entries from tab[1:], off a 16-B boundary":
        big = dev(rng.integers(-2**31, 2**31, gf.MAX_TABLE + 1)
                  .astype(np.int32))
        return big[1:], dev(rng.integers(0, gf.MAX_TABLE, 333_333)
                            .astype(np.int32)), 0
    # a bad index at each position of a 16-B load, from idx[1:] too
    idx = rng.integers(0, 8192, 1_000_003).astype(np.int32)
    idx[[4000, 4101, 4202, 4303]] = (8192, -1, 9000, -2**31)
    idx = dev(idx)
    return tab2, idx[1:] if case.endswith("idx[1:]") else idx, 4


TABLE_CASES = ["T=8192, 1-D", "T=37, 1-D", "T=MAX_TABLE, 1-D", "T=1, 1-D",
               "(64, 128) table, (2**15, 128) indices",
               "three indices out of range",
               "MAX_TABLE entries from tab[1:], off a 16-B boundary",
               "a bad index at each position of an int4",
               "a bad index at each position of an int4, from idx[1:]"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TABLE_CASES)
def test_cuda_table_gather_cases(cuda_device, case):
    _twice_on_card(gf.table_gather, *_table_gather_case(case, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,r", [(64, 1 << 15), (3, 1 << 12), (7, 8453),
                                    (64, 4224 * 2 + 77), (100, 1001)])
def test_cuda_lane_gather_more_row_shapes(cuda_device, rows, r):
    """Rows that do and do not divide the grid's warp count, R a multiple
    of none; 100 rows (51 KB) take the plain kernel."""
    rng = np.random.default_rng(rows * 100_000 + r)
    tab2 = torch.as_tensor(rng.integers(-2**31, 2**31, (rows, 128))
                           .astype(np.int32), device=cuda_device)
    li = torch.as_tensor(rng.integers(0, 128, (r, 128)).astype(np.int32),
                         device=cuda_device)
    _twice_on_card(gf.lane_gather, tab2, li, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["three out of range",
                                  "one at each position of an int4",
                                  "lane_idx and tab 4 B off a boundary"])
def test_cuda_lane_gather_bad_lanes_and_views(cuda_device, case):
    rng = np.random.default_rng(4)
    if case.endswith("off a boundary"):
        flat = torch.as_tensor(rng.integers(0, 128, 1001 * 128 + 1)
                               .astype(np.int32), device=cuda_device)
        tflat = torch.as_tensor(rng.integers(-2**31, 2**31, 3 * 128 + 1)
                                .astype(np.int32), device=cuda_device)
        _twice_on_card(gf.lane_gather, tflat[1:].view(3, 128),
                       flat[1:].view(1001, 128), 0)
        return
    tab2 = torch.as_tensor(rng.integers(-2**31, 2**31, (64, 128))
                           .astype(np.int32), device=cuda_device)
    li = rng.integers(0, 128, (999, 128)).astype(np.int32)
    li[[0, 10, 998], [0, 127, 64]] = (128, -1, 1000)
    bad = 3
    if case.startswith("one at each"):
        li[500, 40:44] = (128, -1, 1 << 30, -2**31)
        bad = 7
    _twice_on_card(gf.lane_gather, tab2,
                   torch.as_tensor(li, device=cuda_device), bad)
