"""Kernels K3 and K4 (Q6 sums with int32 hi/lo partials) of the torch port
against the Pallas kernels of `benchmarks/q6bench.py`.

The script loads SF1 at import, so its kernels (`q6_kernel`,
`pallas_m8_kernel`), their `pallas_call` wrappers (`pallas_q6`,
`pallas_m8`) and its `fused_mask_i32` body are taken out of its source with
`ast` and run here with the script's own BlockSpecs (BLK 8192, grid 9) in
Pallas interpret mode on the CPU.  The port's plain bodies must equal them
bit for bit: the (2,) int32 [hi, lo] pair, wraps included (tolerance 0).
The CUDA cases hold the hand-written kernels against the plain bodies on
the card and skip where there is none.
"""

import ast
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import duckdb_cubit_tpu  # noqa: F401  (the reference's jax settings)
from duckdb_cubit_tpu_torch.benchmarks import q6bench
from duckdb_cubit_tpu_torch.ops import bitmap as bm
from duckdb_cubit_tpu_torch.ops import q6_variants as qv

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "q6bench.py")
BLK = 8192
N = BLK * 9


@functools.lru_cache(maxsize=None)
def _script_functions(names: tuple) -> dict:
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    nodes = [node for node in tree.body
             if isinstance(node, ast.FunctionDef) and node.name in names]
    assert sorted(n.name for n in nodes) == sorted(names)
    interpret = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id, when=pl.when)
    namespace = {"jax": jax, "jnp": jnp, "pl": interpret, "pltpu": pltpu,
                 "n": N, "BLK": BLK}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), SCRIPT, "exec"),
         namespace)
    return namespace


def _pallas_words(words_u32, a, b):
    fn = _script_functions(("q6_kernel", "pallas_q6"))["pallas_q6"]
    return np.asarray(fn(jnp.asarray(words_u32), jnp.asarray(a),
                         jnp.asarray(b))).reshape(2)


def _pallas_mask8(mask, a, b):
    fn = _script_functions(("pallas_m8_kernel", "pallas_m8"))["pallas_m8"]
    return np.asarray(fn(jnp.asarray(mask), jnp.asarray(a),
                         jnp.asarray(b))).reshape(2)


def _case(name):
    """-> (uint32 words, int32 a, int32 b), made from a seed."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    if name == "all-ones, low half wraps":
        # prod & 0xFFFF near 65535 on every row: ~4.6e9 > 2**32
        return (np.full(N // 32, 2**32 - 1, np.uint32),
                rng.integers(60_000, 65_536, N).astype(np.int32),
                np.ones(N, np.int32))
    words = rng.integers(0, 2**32, N // 32, dtype=np.uint32)
    if name == "random words, Q6 payloads":
        return (words, rng.integers(0, 10_500_000, N).astype(np.int32),
                rng.integers(0, 11, N).astype(np.int32))
    # negative products that wrap int32
    return (words, rng.integers(-2**31, 2**31, N).astype(np.int32),
            rng.integers(-2**31, 2**31, N).astype(np.int32))


CASES = ["random words, Q6 payloads", "all-ones, low half wraps",
         "negative, wrapping products"]


def _mask_of(words_u32):
    return ((words_u32[:, None] >> np.arange(32, dtype=np.uint32)) & 1) \
        .astype(np.int8).reshape(-1)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", CASES)
def test_words_plain_body_equals_pallas_kernel(case):
    words, a, b = _case(case)
    want = _pallas_words(words, a, b)
    got = qv.q6_words_i32(_t(words.view(np.int32)), _t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


@pytest.mark.parametrize("case", CASES)
def test_mask8_plain_body_equals_pallas_kernel(case):
    words, a, b = _case(case)
    mask = _mask_of(words)
    want = _pallas_mask8(mask, a, b)
    got = qv.q6_mask8_i32(_t(mask), _t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask8_takes_every_byte_value():
    """The TPU kernel multiplies whatever byte it is given, not only 0/1."""
    rng = np.random.default_rng(7)
    mask = rng.integers(-128, 128, N).astype(np.int8)
    a = rng.integers(-2**31, 2**31, N).astype(np.int32)
    b = rng.integers(-2**31, 2**31, N).astype(np.int32)
    want = _pallas_mask8(mask, a, b)
    got = qv.q6_mask8_i32(_t(mask), _t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_low_half_wraps_and_combine_differs_by_multiples_of_2_32():
    words, a, b = _case("all-ones, low half wraps")
    exact = int((a.astype(np.int64) * b).sum())
    combined = int(qv.combine(qv.q6_words_i32(
        _t(words.view(np.int32)), _t(a), _t(b))))
    assert exact > 2**32 and combined != exact
    assert (combined - exact) % 2**32 == 0


@pytest.mark.parametrize("case", CASES)
def test_plain_bodies_equal_the_scripts_fused_mask_i32(case):
    """The script's XLA body over the same bits, as its driver combines it
    (hi * 65536 + lo); the port's q6bench form of it, too."""
    words, a, b = _case(case)
    mask = _mask_of(words)
    ns = _script_functions(("fused_mask_i32",))
    ns.update(ep32=jnp.asarray(a), di32=jnp.asarray(b))
    want = int(ns["fused_mask_i32"](jnp.asarray(mask[None, :])))
    tw, tm = _t(words.view(np.int32)), _t(mask)
    assert int(qv.combine(qv.q6_words_i32(tw, _t(a), _t(b)))) == want
    assert int(qv.combine(qv.q6_mask8_i32(tm, _t(a), _t(b)))) == want
    form = q6bench.forms(tw[None, :], tm[None, :], _t(a), _t(b))
    assert int(form["fused_mask_i32"](0)) == want


def test_wrappers_on_cpu_run_plain_bodies_and_count_no_launch():
    words, a, b = _case("random words, Q6 payloads")
    before = (qv.words_launch_count, qv.mask8_launch_count)
    tw = _t(words.view(np.int32))
    qv.q6_words_i32(tw, _t(a), _t(b))
    qv.q6_mask8_i32(bm.expand(tw, N).to(torch.int8), _t(a), _t(b))
    assert (qv.words_launch_count, qv.mask8_launch_count) == before


@pytest.mark.parametrize("bad", ["words-dtype", "payload-dtype", "length",
                                 "noncontiguous", "mask-dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    words = torch.zeros(4, dtype=torch.int32)
    a = torch.zeros(128, dtype=torch.int32)
    mask = torch.zeros(128, dtype=torch.int8)
    with pytest.raises((TypeError, ValueError)):
        if bad == "words-dtype":
            qv.q6_words_i32(words.to(torch.int64), a, a)
        elif bad == "payload-dtype":
            qv.q6_words_i32(words, a.to(torch.int64), a)
        elif bad == "length":
            qv.q6_words_i32(words, a[:100], a[:100])
        elif bad == "noncontiguous":
            qv.q6_mask8_i32(mask[::2], a[::2], a[::2])
        else:
            qv.q6_mask8_i32(mask.to(torch.int32), a, a)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernels_match_plain_bodies(cuda_device, case):
    words, a, b = _case(case)
    tw = _t(words.view(np.int32)).to(cuda_device)
    ta, tb = _t(a).to(cuda_device), _t(b).to(cuda_device)
    tm = bm.expand(tw, N).to(torch.int8)
    before = (qv.words_launch_count, qv.mask8_launch_count)
    got3, got4 = qv.q6_words_i32(tw, ta, tb), qv.q6_mask8_i32(tm, ta, tb)
    torch.cuda.synchronize()
    assert (qv.words_launch_count, qv.mask8_launch_count) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got3, qv.q6_words_i32_reference(tw, ta, tb))
    assert torch.equal(got4, qv.q6_mask8_i32_reference(tm, ta, tb))
