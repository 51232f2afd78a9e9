"""Kernels K3 and K4 (Q6 sums with int32 hi/lo partials) of the torch port
against the Pallas kernels of `benchmarks/q6bench.py`.

The script loads SF1 at import, so its kernels (`q6_kernel`,
`pallas_m8_kernel`), their `pallas_call` wrappers (`pallas_q6`,
`pallas_m8`) and its `fused_mask_i32` body are taken out of its source with
`ast` and run here with the script's own BlockSpecs (BLK 8192, grid 9) in
Pallas interpret mode on the CPU.  The port's plain bodies must equal them
bit for bit: the (2,) int32 [hi, lo] pair, wraps included (tolerance 0).
The Pallas kernels take only multiples of their block, so the cases of the
kernels' Hopper design (ragged lengths, zero 4-row groups, every mask byte
at every position of a 16-B load, views) hold the plain bodies against a
numpy oracle instead, and the wrappers' refusal of views off a 16-B
boundary is checked here.  The CUDA cases hold the hand-written kernels
against the plain bodies on the card and skip where there is none; they
need no jax, which a card's machine may not have.
"""

import ast
import functools
import os
import types

import numpy as np
import pytest
import torch

from duckdb_cubit_tpu_torch.benchmarks import q6bench
from duckdb_cubit_tpu_torch.exec import profiler as PROF
from duckdb_cubit_tpu_torch.ops import bitmap as bm
from duckdb_cubit_tpu_torch.ops import q6_variants as qv

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    import duckdb_cubit_tpu  # noqa: F401  (the reference's jax settings)
except ImportError:     # no jax: only the cuda cases can run
    jax = jnp = pl = pltpu = None

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


def _t(a, device="cpu"):
    """A copy in torch's own memory, which starts on a 16-B boundary."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _launches():
    """-> (K3 launches, K4 launches) since import."""
    return PROF.read("k3_launches"), PROF.read("k4_launches")


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
    before = _launches()
    tw = _t(words.view(np.int32))
    qv.q6_words_i32(tw, _t(a), _t(b))
    qv.q6_mask8_i32(bm.expand(tw, N).to(torch.int8), _t(a), _t(b))
    assert _launches() == before


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


def _oracle(m, a, b):
    """numpy: prod = int32(a * m * b) (uint64 products modulo 2**32), then
    [sum(prod >> 16), sum(prod & 0xFFFF)], each modulo 2**32."""
    p = a.astype(np.uint64) * m.astype(np.uint64) * b.astype(np.uint64)
    prod = (p & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(np.int64)
    return np.array([(int(x) + 2**31) % 2**32 - 2**31
                     for x in ((prod >> 16).sum(), (prod & 0xFFFF).sum())],
                    np.int32)


def _zero_group_words(rng, k):
    """k random words with each 4-bit group (4 rows) zeroed at random."""
    words = rng.integers(0, 2**32, k, dtype=np.uint64)
    keep = (rng.random((k, 8)) < 0.5).astype(np.uint64)
    nibbles = np.uint64(0xF) << (np.uint64(4) * np.arange(8, dtype=np.uint64))
    return (words & (keep * nibbles).sum(1, dtype=np.uint64)).astype(np.uint32)


# the paths of the kernels' Hopper design: 32 k rows with k a multiple of
# neither 4, 16 nor 32 (K3's ragged steps and tiles, K4's scalar tail past
# its 512-row steps), all-zero selectors, every mask byte at every position
# of K4's 16-B loads
NEW_CASES = [f"n=32*{k}, zero 4-row groups" for k in (1, 3, 6, 18, 37, 1001)] \
    + ["all-zero words and mask", "every byte at every position of a 16-B load"]


def _new_case(name):
    """-> (uint32 words, int8 mask, int32 a, int32 b), made from a seed; the
    mask is a signed byte where the words' bit is set, 0 elsewhere, except
    in the last case."""
    rng = np.random.default_rng(100 + NEW_CASES.index(name))
    if name.startswith("n=32*"):
        words = _zero_group_words(rng, int(name[5:].split(",")[0]))
    elif name.startswith("all-zero"):
        words = np.zeros(1024, np.uint32)
    else:
        words = rng.integers(0, 2**32, 2048, dtype=np.uint32)
    n = 32 * len(words)
    a = rng.integers(-2**31, 2**31, n).astype(np.int32)
    b = rng.integers(-2**31, 2**31, n).astype(np.int32)
    if name.startswith("every byte"):
        # byte j of 16-B load s is (s + 37 j) mod 256
        s, j = np.arange(n // 16)[:, None], np.arange(16)[None, :]
        mask = ((s + 37 * j) % 256).astype(np.uint8).view(np.int8)
        return words, mask.reshape(-1), a, b
    vals = rng.integers(-128, 128, n)
    vals[vals == 0] = 1
    return words, np.where(_mask_of(words) != 0, vals, 0).astype(np.int8), a, b


@pytest.mark.parametrize("case", NEW_CASES)
def test_plain_bodies_equal_numpy_on_the_kernels_new_paths(case):
    words, mask, a, b = _new_case(case)
    got3 = qv.q6_words_i32(_t(words.view(np.int32)), _t(a), _t(b))
    np.testing.assert_array_equal(got3.numpy(), _oracle(_mask_of(words), a, b))
    got4 = qv.q6_mask8_i32(_t(mask), _t(a), _t(b))
    np.testing.assert_array_equal(got4.numpy(), _oracle(mask, a, b))


def _views(case, device="cpu"):
    """(K3 or K4, selector view, a view, b view) over one stack made on
    `device`."""
    words, _, a, b = _new_case("n=32*1001, zero 4-row groups")
    n = len(a)
    tw = _t(np.stack([words, words[::-1]]).view(np.int32), device)
    tm = _t(np.random.default_rng(9).integers(-128, 128, (2, n))
            .astype(np.int8), device)
    ta, tb = _t(a, device), _t(b, device)
    # a word holds 128 B of each payload: words[k:] keeps a[32 k:] aligned
    return {"words[1:], a[32:], b[32:]": ("K3", tw[0, 1:], ta[32:], tb[32:]),
            "words[3:], a[96:], b[96:]": ("K3", tw[0, 3:], ta[96:], tb[96:]),
            "mask[16:], a[16:], b[16:]": ("K4", tm[0, 16:], ta[16:], tb[16:]),
            "mask[48:], a[48:], b[48:]": ("K4", tm[0, 48:], ta[48:], tb[48:]),
            "row 1 of a words stack": ("K3", tw[1], ta, tb),
            "row 1 of a mask stack": ("K4", tm[1], ta, tb),
            # off a 16-B boundary: refused
            "a[1:33]": ("K3", tw[0, :1], ta[1:33], tb[:32]),
            "b[2:34]": ("K3", tw[0, :1], ta[:32], tb[2:34]),
            "mask[4:], a[4:], b[4:]": ("K4", tm[0, 4:], ta[4:], tb[4:]),
            "a[3:]": ("K4", tm[0, :n - 3], ta[3:], tb[:n - 3])}[case]


TAKEN = ["words[1:], a[32:], b[32:]", "words[3:], a[96:], b[96:]",
         "mask[16:], a[16:], b[16:]", "mask[48:], a[48:], b[48:]",
         "row 1 of a words stack", "row 1 of a mask stack"]
REFUSED = ["a[1:33]", "b[2:34]", "mask[4:], a[4:], b[4:]", "a[3:]"]


def _oracle_of(kind, sel, a, b):
    m = _mask_of(sel.numpy().view(np.uint32)) if kind == "K3" else sel.numpy()
    return _oracle(m, a.numpy(), b.numpy())


@pytest.mark.parametrize("view", TAKEN)
def test_wrappers_take_views_on_a_16B_boundary(view):
    kind, sel, a, b = _views(view)
    fn = qv.q6_words_i32 if kind == "K3" else qv.q6_mask8_i32
    np.testing.assert_array_equal(fn(sel, a, b).numpy(),
                                  _oracle_of(kind, sel, a, b))


@pytest.mark.parametrize("view", REFUSED)
def test_wrappers_refuse_views_off_a_16B_boundary(view):
    """The kernels load 16 B at a time; the wrapper refuses before any
    launch, on the CPU as on the card."""
    kind, sel, a, b = _views(view)
    fn = qv.q6_words_i32 if kind == "K3" else qv.q6_mask8_i32
    with pytest.raises(ValueError, match="16-B boundary"):
        fn(sel, a, b)


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
    before = _launches()
    got3, got4 = qv.q6_words_i32(tw, ta, tb), qv.q6_mask8_i32(tm, ta, tb)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1)
    assert torch.equal(got3, qv.q6_words_i32_reference(tw, ta, tb))
    assert torch.equal(got4, qv.q6_mask8_i32_reference(tm, ta, tb))


@pytest.mark.cuda
@pytest.mark.parametrize("case", NEW_CASES)
def test_cuda_kernels_match_plain_bodies_on_new_paths(cuda_device, case):
    words, mask, a, b = _new_case(case)
    _on_card(words, mask, a, b, cuda_device)


def _on_card(words, mask, a, b, device):
    """K3 on the words, K4 on the signed mask and on the words' 0/1 mask,
    each twice (each launch must leave the kernels' scratch zero), against
    the plain bodies."""
    tw = _t(words.view(np.int32), device)
    ta, tb = _t(a, device), _t(b, device)
    masks = [_t(mask, device), bm.expand(tw, len(a)).to(torch.int8)]
    for _ in range(2):
        assert torch.equal(qv.q6_words_i32(tw, ta, tb),
                           qv.q6_words_i32_reference(tw, ta, tb))
        for tm in masks:
            assert torch.equal(qv.q6_mask8_i32(tm, ta, tb),
                               qv.q6_mask8_i32_reference(tm, ta, tb))


# the same paths at the main path's lengths: 2**20 rows, and 32 * 100,003
# (K3's steps and tiles and K4's scalar tail ragged at that length)
LONG_CASES = ["random words, 2**20 rows", "all-zero words and mask, 2**20 rows",
              "every byte at every position of a 16-B load, 2**20 rows",
              "n=32*100003, zero 4-row groups", "random bytes, 2**20 rows",
              "all-ones words, Q6 payloads, 2**20 rows",
              "all-ones words, low half wraps, 2**20 rows",
              "random words, Q6 payloads, n=32*733*3"]


def _long_case(name):
    """-> (uint32 words, int8 mask, int32 a, int32 b), made from a seed."""
    rng = np.random.default_rng(200 + LONG_CASES.index(name))
    n = 32 * 100_003 if name.startswith("n=") else \
        32 * 733 * 3 if name.endswith("733*3") else 1 << 20
    words = rng.integers(0, 2**32, n // 32, dtype=np.uint32)
    a = rng.integers(-2**31, 2**31, n).astype(np.int32)
    b = rng.integers(-2**31, 2**31, n).astype(np.int32)
    mask = rng.integers(-128, 128, n).astype(np.int8)
    if name.startswith("n="):
        words = _zero_group_words(rng, n // 32)
        vals = rng.integers(-128, 128, n)
        vals[vals == 0] = 1
        mask = np.where(_mask_of(words) != 0, vals, 0).astype(np.int8)
    elif name.startswith("all-zero"):
        words, mask = np.zeros_like(words), np.zeros_like(mask)
    elif name.startswith("every byte"):
        s, j = np.arange(n // 16)[:, None], np.arange(16)[None, :]
        mask = ((s + 37 * j) % 256).astype(np.uint8).view(np.int8) \
            .reshape(-1)
    elif name.startswith("all-ones"):
        words = np.full(n // 32, 2**32 - 1, np.uint32)
    if "Q6 payloads" in name:
        a = rng.integers(0, 10_500_000, n).astype(np.int32)
        b = rng.integers(0, 11, n).astype(np.int32)
    elif "low half wraps" in name:
        # prod & 0xFFFF near 65535 on every row: the low half wraps 2**32
        a = rng.integers(60_000, 65_536, n).astype(np.int32)
        b = np.ones(n, np.int32)
    return words, mask, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("case", LONG_CASES)
def test_cuda_kernels_match_plain_bodies_at_full_length(cuda_device, case):
    _on_card(*_long_case(case), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("view", TAKEN)
def test_cuda_kernels_take_views_on_a_16B_boundary(cuda_device, view):
    """Views of a stack made on the card, as the wrappers get them."""
    kind, sel, a, b = _views(view, cuda_device)
    fn, plain = ((qv.q6_words_i32, qv.q6_words_i32_reference) if kind == "K3"
                 else (qv.q6_mask8_i32, qv.q6_mask8_i32_reference))
    assert torch.equal(fn(sel, a, b), plain(sel, a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("view", REFUSED)
def test_cuda_wrappers_refuse_views_off_a_16B_boundary(cuda_device, view):
    kind, sel, a, b = _views(view, cuda_device)
    fn = qv.q6_words_i32 if kind == "K3" else qv.q6_mask8_i32
    before = _launches()
    with pytest.raises(ValueError, match="16-B boundary"):
        fn(sel, a, b)
    assert _launches() == before
