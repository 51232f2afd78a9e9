"""CUBIT index and bitvector words of the torch port against the JAX package.

Words are compared as bit patterns: the reference's uint32 words viewed as
int32 must equal the port's int32 words exactly.  Counts are exact integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_cubit_tpu.ops import bitmap as ref_bm
from duckdb_cubit_tpu.tpch import load as ref_load
from duckdb_cubit_tpu.tpch.schema import DEFAULT_INDEXES
from duckdb_cubit_tpu_torch.ops import bitmap as bm
from duckdb_cubit_tpu_torch.tpch import load as port_load

INDEXES = [(t, c) for t, spec in DEFAULT_INDEXES.items() for c in spec]


@pytest.fixture(scope="module")
def ref_catalog():
    return ref_load.load_catalog(0.01)


@pytest.fixture(scope="module")
def port_catalog():
    return port_load.load_catalog(0.01, device="cpu")


def _bits(words) -> np.ndarray:
    """Either package's words as int32 bit patterns."""
    if isinstance(words, torch.Tensor):
        assert words.dtype == torch.int32
        return words.numpy()
    return np.array(words, dtype=np.uint32).view(np.int32)


def _pair(ref_catalog, port_catalog, table, col):
    return (ref_catalog.table(table).indexes[col],
            port_catalog.table(table).indexes[col])


@pytest.mark.parametrize("table,col", INDEXES)
def test_built_words_bit_equal(ref_catalog, port_catalog, table, col):
    ri, pi = _pair(ref_catalog, port_catalog, table, col)
    assert (pi.n_bins, pi.n_words, pi.capacity) == \
        (ri.n_bins, ri.n_words, ri.capacity)
    assert np.array_equal(_bits(pi.words), _bits(ri.words))
    assert np.array_equal(_bits(pi.cum_words), _bits(ri.cum_words))
    assert np.array_equal(pi.bin_counts, ri.bin_counts)


def _predicates(ri, rng, k=6):
    """Seeded (kind, args) predicates over an index's value space."""
    if ri.bin_edges is not None:
        lo_v, hi_v = int(ri.bin_edges[0]), int(ri.bin_edges[-1]) + 40
        vals = np.concatenate([ri.bin_edges,
                               rng.integers(lo_v, hi_v, 8)]).astype(np.int64)
    else:
        vals = np.arange(ri.n_bins, dtype=np.int64)
    out = []
    for _ in range(k):
        a, b = sorted(int(x) for x in rng.choice(vals, 2))
        out.append(("range", (a, b, bool(rng.integers(2)),
                              bool(rng.integers(2)))))
        out.append(("range", (None, b)))
        out.append(("range", (a, None)))
        out.append(("eq", int(rng.choice(vals))))
    bins = sorted(set(int(x) for x in rng.integers(0, ri.n_bins, 3)))
    out.append(("isin", bins))
    out.append(("isin", []))
    return out


def _last_bin_refine(pi, lo=None, hi=None, lo_inclusive=True,
                     hi_inclusive=True) -> list:
    if pi.bin_edges is None or hi is None:
        return []
    hi_eff = hi if hi_inclusive else hi - 1
    last = pi.n_bins - 1
    if hi_eff >= pi.bin_edges[-1] and hi_eff < pi.top:
        return [("hi", last)]
    return []


@pytest.mark.parametrize("table,col", INDEXES)
def test_queries_and_counts_equal(ref_catalog, port_catalog, table, col):
    ri, pi = _pair(ref_catalog, port_catalog, table, col)
    rng = np.random.default_rng(INDEXES.index((table, col)))
    for kind, args in _predicates(ri, rng):
        if kind == "range":
            r, p = ri.query_range(*args), pi.query_range(*args)
            # a range ending inside the last bin, below the largest value it
            # holds, must be refined: the JAX package does not
            want = r.refine_bins + _last_bin_refine(pi, *args)
            assert (p.exact, p.refine_bins) == (not want, want)
            assert np.array_equal(_bits(p.words), _bits(r.words)), args
            assert pi.count_range(*args) == ri.count_range(*args)
            assert pi.count(p.words) == ri.count(r.words)
        elif kind == "eq":
            b = int(ri.bin_of(np.asarray([args]))[0]) \
                if ri.bin_edges is not None else args
            if 0 <= b < ri.n_bins:
                assert np.array_equal(_bits(pi.query_eq(args)),
                                      _bits(ri.query_eq(args)))
            assert pi.count_eq(args) == ri.count_eq(args)
        else:
            if args:
                assert np.array_equal(_bits(pi.query_isin(args)),
                                      _bits(ri.query_isin(args)))
            assert pi.count_isin(args) == ri.count_isin(args)


@pytest.mark.parametrize("lo,hi", [(0, 3), (2, 2), (5, 1)])
def test_or_range_equal(ref_catalog, port_catalog, lo, hi):
    ri, pi = _pair(ref_catalog, port_catalog, "lineitem", "l_discount")
    assert np.array_equal(_bits(bm.or_range(pi.words, lo, hi)),
                          _bits(ref_bm.or_range(ri.words, lo, hi)))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 8192 * 3 + 5])
def test_expand_pack_popcount_equal(n):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.4
    nw = bm.num_words(n)
    words = bm.pack_mask(torch.as_tensor(mask), nw)
    ref_words = ref_bm.pack_mask(jnp.asarray(mask), nw)
    assert np.array_equal(_bits(words), _bits(ref_words))
    assert np.array_equal(bm.expand(words, n).numpy(),
                          np.asarray(ref_bm.expand(ref_words, n)))
    assert int(bm.popcount(words)) == int(ref_bm.popcount(ref_words)) \
        == int(mask.sum())
    # bit 31 set in every word: the sign bit of the int32 pattern
    full = torch.full((4,), -1, dtype=torch.int32)
    assert int(bm.popcount(full)) == 128


@pytest.mark.parametrize("table,col", [("lineitem", "l_shipdate"),
                                       ("lineitem", "l_discount"),
                                       ("lineitem", "l_shipmode"),
                                       ("part", "p_size")])
def test_update_insert_delete_merge_equal(ref_catalog, port_catalog,
                                          table, col):
    ri, pi = _pair(ref_catalog, port_catalog, table, col)
    ri, pi = ri.clone(), pi.clone()  # merge must not touch the shared catalog
    t = ref_catalog.table(table)
    host = np.asarray(t.columns[col].host)
    rng = np.random.default_rng(7)
    rows = rng.choice(t.num_rows, 40, replace=False)
    for r in rows[:20]:
        new = host[rng.integers(t.num_rows)]
        ri.update(int(r), host[r], new)
        pi.update(int(r), host[r], new)
    for r in rows[20:]:
        ri.delete(int(r), host[r])
        pi.delete(int(r), host[r])
    for r in range(t.num_rows, min(t.num_rows + 10, t.capacity)):
        new = host[rng.integers(t.num_rows)]
        ri.insert(r, new)
        pi.insert(r, new)
    assert pi.pending_updates == ri.pending_updates
    assert pi.merge() == ri.merge()
    assert np.array_equal(_bits(pi.words), _bits(ri.words))
    assert np.array_equal(_bits(pi.cum_words), _bits(ri.cum_words))
    assert np.array_equal(pi.bin_counts, ri.bin_counts)
    r, p = ri.query_range(None, None), pi.query_range(None, None)
    assert np.array_equal(_bits(p.words), _bits(r.words))


def test_a_range_ending_inside_the_last_bin_is_refined():
    """`f_qty < 45` over `WITH (bins=8)`, the toy star's index (bins from
    44 up): the last bin holds 44-50, so the bin range alone would count
    every row of it."""
    import os

    from duckdb_cubit_tpu_torch.api import Connection
    from tpchbench import run

    toy = os.path.join(os.path.dirname(run.HERE), "tpchbench", "tests",
                       "toy")
    config = run.load_config("toy-star", toy)
    suite = run.load_suite(config, toy)
    fact = suite.tables(config, 1.0)["fact"]
    conn = Connection(device="cpu")
    conn.register_numpy("fact", {c: np.array(a) for c, a in fact.items()})
    conn.sql("CREATE CUBIT INDEX ON fact(f_qty) WITH (bins=8)")
    idx = conn.catalog.table("fact").indexes["f_qty"]
    assert idx.bin_edges[-1] == 44 and idx.top == 50
    q = conn.sql("SELECT count(*) FROM fact WHERE f_qty < 45").strings()
    assert q == [["17612"]] == [[str(int((fact["f_qty"] < 45).sum()))]]
    assert conn.sql("SELECT count(*) FROM fact WHERE f_qty <= 50"
                    ).strings() == [["20000"]]
    assert idx.range_bins(None, 50) == (0, 7, [])
