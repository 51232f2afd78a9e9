"""The sort-based build and sort-merge probe (`ops/join.py`) of the torch
port against `duckdb_cubit_tpu.ops.join`, on the CPU.

Inputs are SF0.01's `l_orderkey` and `o_orderkey` columns (generated by the
port; the same numpy arrays go to both packages): orders as a build side of
unique keys, lineitem as one with 1-7 duplicates of each key, rows of
either side masked out from a numpy seed, and extra probe keys that are
absent or negative.  Integer outputs must be equal exactly, with one
exception: the reference sorts with `lax.sort`, which is not documented as
stable, so the order of build rows within a run of equal keys may differ
from the port's stable sort.  Where that order shows (`sorted_rows`, the
build rows of an expansion), rows are compared run by run as sets, and the
unique keys, `starts`, `counts`, probe entries and probe rows exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_cubit_tpu.ops import join as RJ
from duckdb_cubit_tpu_torch.ops import join as J
from duckdb_cubit_tpu_torch.tpch import load


@pytest.fixture(scope="module")
def keys():
    cat = load.load_catalog(0.01, device="cpu")
    return (cat.table("lineitem").columns["l_orderkey"].host.astype(np.int64),
            cat.table("orders").columns["o_orderkey"].host.astype(np.int64))


def _sides(keys, build_side):
    """-> (build keys, build valid, probe keys, probe valid), numpy."""
    lkeys, okeys = keys
    rng = np.random.default_rng(0 if build_side == "orders" else 1)
    bkeys, pkeys = (okeys, lkeys) if build_side == "orders" else (lkeys, okeys)
    extra = np.concatenate([rng.integers(-50, 0, 100),
                            rng.integers(int(bkeys.max()) + 1,
                                         int(bkeys.max()) + 1000, 100)])
    pkeys = np.concatenate([pkeys, extra, rng.choice(bkeys, 500)])
    return (bkeys, rng.random(len(bkeys)) < 0.8,
            pkeys, rng.random(len(pkeys)) < 0.9)


def _both(bkeys, bvalid):
    ref = RJ.build(jnp.asarray(bkeys), jnp.asarray(bvalid))
    port = J.build(torch.as_tensor(bkeys), torch.as_tensor(bvalid))
    return ref, port


def _runs_as_sets(starts, counts, rows):
    return [frozenset(rows[s:s + c].tolist())
            for s, c in zip(starts, counts) if c > 0]


SIDES = ["orders", "lineitem"]   # unique build keys; 1-7 per key


@pytest.mark.parametrize("build_side", SIDES)
def test_build_matches_reference(keys, build_side):
    bkeys, bvalid, _, _ = _sides(keys, build_side)
    ref, port = _both(bkeys, bvalid)
    np.testing.assert_array_equal(port.unique_keys.numpy(),
                                  np.asarray(ref.ht_keys))
    starts, counts = np.asarray(ref.starts), np.asarray(ref.counts)
    np.testing.assert_array_equal(port.starts.numpy(), starts)
    np.testing.assert_array_equal(port.counts.numpy(), counts)
    assert port.unique_capacity == ref.unique_capacity
    assert _runs_as_sets(starts, counts, port.sorted_rows.numpy()) == \
        _runs_as_sets(starts, counts, np.asarray(ref.sorted_rows))
    # every run holds the valid rows of its key, in row order (stable)
    srows = port.sorted_rows.numpy()
    for s, c, k in zip(starts[:50], counts[:50], port.unique_keys.numpy()):
        run = srows[s:s + c]
        assert (np.diff(run) > 0).all() and (bkeys[run] == k).all()
        assert bvalid[run].all()


@pytest.mark.parametrize("build_side", SIDES)
def test_probe_and_semi_masks_match_reference(keys, build_side):
    bkeys, bvalid, pkeys, pvalid = _sides(keys, build_side)
    ref, port = _both(bkeys, bvalid)
    jk, jv = jnp.asarray(pkeys), jnp.asarray(pvalid)
    tk, tv = torch.as_tensor(pkeys), torch.as_tensor(pvalid)
    entry = J.probe(port, tk, tv)
    assert entry.dtype == torch.int32
    np.testing.assert_array_equal(entry.numpy(),
                                  np.asarray(RJ.probe(ref, jk, jv)))
    assert (entry.numpy() >= 0).any() and (entry.numpy() < 0).any()
    for anti in (False, True):
        np.testing.assert_array_equal(
            J.semi_mask(port, tk, tv, anti=anti).numpy(),
            np.asarray(RJ.semi_mask(ref, jk, jv, anti=anti)))


def test_probe_single_matches_reference_on_unique_keys(keys):
    bkeys, bvalid, pkeys, pvalid = _sides(keys, "orders")
    ref, port = _both(bkeys, bvalid)
    r_row, r_found = RJ.probe_single(ref, jnp.asarray(pkeys),
                                     jnp.asarray(pvalid))
    p_row, p_found = J.probe_single(port, torch.as_tensor(pkeys),
                                    torch.as_tensor(pvalid))
    np.testing.assert_array_equal(p_row.numpy(), np.asarray(r_row))
    np.testing.assert_array_equal(p_found.numpy(), np.asarray(r_found))
    hit = p_found.numpy()
    np.testing.assert_array_equal(bkeys[p_row.numpy()[hit]], pkeys[hit])


def _pairs(probe_rows, build_rows, total):
    return sorted(zip(probe_rows[:total].tolist(),
                      build_rows[:total].tolist()))


@pytest.mark.parametrize("left", [False, True], ids=["inner", "left"])
@pytest.mark.parametrize("build_side", SIDES)
@pytest.mark.parametrize("spare", [64, -1000], ids=["room", "overflow"])
def test_expand_matches_matches_reference(keys, build_side, left, spare):
    """`spare` slots beyond the exact output count (negative: too small a
    capacity, the rows past it are dropped as the reference drops them)."""
    bkeys, bvalid, pkeys, pvalid = _sides(keys, build_side)
    ref, port = _both(bkeys, bvalid)
    entry = J.probe(port, torch.as_tensor(pkeys), torch.as_tensor(pvalid))
    exact = int(torch.where(entry >= 0, port.counts[entry.clamp(min=0).long()],
                            0).sum())
    if left:
        exact += int(((entry < 0) & torch.as_tensor(pvalid)).sum())
    cap = exact + spare
    r_probe, r_build, r_total = RJ.expand_matches(
        ref.starts, ref.counts, ref.sorted_rows, jnp.asarray(entry.numpy()),
        jnp.asarray(pvalid), out_capacity=cap, left=left)
    p_probe, p_build, p_total = J.expand_matches(
        port.starts, port.counts, port.sorted_rows, entry,
        torch.as_tensor(pvalid), out_capacity=cap, left=left)
    assert int(p_total) == int(r_total) == exact
    np.testing.assert_array_equal(p_probe.numpy(), np.asarray(r_probe))
    kept = min(exact, cap)
    p_b, r_b = p_build.numpy(), np.asarray(r_build)
    np.testing.assert_array_equal(p_b[kept:], r_b[kept:])
    if spare > 0:
        assert _pairs(p_probe.numpy(), p_b, kept) == \
            _pairs(p_probe.numpy(), r_b, kept)
    # every emitted pair joins equal keys (or is an unmatched LEFT row)
    pr, br = p_probe.numpy()[:kept], p_b[:kept]
    matched = br >= 0
    np.testing.assert_array_equal(bkeys[br[matched]], pkeys[pr[matched]])
    assert left or matched.all()
