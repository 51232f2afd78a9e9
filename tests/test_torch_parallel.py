"""The mesh layer's steps on `torch.distributed`, against the JAX package:
the twin of `tests/test_parallel.py`.

One gloo world of 8 CPU ranks is spawned once for the file
(`parallel/spawn.run`); every case runs inside it (`torch_parallel_ranks`),
on inputs built with numpy from the reference test's seed.  This process
runs the reference on `make_mesh(8)` (8 virtual devices, `conftest.py`)
over the same inputs.  A row-sharded output is compared as the ranks'
blocks concatenated in rank order against the reference's global array,
bit for bit; a replicated one must be the same on every rank and equal the
reference's.
"""

import multiprocessing
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from duckdb_cubit_tpu.parallel import distributed as RD
from duckdb_cubit_tpu.parallel import exchange as RE
from duckdb_cubit_tpu.parallel import mesh as RM
from duckdb_cubit_tpu_torch.ops import join as join_ops
from duckdb_cubit_tpu_torch.ops import kernels
from duckdb_cubit_tpu_torch.parallel import exchange, spawn

N_RANKS = 8
GLOO = {"backend": "gloo", "device": "cpu"}


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results of every case, from one 8-rank world."""
    return spawn.run(R.run_all, N_RANKS, **GLOO)


def blocks(ranks, case, i, members=N_RANKS):
    """Output i of `case` over the mesh: the ranks' blocks in rank order."""
    return np.concatenate([ranks[r][case][i] for r in range(members)])


def replicated(ranks, case, i, members=N_RANKS):
    vals = [ranks[r][case][i] for r in range(members)]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


def ref_sharded(m, *arrays):
    return [RM.shard_rows(jnp.asarray(a), m) for a in arrays]


def ref_ones(n, m):
    return RM.shard_rows(jnp.ones(n, bool), m)


def ref_join_args(m, bkeys, bvals, pkeys, pvals):
    return (*ref_sharded(m, bkeys, bvals), ref_ones(bkeys.shape[0], m),
            *ref_sharded(m, pkeys, pvals), ref_ones(pkeys.shape[0], m))


def ref_q6_args(m, words, eprice, disc):
    return (*ref_sharded(m, *words, eprice, disc), ref_ones(eprice.shape[0], m))


def assert_bits(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", range(1, 10))
def test_partition_ids_match_reference(n):
    """The unsigned `hash64 % n` over keys whose hashes fill the whole
    uint64 range (half with the top bit set), n a power of two or not."""
    keys = np.random.default_rng(n).integers(-2**63, 2**63 - 1, 20_000,
                                             dtype=np.int64)
    got = exchange.partition_ids(torch.from_numpy(keys), n).numpy()
    want = np.asarray(RE.partition_ids(jnp.asarray(keys), n))
    assert (np.asarray(kernels.hash64(torch.from_numpy(keys))) < 0).any()
    np.testing.assert_array_equal(got, want)


def test_shard_arrays_blocks_and_mask(ranks):
    """Columns padded with copies of the last row, and the validity mask
    of the first `valid_rows` rows, block by block."""
    m = RM.make_mesh(8)
    cols = R.inputs_shard_arrays()
    want, valid = RM.shard_arrays({k: jnp.asarray(v) for k, v in cols.items()},
                                  m, valid_rows=800)
    for i, w in enumerate((want["k"], want["d"], valid)):
        assert_bits(blocks(ranks, "shard_arrays", i), w)
    assert blocks(ranks, "shard_arrays", 0).shape[0] == 808


def test_radix_exchange_routes_and_conserves(ranks):
    m = RM.make_mesh(8)
    keys, vals = R.inputs_exchange()
    fn = RE.make_radix_exchange(m, quota=40, n_payload=1)
    k2, v2, ovf, p2 = fn(*ref_sharded(m, keys), ref_ones(800, m),
                         *ref_sharded(m, vals))
    for i, want in ((0, k2), (1, v2), (3, p2)):
        assert_bits(blocks(ranks, "exchange", i), want)
    assert int(replicated(ranks, "exchange", 2)) == int(ovf) == 0
    # each rank holds exactly the rows it owns
    for r in range(N_RANKS):
        k, v = ranks[r]["exchange"][0], ranks[r]["exchange"][1]
        dest = exchange.partition_ids(torch.from_numpy(k[v]), N_RANKS)
        assert (dest.numpy() == r).all()


def test_distributed_q6_matches_local(ranks):
    m = RM.make_mesh(8)
    words, eprice, disc = R.inputs_q6()
    hi, lo = RD.make_q6_step(m)(*ref_q6_args(m, words, eprice, disc))
    got = [replicated(ranks, "q6", i) for i in range(2)]
    assert [int(x) for x in got] == [int(hi), int(lo)]
    wmask = words[0] & words[1] & words[2]
    bits = np.unpackbits(wmask.view(np.uint8), bitorder="little")[:2048]
    want = int((eprice * disc)[bits.astype(bool)].sum())
    assert (int(got[0]) << 32) + int(got[1]) == want


def test_distributed_grouped_agg_matches_local(ranks):
    m = RM.make_mesh(8)
    codes, vals = R.inputs_grouped()
    want = RD.make_grouped_agg_step(m, num_groups=8)(
        *ref_sharded(m, codes, vals), ref_ones(codes.shape[0], m))
    for i in range(3):
        got = replicated(ranks, "grouped", i)
        np.testing.assert_array_equal(got, np.asarray(want[i]))
    for g in range(8):
        hi, lo, cnt = (replicated(ranks, "grouped", i)[g] for i in range(3))
        assert (int(hi) << 32) + int(lo) == int(vals[codes == g].sum())
        assert int(cnt) == int((codes == g).sum())


def test_distributed_join_matches_local(ranks):
    m = RM.make_mesh(8)
    n = 1024
    bkeys, bvals, pkeys, pvals = R.inputs_join(3, n)
    total, ovf = RD.make_partitioned_join_step(m, n // 8, n // 8)(
        *ref_join_args(m, bkeys, bvals, pkeys, pvals))
    got = [int(replicated(ranks, "join", i)) for i in range(2)]
    assert got == [int(total), int(ovf)] and got[1] == 0
    lookup = dict(zip(bkeys, bvals))
    assert got[0] == int(sum(pv * lookup[pk] for pk, pv in zip(pkeys, pvals)))


def _ref_requota(m, keys, payloads, **kw):
    k2, v2, p2, quota, rounds = RE.exchange_with_requota(
        m, *ref_sharded(m, keys), ref_ones(keys.shape[0], m),
        ref_sharded(m, *payloads), **kw)
    return [k2, v2, *p2], quota, rounds


def _assert_requota(ranks, case, m, keys, payloads, members=N_RANKS, **kw):
    want, quota, rounds = _ref_requota(m, keys, payloads, **kw)
    got = [ranks[r][case] for r in range(members)]
    assert {g[-2:] for g in got} == {(quota, rounds)}
    for i, w in enumerate(want):
        assert_bits(np.concatenate([g[i] for g in got]), w)
    return quota, rounds


def test_exchange_requota_on_90pct_skew(ranks):
    """90%-one-key rows: the first quota overflows and the host doubles it,
    the same number of rounds as the reference."""
    keys, vals = R.inputs_skew()
    quota, rounds = _assert_requota(ranks, "skew", RM.make_mesh(8), keys,
                                    [vals])
    assert rounds > 1
    assert quota == exchange.default_quota(4096 // 8, 8) * 2 ** (rounds - 1)
    k, v, p = (blocks(ranks, "skew", i) for i in range(3))
    assert (sorted(zip(k[v].tolist(), p[v].tolist()))
            == sorted(zip(keys.tolist(), vals.tolist())))


def test_requota_uniform_keys_single_round(ranks):
    keys = R.inputs_uniform()
    assert _assert_requota(ranks, "uniform", RM.make_mesh(8), keys,
                           [])[1] == 1
    k, v = blocks(ranks, "uniform", 0), blocks(ranks, "uniform", 1)
    np.testing.assert_array_equal(np.sort(k[v]), np.sort(keys))


def test_pipelined_join_matches_unpipelined(ranks):
    """The chunked join with its exchanges issued ahead of each probe ==
    the one-shot join == the reference's pipelined join."""
    m = RM.make_mesh(8)
    n = 2048
    inputs = R.inputs_join(6, n)
    args = ref_join_args(m, *inputs)
    want = RD.make_pipelined_join_step(m, n // 8, n // 8, n_chunks=4)(*args)
    got = [int(replicated(ranks, "pipelined", i)) for i in range(4)]
    assert got == [int(want[0]), int(want[1])] * 2 and got[1] == 0
    bkeys, bvals, pkeys, pvals = inputs
    lookup = dict(zip(bkeys, bvals))
    assert got[0] == int(sum(pv * lookup[pk] for pk, pv in zip(pkeys, pvals)))


def test_three_rank_subgroup_exchange(ranks):
    """A mesh over ranks 0-2 of the 8-rank world against the reference's
    `make_mesh(3)`: the histogram's quota, then the exchange at it; ranks
    3-7 ran nothing."""
    m = RM.make_mesh(3)
    keys, vals = R.inputs_subgroup()
    k, valid = ref_sharded(m, keys)[0], ref_ones(keys.shape[0], m)
    quota = RE.histogram_quota(m, k, valid, 3)
    assert quota > RE.default_quota(-(-keys.shape[0] // 3), 3, 1.0)
    want = RE.make_radix_exchange(m, quota, 1)(k, valid,
                                               *ref_sharded(m, vals))
    assert {ranks[r]["subgroup"][-1] for r in range(3)} == {quota}
    for i in (0, 1, 3):
        assert_bits(blocks(ranks, "subgroup", i, 3), want[i])
    assert int(replicated(ranks, "subgroup", 2, 3)) == int(want[2]) == 0
    assert all(ranks[r]["subgroup"] is None for r in range(3, N_RANKS))


def test_one_rank_mesh_equals_single_device(ranks):
    """The card's configuration: each step on a 1-rank mesh equals the
    single-device computation (the port's ops) and the reference's
    `make_mesh(1)`; the requota from a quarter of the rows takes 3 rounds
    and ends at 4x its quota."""
    got = ranks[0]["one_rank"]
    assert all(ranks[r]["one_rank"] is None for r in range(1, N_RANKS))
    words, eprice, disc = R.inputs_q6()
    mask = torch.from_numpy(np.unpackbits(
        (words[0] & words[1] & words[2]).view(np.uint8),
        bitorder="little").astype(bool))
    hi, lo = kernels.masked_sum_exact(torch.from_numpy(eprice * disc), mask)
    assert [int(x) for x in got["q6"]] == [int(hi), int(lo)]
    codes, vals = R.inputs_grouped()
    c, v = torch.from_numpy(codes).long(), torch.from_numpy(vals)
    live = torch.ones(codes.shape[0], dtype=torch.bool)
    ghi, glo = kernels.group_sum_exact(c, v, live, 8)
    want = [ghi.numpy(), glo.numpy(), kernels.group_count(c, live, 8).numpy()]
    for g, w in zip(got["grouped"], want):
        np.testing.assert_array_equal(g, w)
    bkeys, bvals, pkeys, pvals = R.inputs_join(3, 1024)
    bs = join_ops.build(torch.from_numpy(bkeys), torch.ones(1024, dtype=bool))
    row, found = join_ops.probe_single(bs, torch.from_numpy(pkeys),
                                       torch.ones(1024, dtype=bool))
    total = int((pvals * bvals[row.numpy()])[found.numpy()].sum())
    assert [int(x) for x in got["join"]] == [total, 0]
    assert [int(x) for x in got["pipelined"]] == [total, 0]
    m = RM.make_mesh(1)
    keys, vals = R.inputs_exchange()
    want, quota, rounds = _ref_requota(m, keys, [vals], quota=800 // 4)
    assert (quota, rounds) == got["requota"][-2:] == (800, 3)
    for g, w in zip(got["requota"], want):
        assert_bits(g, w)


def test_a_failing_rank_fails_the_launch_fast():
    """Rank 1 raises while rank 0 waits for it in an all-reduce: the
    launcher kills both and raises with rank 1's traceback well inside its
    deadline."""
    t0 = time.monotonic()
    with pytest.raises(spawn.RankError, match="fails on purpose"):
        spawn.run(R.raise_on_rank_one, 2, deadline_s=60, **GLOO)
    assert time.monotonic() - t0 < 50
    assert not multiprocessing.active_children()


def test_the_deadline_kills_every_rank():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn.run(R.sleep_past_deadline, 2, 600, deadline_s=5, **GLOO)
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()
