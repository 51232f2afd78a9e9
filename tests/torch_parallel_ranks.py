"""Rank-side cases of `tests/test_torch_parallel.py`: run on every rank of
one gloo world through `duckdb_cubit_tpu_torch.parallel.spawn.run`.

Imports no jax: each rank is a fresh interpreter.  Each case builds its
inputs with numpy from the seed of its reference test
(`tests/test_parallel.py`); the test process builds the same inputs with
the same functions and runs the reference on them.  Every result is numpy
(a rank's block, or a replicated value that every rank returns).
"""

import time

import numpy as np
import torch
import torch.distributed as dist

from duckdb_cubit_tpu_torch.parallel import distributed, exchange
from duckdb_cubit_tpu_torch.parallel import mesh as M


def inputs_exchange():
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 10**6, size=800).astype(np.int64)
    vals = rng.integers(0, 1000, size=800).astype(np.int64)
    return keys, vals


def inputs_q6():
    rng = np.random.default_rng(1)
    n_rows, n_words = 2048, 64
    words = [rng.integers(0, 2**32, size=n_words, dtype=np.uint32)
             for _ in range(3)]
    eprice = rng.integers(90000, 10**7, size=n_rows).astype(np.int64)
    disc = rng.integers(0, 11, size=n_rows).astype(np.int64)
    return words, eprice, disc


def inputs_grouped():
    rng = np.random.default_rng(2)
    n = 4096
    codes = rng.integers(0, 8, size=n).astype(np.int32)
    vals = rng.integers(0, 10**9, size=n).astype(np.int64)
    return codes, vals


def inputs_join(seed, n):
    rng = np.random.default_rng(seed)
    bkeys = rng.permutation(np.arange(1, n + 1)).astype(np.int64)
    bvals = rng.integers(1, 100, size=n).astype(np.int64)
    pkeys = rng.integers(1, n + 1, size=n).astype(np.int64)
    pvals = rng.integers(1, 100, size=n).astype(np.int64)
    return bkeys, bvals, pkeys, pvals


def inputs_skew():
    rng = np.random.default_rng(4)
    n = 4096
    keys = np.full(n, 7, dtype=np.int64)          # 90% one hot key
    cold = rng.integers(100, 10**6, size=n // 10).astype(np.int64)
    keys[: n // 10] = cold
    rng.shuffle(keys)
    vals = rng.integers(0, 1000, size=n).astype(np.int64)
    return keys, vals


def inputs_uniform():
    rng = np.random.default_rng(5)
    return rng.integers(1, 10**9, size=4096).astype(np.int64)


def inputs_subgroup():
    """Keys with a few hot values, so the histogram's largest bucket is
    well above the mean."""
    rng = np.random.default_rng(7)
    keys = rng.integers(1, 10**6, size=601).astype(np.int64)
    keys[::5] = rng.integers(1, 4, size=keys[::5].shape[0])
    vals = rng.integers(0, 1000, size=601).astype(np.int64)
    return keys, vals


def inputs_shard_arrays():
    """803 rows: 8 ranks take 101 each, the last 5 rows padding."""
    rng = np.random.default_rng(8)
    return {"k": rng.integers(0, 10**6, size=803).astype(np.int64),
            "d": rng.random(803)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(*xs):
    return tuple(x.cpu().numpy() for x in xs)


def sharded(mesh, *arrays):
    return [M.shard_rows(_t(a), mesh) for a in arrays]


def ones(n, mesh):
    return M.shard_rows(torch.ones(n, dtype=torch.bool), mesh)


def q6_args(mesh, words, eprice, disc):
    ws = sharded(mesh, *[w.view(np.int32) for w in words])
    return (*ws, *sharded(mesh, eprice, disc), ones(eprice.shape[0], mesh))


def join_args(mesh, bkeys, bvals, pkeys, pvals):
    n = bkeys.shape[0]
    bk, bv = sharded(mesh, bkeys, bvals)
    pk, pv = sharded(mesh, pkeys, pvals)
    return bk, bv, ones(n, mesh), pk, pv, ones(pkeys.shape[0], mesh)


def case_exchange(mesh):
    keys, vals = inputs_exchange()
    fn = exchange.make_radix_exchange(mesh, quota=40, n_payload=1)
    k, v, ovf, p = fn(*sharded(mesh, keys), ones(800, mesh),
                      *sharded(mesh, vals))
    return _np(k, v, ovf, p)


def case_q6(mesh):
    fn = distributed.make_q6_step(mesh)
    return _np(*fn(*q6_args(mesh, *inputs_q6())))


def case_grouped(mesh):
    codes, vals = inputs_grouped()
    fn = distributed.make_grouped_agg_step(mesh, num_groups=8)
    return _np(*fn(*sharded(mesh, codes, vals), ones(codes.shape[0], mesh)))


def case_join(mesh):
    n = 1024
    fn = distributed.make_partitioned_join_step(mesh, n // 8, n // 8)
    return _np(*fn(*join_args(mesh, *inputs_join(3, n))))


def requota(mesh, keys, payloads, **kw):
    k, v, p, quota, rounds = exchange.exchange_with_requota(
        mesh, *sharded(mesh, keys), ones(keys.shape[0], mesh),
        sharded(mesh, *payloads), **kw)
    return _np(k, v, *p) + (quota, rounds)


def case_skew(mesh):
    keys, vals = inputs_skew()
    return requota(mesh, keys, [vals])


def case_uniform(mesh):
    return requota(mesh, inputs_uniform(), [])


def case_pipelined(mesh):
    n = 2048
    args = join_args(mesh, *inputs_join(6, n))
    whole = distributed.make_partitioned_join_step(mesh, n // 8, n // 8)
    pipe = distributed.make_pipelined_join_step(mesh, n // 8, n // 8,
                                                n_chunks=4)
    return _np(*whole(*args), *pipe(*args))


def case_subgroup(mesh):
    """A 3-rank mesh: the histogram's quota, then the exchange at it."""
    keys, vals = inputs_subgroup()
    k, valid = sharded(mesh, keys)[0], ones(keys.shape[0], mesh)
    quota = exchange.histogram_quota(mesh, k, valid, mesh.size)
    fn = exchange.make_radix_exchange(mesh, quota, n_payload=1)
    return _np(*fn(k, valid, *sharded(mesh, vals))) + (quota,)


def case_one_rank(mesh):
    """The card's configuration: every step on a 1-rank mesh, and the
    requota from a quarter of the rows (3 rounds)."""
    n = 1024
    q6 = distributed.make_q6_step(mesh)(*q6_args(mesh, *inputs_q6()))
    codes, vals = inputs_grouped()
    grouped = distributed.make_grouped_agg_step(mesh, 8)(
        *sharded(mesh, codes, vals), ones(codes.shape[0], mesh))
    args = join_args(mesh, *inputs_join(3, n))
    join = distributed.make_partitioned_join_step(mesh, n, n)(*args)
    pipe = distributed.make_pipelined_join_step(mesh, n, n // 4, 4)(*args)
    keys, vals = inputs_exchange()
    req = requota(mesh, keys, [vals], quota=keys.shape[0] // 4)
    return {"q6": _np(*q6), "grouped": _np(*grouped), "join": _np(*join),
            "pipelined": _np(*pipe), "requota": req}


def case_shard_arrays(mesh):
    cols = inputs_shard_arrays()
    blocks, valid = M.shard_arrays({k: _t(v) for k, v in cols.items()},
                                   mesh, valid_rows=800)
    return _np(blocks["k"], blocks["d"], valid)


CASES = {"shard_arrays": case_shard_arrays, "exchange": case_exchange, "q6": case_q6, "grouped": case_grouped,
         "join": case_join, "skew": case_skew, "uniform": case_uniform,
         "pipelined": case_pipelined}


def run_all(mesh):
    """Every case on the 8-rank world, then the 3-rank and 1-rank meshes
    (every rank creates them; only their members run a case)."""
    out = {name: case(mesh) for name, case in CASES.items()}
    for size, name, case in ((3, "subgroup", case_subgroup),
                             (1, "one_rank", case_one_rank)):
        sub = M.make_mesh(size, backend="gloo", device="cpu")
        out[name] = None if sub is None else case(sub)
    return out


def raise_on_rank_one(mesh):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1), group=mesh.group)


def sleep_past_deadline(mesh, seconds):
    time.sleep(seconds)
