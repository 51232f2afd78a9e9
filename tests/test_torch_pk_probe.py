"""K8, the key-to-row probe for unsorted keys (`ops/pk_probe.py`,
`csrc/pk_probe.cu`): the wrapper's plain body against `DirectPKIndex.probe`
and the row gathers it replaces, the wrapper's checks, and on a card the
kernel against the plain body, bit for bit; then the join's route
(`HashJoin._probe_route`): `k8` for unsorted keys, `k2` for sorted ones,
`gather` for wide keys and verification's leg 3.  This file imports no
jax."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from duckdb_cubit_tpu_torch.api import connect
from duckdb_cubit_tpu_torch.exec import profiler as PROF
from duckdb_cubit_tpu_torch.index.pk import DirectPKIndex
from duckdb_cubit_tpu_torch.ops import pk_probe as K8

I32 = np.iinfo(np.int32)
BASE = 100_000
# a main-path shape: a 30M-key pass into a 1M-slot table (SSB's part)
LARGE = (30_000_000, 1_000_000)


def _case(n: int, slots: int, seed: int, n_vals: int = 2, dtypes=None):
    """A table of `slots` keys from BASE, a quarter of them absent, a third
    of its rows dead, `n_vals` build columns (int32, or of `dtypes`, each
    over its dtype's whole range), and n probe keys mixing
    present, absent, dead, below BASE, past the largest key, INT32_MIN and
    INT32_MAX, with a fifth of the probe rows masked out.  -> (index, build
    mask, columns, keys, mask), all on the CPU."""
    rng = np.random.default_rng(seed)
    rows = max(1, slots * 3 // 4)
    # the table's two ends, and rows - 2 slots between them
    keys = np.unique(np.r_[0, 1 + rng.permutation(max(slots - 2, 0))[
        :rows - 2], slots - 1])
    keys = BASE + rng.permutation(keys)
    rows = len(keys)
    idx = DirectPKIndex.build("k", keys, rows, device="cpu")
    assert (idx.base, idx.max_key) == (BASE, BASE + slots - 1)
    build_mask = torch.as_tensor(rng.random(rows) < 0.67)
    dtypes = dtypes or [np.int32] * n_vals
    cols = [torch.as_tensor(rng.integers(np.iinfo(d).min, np.iinfo(d).max,
                                         rows, dtype=d, endpoint=True))
            for d in dtypes]
    pick = rng.integers(0, 8, n)
    probe = np.where(pick < 5, BASE + rng.integers(0, slots, n), 0)
    probe = np.where(pick == 5, BASE - rng.integers(1, 10**6, n), probe)
    probe = np.where(pick == 6, BASE + slots + rng.integers(0, 10**6, n),
                     probe)
    probe = np.where(pick == 7, rng.choice([I32.min, I32.max, BASE - 1,
                                            BASE + slots], n), probe)
    mask = torch.as_tensor(rng.random(n) < 0.8)
    return idx, build_mask, cols, torch.as_tensor(probe.astype(np.int32)), \
        mask


def _plain_route(idx, build_mask, cols, keys, mask):
    """What the `gather` route gives: `DirectPKIndex.probe`, then the row
    gather of each build column, 0 where no row matched."""
    row, found = idx.probe(keys, mask, build_mask)
    safe = row.clamp(min=0).long()
    vals = [torch.where(found, c[safe], 0) for c in cols]
    return row, found, vals


def _vluts(idx, cols):
    return [idx.device_value_lut(f"c{j}", c.numpy())
            for j, c in enumerate(cols)]


def _view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """t's values in a view that starts `offset` elements into a buffer."""
    buf = torch.zeros(t.shape[0] + offset, dtype=t.dtype, device=t.device)
    buf[offset:] = t
    return buf[offset:]


CPU_CASES = [(0, 64), (1, 64), (7, 64), (1000, 4096), (70_001, 61_130),
             (4096, 1)]


@pytest.mark.parametrize("n,slots", CPU_CASES)
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_plain_body_is_the_probe_and_the_row_gathers(n, slots, offset):
    idx, bmask, cols, keys, mask = _case(n, slots, n + slots + offset)
    before = PROF.read("k8_launches")
    row, found, values = K8.pk_probe(
        K8.live_lut(idx.lut, bmask), idx.base, _view(keys, offset),
        _view(mask, offset), _vluts(idx, cols))
    assert PROF.read("k8_launches") == before
    want_row, want_found, want_vals = _plain_route(idx, bmask, cols, keys,
                                                   mask)
    assert row.dtype == torch.int32 and found.dtype == torch.bool
    assert torch.equal(row, want_row) and torch.equal(found, want_found)
    assert len(values) == len(cols)
    for got, want in zip(values, want_vals):
        assert got.dtype == torch.int32 and torch.equal(got, want)
    if n >= 1000:
        # every kind of key occurs: found, and not found for each reason
        assert 0 < int(found.sum()) < n


WIDE = [np.int8, np.int16, np.int32, np.int8, np.int16]


def test_plain_body_gives_each_value_at_its_columns_width():
    """Each value comes as its build column's dtype: the row gather's
    values, bit for bit, over each dtype's whole range."""
    idx, bmask, cols, keys, mask = _case(5000, 4096, 9, len(WIDE), WIDE)
    dtypes = [c.dtype for c in cols]
    row, found, values = K8.pk_probe(K8.live_lut(idx.lut, bmask), idx.base,
                                     keys, mask, _vluts(idx, cols),
                                     dtypes=dtypes)
    _, _, want_vals = _plain_route(idx, bmask, cols, keys, mask)
    for got, want, d in zip(values, want_vals, dtypes):
        assert got.dtype == d and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_a_value_lut_is_built_where_its_column_lives(dtype):
    """From the column on the index's device, by a gather over the slots,
    with no trip to the host; equal to the lut built from a host mirror (a
    table on a mesh) and 0 at absent slots."""
    idx, _, cols, _, _ = _case(10, 4096, 3, 1, [dtype])
    on_device = idx.device_value_lut("a", cols[0])
    assert idx._lut_host is None
    from_host = idx.device_value_lut("b", cols[0].numpy())
    assert on_device.dtype == from_host.dtype == torch.int32
    assert torch.equal(on_device, from_host)
    assert not on_device[idx.lut < 0].any()
    assert idx.device_value_lut("a", cols[0]) is on_device


def test_keys_at_the_int32_ends_are_not_found():
    """No key wraps: INT32_MIN and INT32_MAX against a table whose slots
    would hold them if `key - base` were taken modulo 2**32."""
    lut = torch.arange(8, dtype=torch.int32)
    keys = torch.tensor([I32.min, I32.max, -8, -1, 0, 7, 8],
                        dtype=torch.int32)
    for base in (I32.min, I32.max - 7, -8, 0):
        row, found, _ = K8.pk_probe(lut, base, keys,
                                    torch.ones(7, dtype=torch.bool))
        k = keys.long()
        want = ((k >= base) & (k < base + 8))
        assert torch.equal(found, want)
        assert torch.equal(row, torch.where(want, (k - base).int(), -1))


@pytest.mark.parametrize("bad", ["int64 keys", "int16 lut", "2-d keys",
                                 "strided keys", "uint8 mask", "short mask",
                                 "empty lut", "short value lut", "int64 out",
                                 "meta"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    keys = torch.zeros(64, dtype=torch.int32)
    lut = torch.zeros(16, dtype=torch.int32)
    mask = torch.ones(64, dtype=torch.bool)
    vluts, dtypes = [lut], None
    if bad == "int64 keys":
        keys = keys.long()
    elif bad == "int16 lut":
        lut = lut.short()
    elif bad == "2-d keys":
        keys, mask = keys.reshape(8, 8), mask.reshape(8, 8)
    elif bad == "strided keys":
        keys = torch.zeros(128, dtype=torch.int32)[::2]
    elif bad == "uint8 mask":
        mask = mask.to(torch.uint8)
    elif bad == "short mask":
        mask = mask[1:]
    elif bad == "empty lut":
        lut, vluts = lut[:0], []
    elif bad == "short value lut":
        vluts = [lut[1:]]
    elif bad == "int64 out":
        dtypes = [torch.int64]
    else:
        keys, lut, mask = (t.to("meta") for t in (keys, lut, mask))
        vluts = [lut]
    with pytest.raises((TypeError, ValueError)):
        K8.pk_probe(lut, 0, keys, mask, vluts, dtypes=dtypes)


@pytest.mark.parametrize("n_vals,width", [(0, 1), (1, 2), (2, 4), (3, 4),
                                          (4, 8), (7, 8)])
def test_entries_hold_a_slots_row_and_values_side_by_side(n_vals, width):
    lut = torch.tensor([3, -1, 0, 2], dtype=torch.int32)
    vluts = [torch.arange(4, dtype=torch.int32) * 10 + j
             for j in range(n_vals)]
    table = K8.entries(lut, vluts)
    assert table.shape == (4, width) and table.is_contiguous()
    assert torch.equal(table[:, 0], lut)
    for j, v in enumerate(vluts):
        assert torch.equal(table[:, 1 + j], v)
    for j in range(1 + n_vals, width):
        assert torch.equal(table[:, j], lut)


def test_probe_bytes_count_keys_flags_rows_values_and_sectors():
    keys = torch.arange(64, dtype=torch.int32).repeat(2)
    mask = torch.ones(128, dtype=torch.bool)
    # 128 rows of 4 + 1 + 1 + 4 + 4 B, and 8 sectors of 64 distinct keys
    # in each of two luts (none where no row is probed)
    assert K8.probe_bytes(keys, mask, [4]) == 128 * 14 + 2 * 32 * 8
    assert K8.probe_bytes(keys, mask, []) == 128 * 10 + 32 * 8
    assert K8.probe_bytes(keys, ~mask, [4]) == 128 * 14
    # values written at their width: an int8 and an int16 column
    assert K8.probe_bytes(keys, ~mask, [1, 2]) == 128 * 13


# ------------------------------------------------------------ on a card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal_on_card(lut, base, keys, mask, vluts, dtypes=None):
    launches = max(1, -(-len(vluts) // K8.MAX_VALS))
    before = PROF.read("k8_launches")
    row, found, values = K8.pk_probe(lut, base, keys, mask, vluts, dtypes)
    torch.cuda.synchronize()
    assert PROF.read("k8_launches") == before + (launches if len(keys)
                                                 else 0)
    want_row, want_found, want_vals = K8.pk_probe_reference(
        lut, base, keys, mask, vluts, dtypes)
    assert torch.equal(found, want_found) and torch.equal(row, want_row)
    assert len(values) == len(want_vals)
    for got, want in zip(values, want_vals):
        assert got.dtype == want.dtype and torch.equal(got, want)
    return found


def _on_card(case, device):
    """-> the case's live lut, keys, mask and value luts on the card, and
    its columns' dtypes."""
    idx, bmask, cols, keys, mask = case
    lut = K8.live_lut(idx.lut, bmask)
    vluts = [v.to(device) for v in _vluts(idx, cols)]
    return lut.to(device), keys.to(device), mask.to(device), vluts, \
        [c.dtype for c in cols]


@pytest.mark.cuda
@pytest.mark.parametrize("n,slots", CPU_CASES + [(1_000_003, 61_130)])
@pytest.mark.parametrize("n_vals", [0, 1, 2, 3, 7, 8, 15])
@pytest.mark.parametrize("widths", ["int32", "mixed"])
def test_cuda_kernel_matches_plain_body(cuda_device, n, slots, n_vals,
                                        widths):
    dtypes = None if widths == "int32" else \
        [WIDE[j % len(WIDE)] for j in range(n_vals)]
    case = _case(n, slots, n * 7 + slots + n_vals, n_vals, dtypes)
    lut, keys, mask, vluts, dtypes = _on_card(case, cuda_device)
    _equal_on_card(lut, BASE, keys, mask, vluts, dtypes)


@pytest.mark.cuda
@pytest.mark.parametrize("key_offset", range(4))
@pytest.mark.parametrize("mask_offset", range(4))
def test_cuda_kernel_on_views_off_a_16_byte_boundary(cuda_device, key_offset,
                                                     mask_offset):
    case = _case(70_001, 4096, 11 + key_offset * 4 + mask_offset,
                 len(WIDE), WIDE)
    lut, keys, mask, vluts, dtypes = _on_card(case, cuda_device)
    for n in (70_001, 9, 1):
        _equal_on_card(lut, BASE, _view(keys[:n], key_offset),
                       _view(mask[:n], mask_offset), vluts, dtypes)


@pytest.mark.cuda
def test_cuda_kernel_at_the_int32_ends(cuda_device):
    lut = torch.arange(8, dtype=torch.int32, device=cuda_device)
    keys = torch.tensor([I32.min, I32.max, -8, -1, 0, 7, 8] * 3,
                        dtype=torch.int32, device=cuda_device)
    mask = torch.ones(21, dtype=torch.bool, device=cuda_device)
    for base in (I32.min, I32.max - 7, -8, 0):
        _equal_on_card(lut, base, keys, mask, [lut])


@pytest.mark.cuda
@pytest.mark.parametrize("n_vals", [1, 2])
def test_cuda_kernel_at_the_main_paths_size(cuda_device, n_vals):
    n, slots = LARGE
    gen = torch.Generator(device=cuda_device).manual_seed(n_vals)
    lut = torch.randperm(slots, generator=gen, device=cuda_device,
                         dtype=torch.int32)
    lut[torch.rand(slots, generator=gen, device=cuda_device) < 0.1] = -1
    vluts = [torch.randint(I32.min, I32.max, (slots,), generator=gen,
                           device=cuda_device, dtype=torch.int32)
             for _ in range(n_vals)]
    keys = torch.randint(1 - slots // 20, slots + slots // 20, (n,),
                         generator=gen, device=cuda_device,
                         dtype=torch.int32) + BASE
    mask = torch.rand(n, generator=gen, device=cuda_device) < 0.9
    found = _equal_on_card(lut, BASE, keys, mask, vluts)
    assert 0.7 * n < int(found.sum()) < 0.8 * n


# ------------------------------------------------------------- the route

def _star(fact_keys: np.ndarray, dim_keys: np.ndarray):
    """A fact table probing a dimension's key-to-row table: `f(f_key,
    f_x)` and `d(d_key, d_val, d_grp)` with a UNIQUE index on d_key, on
    the CPU.  -> (connection, the star query's answer by NumPy)."""
    rng = np.random.default_rng(len(fact_keys))
    d = {"d_key": dim_keys,
         "d_val": rng.integers(0, 1000, len(dim_keys)).astype(np.int32),
         "d_grp": rng.integers(0, 7, len(dim_keys)).astype(np.int32)}
    f = {"f_key": fact_keys,
         "f_x": rng.integers(0, 100, len(fact_keys)).astype(np.int32)}
    conn = connect(None, device="cpu")
    conn.register_numpy("d", dict(d))
    conn.sql("CREATE UNIQUE INDEX ON d(d_key)")
    conn.register_numpy("f", dict(f))
    at = {int(k): i for i, k in enumerate(d["d_key"])}
    acc = {}
    for k, x in zip(f["f_key"], f["f_x"]):
        i = at.get(int(k))
        if i is None or d["d_val"][i] >= 700:
            continue
        g = acc.setdefault(int(d["d_grp"][i]), [0, 0, 0])
        g[0] += int(x)
        g[1] += int(d["d_val"][i])
        g[2] += 1
    return conn, [[str(g), *map(str, acc[g])] for g in sorted(acc)]


STAR_SQL = ("SELECT d_grp, sum(f_x), sum(d_val), count(*) FROM f, d "
            "WHERE f_key = d_key AND d_val < 700 GROUP BY d_grp "
            "ORDER BY d_grp")


def _traced(conn, sql):
    PROF.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            rows = conn.sql(sql).strings()
        spans = PROF.spans()
    finally:
        PROF.reset()
    roots = [s[5] for s in spans if s[0] == "db.sql"]
    routes = [s[5]["route"] for s in spans if s[0] == "db.join.pk_probe"]
    return rows, roots, routes


# the dimension's keys, fewer than the fact table's rows (the smaller side
# builds)
DIM = np.random.default_rng(1).permutation(np.arange(BASE, BASE + 30_000)
                                           ).astype(np.int32)


@pytest.mark.parametrize("order,dtype,route", [
    ("unsorted", np.int32, "k8"), ("unsorted", np.int16, "k8"),
    ("sorted", np.int32, "k2"), ("unsorted", np.int64, "gather")])
def test_a_star_join_takes_its_route(order, dtype, route):
    """Unsorted int32 keys (and narrower ones, widened) take K8 for every
    probe row, whatever the storage's width; sorted keys past K2's size gate keep K2; int64 keys the plain
    route.  The rows are the NumPy answer's on each route."""
    rng = np.random.default_rng(3)
    lo, span = {np.int16: (-20_000, 30_000), np.int64: (2**33, 30_000)
                }.get(dtype, (BASE, 30_000))
    # int16 columns are stored narrow from int32 arrays
    ingest = np.int64 if dtype is np.int64 else np.int32
    dim = (DIM - BASE).astype(np.int64) % span + lo
    dim = np.unique(dim).astype(ingest)
    fact = rng.integers(lo - 500, lo + span + 500, 70_001).astype(ingest)
    if order == "sorted":
        fact = np.sort(fact)
    conn, want = _star(fact, rng.permutation(dim))
    assert conn.catalog.table("f").columns["f_key"].data.dtype == \
        getattr(torch, np.dtype(dtype).name)
    rows, roots, routes = _traced(conn, STAR_SQL)
    assert rows == want and rows
    assert routes == [route]
    (root,) = roots
    assert root["pk_probe_rows"] > 0
    assert root["pk_probe_k8_rows"] == (root["pk_probe_rows"]
                                        if route == "k8" else 0)


@pytest.mark.parametrize("inner,outer", [
    ("d_val * 2 AS d_val", "sum(d_val * 2)"), ("d_grp AS d_val", "sum(d_grp)")])
def test_a_computed_column_under_a_stored_name_is_not_a_value_lut(inner,
                                                                  outer):
    """A build side that computes a column under a stored column's name
    gives its own values, not the stored column's value lut."""
    rng = np.random.default_rng(5)
    fact = rng.integers(BASE - 500, BASE + 30_500, 70_001).astype(np.int32)
    conn, _ = _star(fact, DIM)
    got, _, routes = _traced(conn, (
        f"SELECT sum(f_x), sum(d_val), count(*) FROM f, (SELECT d_key, "
        f"{inner} FROM d) s WHERE f_key = s.d_key"))
    want = conn.sql(f"SELECT sum(f_x), {outer}, count(*) FROM f, d "
                    f"WHERE f_key = d_key").strings()
    assert got == want and routes == ["k8"]


def test_verification_checks_the_k8_route_against_the_plain_plan():
    """Under verification legs 1 and 2 probe through K8 and leg 3, the
    unoptimized plan, through no key-to-row table; the legs agree."""
    rng = np.random.default_rng(4)
    fact = rng.integers(BASE - 500, BASE + 30_500, 70_001).astype(np.int32)
    conn, want = _star(fact, DIM)
    conn.sql("SET enable_verification = true")
    # legs 1-3; leg 4 (row by row in Python) adds nothing to the route
    conn.config.pyverify_max_rows = 0
    rows, roots, routes = _traced(conn, STAR_SQL)
    assert rows == want
    assert routes == ["k8", "k8"]
    assert [name for name, _ in conn.executor.last_legs] == [
        "production", "eager", "unoptimized"]


def test_the_route_of_leg_3_is_the_plain_one():
    """`_probe_route` in verify mode gives `gather`, whatever the keys."""
    from duckdb_cubit_tpu_torch.plan.physical import (HashJoin, RelColumn,
                                                      Relation)
    from duckdb_cubit_tpu_torch.types import INT32

    class Ctx:
        verify_mode = True

    join = HashJoin.__new__(HashJoin)
    join.build_keys = ["d_key"]
    keys = torch.arange(10, dtype=torch.int32)
    rel = Relation({"k": RelColumn(keys, INT32)},
                   torch.ones(10, dtype=torch.bool), 10)
    assert join._probe_route(Ctx(), rel.columns["k"], rel, 10, rel) == \
        "gather"
    Ctx.verify_mode = False
    assert join._probe_route(Ctx(), rel.columns["k"], rel, 10, rel) == "k8"
