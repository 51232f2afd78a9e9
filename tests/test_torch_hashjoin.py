"""HashJoin's general paths: the torch port's operator against the JAX
package's on small relations, at SF0.01 catalogs where a base table is
needed, on the CPU.

Both joins read the same numpy-seeded relations through a source operator
that hands them out; the rows must match as `to_strings` renders them, in
order (the two sort-merge joins emit pairs in the same order: probe rows in
order, and each key's build rows ascending).  The port runs through its
executor, which reads the deferred checks and retries; the reference runs
the operator once, with a capacity that needs no retry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_cubit_tpu import types as RT
from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu.ops import kernels as RK
from duckdb_cubit_tpu.plan import physical as RP
from duckdb_cubit_tpu_torch import types as PT
from duckdb_cubit_tpu_torch.api import connect
from duckdb_cubit_tpu_torch.exec import result as PR
from duckdb_cubit_tpu_torch.exec.executor import Executor
from duckdb_cubit_tpu_torch.ops import kernels as PK
from duckdb_cubit_tpu_torch.plan import physical as P
from duckdb_cubit_tpu_torch.storage.table import Catalog


class RefGiven(RP.PhysicalOperator):
    """A reference source operator that returns a fixed relation."""
    name = "given"

    def __init__(self, rel):
        super().__init__()
        self.rel = rel

    def _execute(self, ctx):
        return self.rel

    def _self_signature(self):
        return f"given[{id(self)}]"


class PortGiven(P.PhysicalOperator):
    """The port's source operator that returns a fixed relation."""
    name = "given"

    def __init__(self, rel):
        super().__init__()
        self.rel = rel

    def _execute(self, ctx):
        return self.rel

    def _self_signature(self):
        return f"given[{id(self)}]"


def make_side(seed: int, n: int, key_range: int, prefix: str,
              invalid: float = 0.1, nulls: bool = False):
    """Host columns of one join side: three int keys, a value, a mask and,
    on request, a NULL mask of the value column."""
    rng = np.random.default_rng(seed)
    cols = {f"{prefix}k": rng.integers(0, key_range, n),
            f"{prefix}k2": rng.integers(0, 3, n),
            f"{prefix}k3": rng.integers(0, 2, n),
            f"{prefix}v": rng.integers(-1000, 1000, n)}
    mask = rng.random(n) >= invalid
    valid = (rng.random(n) >= 0.2) if nulls else None
    return cols, mask, valid


def ref_rel(side):
    cols, mask, valid = side
    out = {}
    for name, a in cols.items():
        v = None if valid is None or not name.endswith("v") \
            else jnp.asarray(valid)
        out[name] = RP.RelColumn(jnp.asarray(a.astype(np.int64)), RT.INT64,
                                 valid=v)
    return RP.Relation(out, jnp.asarray(mask), len(mask))


def port_rel(side):
    cols, mask, valid = side
    out = {}
    for name, a in cols.items():
        v = None if valid is None or not name.endswith("v") \
            else torch.as_tensor(valid)
        out[name] = P.RelColumn(torch.as_tensor(a.astype(np.int64)),
                                PT.INT64, valid=v)
    return P.Relation(out, torch.as_tensor(mask), len(mask))


def run_both(probe, build, pkeys, bkeys, port_kwargs=None, **kwargs):
    """-> (port rows, reference rows, the port's executor, its join)."""
    ref_join = RP.HashJoin(RefGiven(ref_rel(probe)), RefGiven(ref_rel(build)),
                           pkeys, bkeys, **kwargs)
    want = RR.to_strings(ref_join.execute(RP.ExecContext(None)))
    pk = dict(kwargs, **(port_kwargs or {}))
    join = P.HashJoin(PortGiven(port_rel(probe)), PortGiven(port_rel(build)),
                      pkeys, bkeys, **pk)
    ex = Executor(Catalog())
    got = PR.to_strings(ex.execute(join, optimize=False))
    return got, want, ex, join


PROBE = make_side(1, 300, 40, "p_", nulls=True)
BUILD_DUP = make_side(2, 120, 50, "b_", nulls=True)


def unique_build(n_keys: int, cols_used: int, seed: int = 3):
    """A build side whose first `cols_used` key columns are unique."""
    rng = np.random.default_rng(seed)
    sizes = [40, 3, 2]
    grid = np.array(np.meshgrid(*[np.arange(s) for s in sizes[:cols_used]],
                                indexing="ij")).reshape(cols_used, -1).T
    pick = grid[rng.choice(len(grid), n_keys, replace=False)]
    rest = [rng.integers(0, s, n_keys) for s in sizes[cols_used:]]
    pick = np.column_stack([pick, *rest])
    cols = {"b_k": pick[:, 0], "b_k2": pick[:, 1], "b_k3": pick[:, 2],
            "b_v": rng.integers(-1000, 1000, n_keys)}
    return cols, rng.random(n_keys) >= 0.1, None


KEYS = {1: (["p_k"], ["b_k"]),
        2: (["p_k", "p_k2"], ["b_k", "b_k2"]),
        3: (["p_k", "p_k2", "p_k3"], ["b_k", "b_k2", "b_k3"])}


@pytest.mark.parametrize("nkeys", [1, 2, 3])
@pytest.mark.parametrize("join_type", ["inner", "left", "full"])
def test_expansion_with_duplicate_build_keys(nkeys, join_type):
    pkeys, bkeys = KEYS[nkeys]
    got, want, ex, _ = run_both(PROBE, BUILD_DUP, pkeys, bkeys,
                                join_type=join_type, single_match=False,
                                out_capacity=8192)
    assert got == want
    assert len(got) > 0 and ex.retry_count == 0


@pytest.mark.parametrize("nkeys", [1, 2, 3])
@pytest.mark.parametrize("join_type", ["semi", "anti"])
def test_semi_and_anti(nkeys, join_type):
    pkeys, bkeys = KEYS[nkeys]
    got, want, _, _ = run_both(PROBE, BUILD_DUP, pkeys, bkeys,
                               join_type=join_type, out_capacity=8192)
    assert got == want
    assert 0 < len(got) < PROBE[1].sum()


@pytest.mark.parametrize("nkeys", [1, 2, 3])
@pytest.mark.parametrize("join_type", ["inner", "left"])
def test_single_match_on_unique_build_keys(nkeys, join_type):
    pkeys, bkeys = KEYS[nkeys]
    build = unique_build(30, nkeys)
    got, want, ex, _ = run_both(PROBE, build, pkeys, bkeys,
                                join_type=join_type)
    assert got == want
    assert len(got) > 0 and ex.retry_count == 0


@pytest.mark.parametrize("single_match", [True, False])
def test_left_join_found_column(single_match):
    build = unique_build(30, 1) if single_match else BUILD_DUP
    got, want, _, _ = run_both(PROBE, build, ["p_k"], ["b_k"],
                               join_type="left", single_match=single_match,
                               out_capacity=8192, found_column="found")
    assert got == want
    flags = {row[-1] for row in got}
    assert flags == {"true", "false"}


def test_full_outer_appends_unmatched_build_rows():
    """Build keys 40-49 match no probe key (those lie in [0, 40)): they come
    back once each with NULL probe columns, after the expanded pairs."""
    got, want, _, _ = run_both(PROBE, BUILD_DUP, ["p_k"], ["b_k"],
                               join_type="full", single_match=False,
                               out_capacity=8192)
    assert got == want
    cols, mask, _ = BUILD_DUP
    unmatched = int((mask & (cols["b_k"] >= 40)).sum())
    tail = [r for r in got if r[0] == "NULL"]
    assert unmatched > 0 and len(tail) >= unmatched


def test_expansion_regrows_its_capacity():
    """A too small `out_capacity` fails the deferred `expansion` check; the
    executor doubles the capacity (at least 2**13) and runs again."""
    got, want, ex, join = run_both(PROBE, BUILD_DUP, ["p_k"], ["b_k"],
                                   port_kwargs={"out_capacity": 8},
                                   single_match=False, out_capacity=8192)
    assert got == want
    assert ex.retry_count >= 1
    assert join._cap_override == Executor.MIN_CAP
    assert "ov=8192" in join.signature()


def test_duplicate_keys_under_single_match_retry_as_expansion():
    """A single-match join whose build keys turn out duplicated fails the
    `unique` check; the retry takes the expansion join and gives its
    rows."""
    got, want, ex, join = run_both(PROBE, BUILD_DUP, ["p_k"], ["b_k"],
                                   port_kwargs={"single_match": True},
                                   single_match=False, out_capacity=8192)
    assert got == want
    assert ex.retry_count == 1 and join._force_expand
    assert "fe=True" in join.signature()


def test_regrow_rule():
    class Op:
        pass
    op = Op()
    assert Executor._handle_failed_checks(["expansion#0#8"], [op])
    assert op._cap_override == 1 << 13
    assert Executor._handle_failed_checks(["expansion#0#16384"], [op])
    assert op._cap_override == 1 << 15
    assert not Executor._handle_failed_checks([f"expansion#0#{1 << 28}"],
                                              [op])
    assert Executor._handle_failed_checks(["unique#0", "pkprobe#0"], [op])
    assert op._force_expand and op._no_kernel_probe
    assert not Executor._handle_failed_checks(["join_key_pack_range[k]"],
                                              [op])


def test_packed_key_range_check_raises():
    """Two key columns pack exactly only while the second fits 32 bits: a
    wider value fails a check no retry can repair."""
    cols, mask, _ = unique_build(30, 2)
    cols = dict(cols, b_k2=cols["b_k2"] + (1 << 33))
    with pytest.raises(RuntimeError, match="join_key_pack_range"):
        run_both(PROBE, (cols, mask, None), ["p_k", "p_k2"],
                 ["b_k", "b_k2"])


@pytest.fixture(scope="module")
def conns():
    return ref_connect(sf=0.01), connect(sf=0.01, device="cpu")


@pytest.mark.parametrize("join_type", ["semi", "anti"])
def test_reverse_pk_semi_join(conns, join_type):
    """orders semi / anti join a filtered lineitem on o_orderkey: the probe
    side owns the PK, so the build side's hits scatter into orders rows."""
    from duckdb_cubit_tpu.ops import expressions as RE
    from duckdb_cubit_tpu_torch.ops import expressions as PE

    def plan(mod, E):
        orders = mod.TableScan("orders", projection=["o_orderkey",
                                                     "o_totalprice"])
        li = mod.TableScan("lineitem", filters=[E.Col("l_quantity")
                                                > E.dec_lit(49)],
                           projection=["l_orderkey"])
        return mod.HashJoin(orders, li, ["o_orderkey"], ["l_orderkey"],
                            join_type)

    ref, port = conns
    want = RR.to_strings(ref.executor.execute(plan(RP, RE)))
    join = plan(P, PE)
    got = PR.to_strings(port.executor.execute(join))
    assert got == want and 0 < len(got) < 15000
    assert join._reverse_pk is not None and join._pk is None


@pytest.mark.parametrize("sql", [
    # a two-column key: no direct-address PK build side
    "SELECT count(*) AS c, sum(ps_supplycost) AS s FROM lineitem, partsupp "
    "WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey",
    "SELECT count(*) AS c FROM lineitem WHERE l_comment LIKE '%foo%'",
    "SELECT count(*) AS c FROM part WHERE p_name LIKE '%green%'",
])
def test_sql_through_the_general_join_and_like(conns, sql):
    ref, port = conns
    assert port.sql(sql).strings() == ref.sql(sql).strings()


def _ref_hash(x):
    return np.asarray(RK.hash64(jnp.asarray(x))).view(np.int64)


def test_hash64_bit_exact():
    rng = np.random.default_rng(7)
    edges = np.array([0, -1, 1, -(2**63), 2**63 - 1, 2**32, -(2**32)],
                     np.int64)
    keys = np.concatenate([edges, rng.integers(-(2**63), 2**63 - 1, 4096,
                                               dtype=np.int64)])
    got = PK.hash64(torch.as_tensor(keys)).numpy()
    assert (got == _ref_hash(keys)).all()
    other = rng.integers(-(2**63), 2**63 - 1, keys.size, dtype=np.int64)
    want = np.asarray(RK.hash_combine(
        jnp.asarray(keys).astype(jnp.uint64),
        jnp.asarray(other).astype(jnp.uint64))).view(np.int64)
    got = PK.hash_combine(torch.as_tensor(keys),
                          torch.as_tensor(other)).numpy()
    assert (got == want).all()


def test_combined_keys_match_the_reference():
    """`_combine_keys` of 1, 2 and 3 columns: the same int64 keys."""
    side = make_side(5, 64, 1000, "p_")
    for n in (1, 2, 3):
        names = KEYS[n][0]
        want = np.asarray(RP._combine_keys(RP.ExecContext(None),
                                           ref_rel(side), names))
        got = P._combine_keys(P.ExecContext(None), port_rel(side), names)
        assert (got.numpy() == want).all(), n
