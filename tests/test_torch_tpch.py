"""All 22 TPC-H plan builders: the torch port's `tpch/queries.run` against
the JAX package's, at SF0.01 on the CPU.

The twin of `tests/test_tpch.py` without its golden CSVs: the reference
package is the oracle.  Rows must match as `to_strings` renders them, in
order, exactly, except DOUBLE cells, which get the 1e-9 relative tolerance
of `tpch/answers.cells_equal` (the engines sum and divide floats in
different orders).  The port runs each builder on its generated catalog and
on the catalog carried from the reference (`from_reference_catalog`).
"""

import pytest

from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu.exec import result as RR
from duckdb_cubit_tpu.tpch import queries as ref_queries
from duckdb_cubit_tpu.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.api import Connection, connect
from duckdb_cubit_tpu_torch.exec import result as PR
from duckdb_cubit_tpu_torch.tpch import queries
from duckdb_cubit_tpu_torch.tpch.load import from_reference_catalog


@pytest.fixture(scope="module")
def ref_conn():
    return ref_connect(sf=0.01)


@pytest.fixture(scope="module")
def ref_rows(ref_conn):
    """The reference's rows per query, computed once."""
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = RR.to_strings(ref_queries.run(ref_conn.executor, n))
        return cache[n]
    return get


@pytest.fixture(scope="module")
def port_conns(ref_conn):
    return {"generated": connect(sf=0.01, device="cpu"),
            "carried": Connection(from_reference_catalog(ref_conn.catalog,
                                                         device="cpu"),
                                  device="cpu")}


def rows_match(got, want) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(w) and all(cells_equal(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


@pytest.mark.parametrize("source", ["generated", "carried"])
@pytest.mark.parametrize("n", sorted(queries.QUERIES))
def test_builder_matches_reference(ref_rows, port_conns, source, n):
    got = PR.to_strings(queries.run(port_conns[source].executor, n))
    assert rows_match(got, ref_rows(n)), (got[:3], ref_rows(n)[:3])


def test_query_set_is_the_reference_s():
    assert sorted(queries.QUERIES) == sorted(ref_queries.QUERIES) == \
        list(range(1, 23))
    assert {n for n, b in queries.QUERIES.items()
            if getattr(b, "multi_phase", False)} == {11, 15, 22}


@pytest.mark.parametrize("n", [1, 6])
def test_get_query_runs_eagerly(ref_rows, port_conns, n):
    """`get_query` builds the plan alone; the executor runs it."""
    conn = port_conns["generated"]
    got = PR.to_strings(conn.executor.execute(queries.get_query(n)))
    assert rows_match(got, ref_rows(n))


def test_get_query_refuses_unknown_numbers():
    with pytest.raises(NotImplementedError, match="Q23"):
        queries.get_query(23)


def test_in_program_spans_of_q13(port_conns):
    """Under torch.profiler the engine's own spans name a plan's operators,
    its LIKE and its phases: q13 runs each of its two group-bys once."""
    import torch

    from duckdb_cubit_tpu_torch.exec import profiler as PROF

    conn = port_conns["generated"]
    PROF.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        PR.to_strings(queries.run(conn.executor, 13))
    names = [s[0] for s in PROF.spans()]
    PROF.reset()
    assert {"db.op.hash_join", "db.op.group_aggregate", "db.op.table_scan",
            "db.dict.Like", "db.prepare", "db.format"} <= set(names)
    assert names.count("db.op.group_aggregate") == 2


def test_builders_run_without_retries():
    """At SF0.01 every single-match join finds unique build keys and no
    plan expands: no builder needs a second run."""
    conn = connect(sf=0.01, device="cpu")
    for n in sorted(queries.QUERIES):
        PR.to_strings(queries.run(conn.executor, n))
    assert conn.executor.retry_count == 0
