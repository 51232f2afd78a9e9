"""EXPLAIN ANALYZE and the query profiler on the torch port, against the JAX
package.

Both packages run the same optimized plans with a `QueryProfiler`
(`exec/profiler.py`): the operator tree of `to_json` must hold the same
operator names and the same cardinalities (live rows out of each
operator) in both; the times are not compared.  EXPLAIN ANALYZE renders
the same tree; `sql(..., profile=True)` gives the rows of an unprofiled
run and leaves the profiler on the executor.  At SF0.01 on the CPU.
"""

import json
import re

import pytest

from duckdb_cubit_tpu.api import connect as ref_connect
from duckdb_cubit_tpu_torch.api import connect
from duckdb_cubit_tpu_torch.exec.profiler import QueryProfiler
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL
from test_torch_staged import one_intra_op_thread  # noqa: F401

QUERIES = {
    "q3": SQL[3],
    "q12": SQL[12],
    "q6": SQL[6],
    "grouped_left_join": """
        SELECT o_orderpriority, count(*) AS c
        FROM lineitem LEFT JOIN
             (SELECT o_orderkey, o_orderpriority FROM orders
              WHERE o_totalprice < 100000) o ON l_orderkey = o_orderkey
        WHERE l_quantity < 3
        GROUP BY o_orderpriority ORDER BY o_orderpriority""",
}


@pytest.fixture(scope="module")
def conns():
    return ref_connect(sf=0.01), connect(0.01, device="cpu")


def _tree(node):
    """(name, cardinality, children) of a to_json node, times left out."""
    return (node["name"], node["cardinality"],
            [_tree(c) for c in node["children"]])


@pytest.mark.parametrize("name", list(QUERIES))
def test_profile_tree_matches_reference(conns, name):
    ref, port = conns
    sql = QUERIES[name]
    got = port.sql(sql, profile=True)
    want = ref.sql(sql, profile=True)
    assert got.strings() == want.strings()
    port_json = json.loads(port.executor.profiler.to_json(
        port.executor.plan))
    ref_json = json.loads(ref.executor.profiler.to_json(ref.executor.plan))
    assert _tree(port_json["plan"]) == _tree(ref_json["plan"])
    assert set(port_json["phases"]) == set(ref_json["phases"]) == {"execute"}
    # an operator's time includes its children's
    assert port_json["plan"]["time_ms"] <= \
        port_json["phases"]["execute"] * 1e3 + 1e-6


_TIMES = re.compile(r"\[[0-9.]+ ms")


@pytest.mark.parametrize("name", ["q3", "q12"])
def test_explain_analyze_matches_reference(conns, name):
    """EXPLAIN ANALYZE: the plan, then the profiled tree; equal to the
    reference's with the times masked."""
    ref, port = conns
    sql = "EXPLAIN ANALYZE " + QUERIES[name]
    got = port.sql(sql).strings()
    want = ref.sql(sql).strings()

    def masked(rows):
        return [_TIMES.sub("[t ms", r[0]).split("\nphases:")[0]
                for r in rows]
    assert masked(got) == masked(want)
    assert all(", " in line and line.endswith(" rows]")
               for line in masked(got)[-1].split("\n"))


def test_profiler_records_and_renders():
    """The profiler itself: nested operator timers accumulate, cardinalities
    render, phases print."""
    class Op:
        def __init__(self, name, children=()):
            self.name, self.children = name, list(children)

        def describe(self):
            return self.name

    leaf = Op("leaf")
    root = Op("root", [leaf])
    prof = QueryProfiler()
    with prof.phase("execute"):
        with prof.operator(root):
            with prof.operator(leaf):
                pass
            prof.record_cardinality(leaf, 7)
        prof.record_cardinality(root, 3)
    text = prof.render(root)
    assert re.fullmatch(r"root  \[[0-9.]+ ms, 3 rows\]\n"
                        r"  leaf  \[[0-9.]+ ms, 7 rows\]\n"
                        r"phases: execute=[0-9.]+ms", text)
    tree = json.loads(prof.to_json(root))["plan"]
    assert _tree(tree) == ("root", 3, [("leaf", 7, [])])
    assert tree["time_ms"] >= tree["children"][0]["time_ms"]
