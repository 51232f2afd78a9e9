"""The slice as a whole at SF0.01, on the CPU: window functions, the band
join and the ASOF join of `tpch/analytic_sql.py`, then DML under a
transaction, a checkpoint and a restart, on the torch port and the JAX
package.

The card run (`chip_smoke.py`) holds the same steps at SF1 against numpy
oracles; here its oracles are held against both packages too, so a fault
in an oracle shows before the card does.  Rows must match as `to_strings`
renders them, DOUBLE cells within the 1e-9 relative tolerance of
`tpch/answers.cells_equal`.
"""

import numpy as np
import pytest

import chip_smoke as CS
from duckdb_cubit_tpu.api import Connection as RefConnection
from duckdb_cubit_tpu.storage.persist import open_database as ref_open
from duckdb_cubit_tpu.tpch import load as rload
from duckdb_cubit_tpu_torch.api import Connection
from duckdb_cubit_tpu_torch.ops import fused_scan as fs
from duckdb_cubit_tpu_torch.ops import probe as PPK
from duckdb_cubit_tpu_torch.storage.persist import open_database
from duckdb_cubit_tpu_torch.tpch import analytic_sql as S
from duckdb_cubit_tpu_torch.tpch.answers import cells_equal
from duckdb_cubit_tpu_torch.tpch.load import load_catalog

QUERIES = {"Q6": CS.Q6, "Q1": CS.Q1, "Q12": CS.Q12, "Q3": CS.Q3}


@pytest.fixture()
def conns():
    """Uncached SF0.01 catalogs (DML must not reach the shared ones)."""
    ref = RefConnection(rload.load_catalog(0.01, cache=False))
    port = Connection(load_catalog(0.01, device="cpu", cache=False),
                      device="cpu")
    return ref, port


def agree(got, want):
    return len(got) == len(want) and all(
        len(a) == len(b) and all(cells_equal(x, y) for x, y in zip(a, b))
        for a, b in zip(got, want))


def both(conns, sql):
    ref, port = conns
    got, want = port.sql(sql), ref.sql(sql)
    assert agree(got.strings(), want.strings()), sql
    assert got.status == want.status, sql
    return got.status or got.strings()


def test_windows_band_and_asof_joins(conns):
    ref, port = conns
    for c in conns:
        for stmt in S.month_bands():
            c.sql(stmt)
    rows = {name: both(conns, sql) for name, sql in S.QUERIES.items()}
    cat = port.catalog
    assert rows["W1"] == CS.oracle_w1(CS.live_columns(cat.table("lineitem"),
                                                      CS.LI_COLS))
    a1, a1_left = CS.oracle_a1(CS.live_columns(cat.table("orders"),
                                               CS.ORDER_COLS))
    assert rows["A1"] == a1 and rows["A1_LEFT"] == a1_left
    assert len(rows["R1"]) == 82 and len(rows["W2"]) == 10
    # each lineitem row falls in one band; the residual keeps a part
    n_rows = cat.table("lineitem").num_rows
    assert 0 < sum(int(r[1]) for r in rows["R1"]) < n_rows


def counted(port, sql):
    """-> (rows, K1 calls, K2 calls) of one port query."""
    k1, k2 = [], []
    real1, real2 = fs.fused_scan_sum, PPK.monotone_gather_many
    fs.fused_scan_sum = lambda *a: k1.append(1) or real1(*a)
    PPK.monotone_gather_many = lambda l, k: k2.append(1) or real2(l, k)
    try:
        rows = port.sql(sql).strings()
    finally:
        fs.fused_scan_sum, PPK.monotone_gather_many = real1, real2
    return rows, len(k1), len(k2)


def test_dml_transaction_checkpoint_and_restart(conns, tmp_path):
    """The card run's DML steps: each query equals the reference and the
    script's numpy oracle over the mutated columns; K1 runs after the
    UPDATE, not after the DELETE, and again after ROLLBACK."""
    ref, port = conns
    for c in conns:
        c.config.index_scan_max_count = 0
        c.config.index_scan_percentage = 0.0

    def check(name, k1=None, k2_min=0, want=None):
        rows, n1, n2 = counted(port, QUERIES[name])
        assert agree(rows, ref.sql(QUERIES[name]).strings()), name
        assert CS.rows_agree(rows, CS.oracle_of(port.catalog, name)
                             if want is None else want), name
        assert k1 is None or n1 == k1, (name, n1)
        assert n2 >= k2_min, name
        return rows

    base = {name: check(name) for name in QUERIES}
    both(conns, "BEGIN")
    both(conns, "UPDATE lineitem SET l_discount = l_discount + 0.01 WHERE "
         "l_orderkey <= 600 AND l_discount < 0.10")
    assert check("Q6", k1=1) != base["Q6"]
    top = int(base["Q3"][0][0])
    both(conns, f"UPDATE orders SET o_shippriority = 1 WHERE o_orderkey "
         f"BETWEEN {top - 300} AND {top + 300}")
    rows = check("Q3", k2_min=1)
    assert rows[0][0] == str(top) and rows[0][3] == "1"
    assert both(conns, "DELETE FROM orders WHERE o_orderdate < "
                "DATE '1993-01-01'").startswith("DELETE ")
    check("Q12", k2_min=1)
    check("Q3", k2_min=1)
    both(conns, "DELETE FROM lineitem WHERE l_quantity > 45")
    check("Q1")
    check("Q6", k1=0)
    both(conns, "ROLLBACK")
    for name in QUERIES:
        assert check(name, k1=1 if name == "Q6" else None,
                     want=base[name]) == base[name]
    paths = {}
    for c, name in ((ref, "ref"), (port, "port")):
        paths[name] = str(tmp_path / name)
        c.attach(paths[name])
        c.checkpoint()
        c.sql("BEGIN")
        c.sql("DELETE FROM lineitem WHERE l_orderkey <= 600")
        c.sql("COMMIT")
    after = {name: port.sql(QUERIES[name]).strings()
             for name in ("Q1", "Q6", "Q3")}
    reopened = open_database(paths["port"], device="cpu")
    for name, want in after.items():
        assert agree(reopened.sql(QUERIES[name]).strings(), want), name
        assert agree(ref.sql(QUERIES[name]).strings(), want), name
    # the reference reopens the port's directory too
    from_port = ref_open(paths["port"])
    assert agree(from_port.sql(CS.Q1).strings(), after["Q1"])
