"""The torch port runs without jax: the machine with the card has none.

A fresh interpreter imports the port's API, runs Q6 at SF0.01 on the CPU,
runs statements (CREATE TABLE, INSERT, CREATE INDEX, SET), the TPC-H SQL
text of Q21, one sqllogic file through the port's runner, a window query, a
band join, an ASOF join, DML in a rolled-back transaction, a checkpoint and
`open_database`; then a verified query (leg 4 included), EXPLAIN ANALYZE, a
prepared query and a query forced out of core; then Q6's step on a
one-rank gloo mesh (the mesh layer), Q6's SQL text on the engine sharded
over that mesh (`parallel/shard.py`, `parallel/exchange_join.py`) and the
shell's module; and must never have loaded jax or the reference package.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import duckdb_cubit_tpu_torch.api as api
conn = api.connect(sf=0.01, device="cpu")
rows = conn.sql('''
    SELECT sum(l_extendedprice * l_discount) AS revenue FROM lineitem
    WHERE l_shipdate >= CAST('1994-01-01' AS date)
      AND l_shipdate < CAST('1995-01-01' AS date)
      AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24
''').strings()
conn.sql("CREATE TABLE t (k INTEGER, s VARCHAR)")
conn.sql("INSERT INTO t VALUES (1, 'a'), (2, NULL)")
conn.sql("CREATE INDEX ON t(k)")
conn.sql("SET small_group_limit = 16")
assert conn.sql("SELECT count(s) AS c FROM t").strings() == [["1"]]
from duckdb_cubit_tpu_torch.tpch.sql_queries import SQL
assert conn.sql(SQL[21]).strings()[0] == ["Supplier#000000074", "9"]
from duckdb_cubit_tpu_torch.testing.sqllogic import run_file
assert run_file("tests/sqllogic/joins.test",
                conn=api.Connection(device="cpu")).executed > 0
import tempfile
from duckdb_cubit_tpu_torch.storage.persist import open_database
assert conn.sql("SELECT k, row_number() OVER (ORDER BY k DESC) AS r "
                "FROM t ORDER BY k").strings() == [["1", "2"], ["2", "1"]]
assert conn.sql("SELECT count(*) AS c FROM t a, t b WHERE a.k < b.k"
                ).strings() == [["1"]]
assert conn.sql("SELECT a.k, b.k AS bk FROM t a ASOF JOIN t b ON a.k > b.k"
                ).strings() == [["2", "1"]]
conn.sql("BEGIN")
conn.sql("UPDATE t SET k = 5 WHERE k = 1")
conn.sql("DELETE FROM t WHERE k = 2")
conn.sql("ROLLBACK")
path = tempfile.mkdtemp()
conn.attach(path)
conn.checkpoint()
conn.sql("DELETE FROM t WHERE k = 1")
assert open_database(path, device="cpu").sql(
    "SELECT k FROM t").strings() == [["2"]]
conn.sql("PRAGMA enable_verification")
assert conn.sql("SELECT n_regionkey, count(*) AS c FROM nation "
                "GROUP BY n_regionkey ORDER BY n_regionkey").strings()[0] \
    == ["0", "5"]
assert conn.executor.last_legs[-1][0] == "row-by-row"
conn.sql("PRAGMA disable_verification")
assert "rows]" in conn.sql("EXPLAIN ANALYZE SELECT count(*) AS c "
                           "FROM region").strings()[-1][0]
assert api.R.to_strings(conn.prepare("SELECT count(*) AS c FROM region")
                        .execute()) == [["5"]]
conn.sql("SET force_external = true")
assert conn.sql("SELECT l_returnflag, count(*) AS c FROM lineitem GROUP BY "
                "l_returnflag ORDER BY l_returnflag").strings()[0][0] == "A"
assert conn.executor.external_passes >= 4
import torch
import torch.distributed as dist
from duckdb_cubit_tpu_torch import shell  # noqa: F401
from duckdb_cubit_tpu_torch.parallel import distributed, exchange  # noqa: F401
from duckdb_cubit_tpu_torch.parallel.mesh import make_mesh
dist.init_process_group("gloo", init_method="file://" + path + "/rendezvous",
                        rank=0, world_size=1)
mesh = make_mesh(1, backend="gloo", device="cpu")
words = torch.tensor([0b1011, -1], dtype=torch.int32)
hi, lo = distributed.make_q6_step(mesh)(
    words, words, words, torch.arange(64), torch.full((64,), 2),
    torch.ones(64, dtype=torch.bool))
assert (int(hi), int(lo)) == (0, 2 * (0 + 1 + 3 + sum(range(32, 64))))
on_mesh = api.connect(sf=0.01, device="cpu", mesh=mesh)
assert on_mesh.catalog.table("lineitem").sharded
assert on_mesh.sql(SQL[6]).strings() == rows, on_mesh.sql(SQL[6]).strings()
dist.destroy_process_group()
for m in ("sql.statements", "storage.dml", "tpch.sql_queries",
          "testing.sqllogic", "tpch.answers", "ops.window",
          "storage.persist", "exec.pyverify", "exec.profiler", "shell",
          "parallel.mesh", "parallel.exchange", "parallel.distributed",
          "parallel.shard", "parallel.exchange_join"):
    assert "duckdb_cubit_tpu_torch." + m in sys.modules, m
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "duckdb_cubit_tpu"))
print(rows, loaded)
assert rows == [["1193053.2253"]], rows
assert not loaded, loaded
"""


def test_port_runs_q6_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
