"""The torch port runs without jax: the machine with the card has none.

A fresh interpreter imports the port's API, runs Q6 at SF0.01 on the CPU,
and must never have loaded jax or the reference package.
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
