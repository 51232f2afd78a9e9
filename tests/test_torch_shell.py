"""The port's SQL shell (`python -m duckdb_cubit_tpu_torch.shell`) driven
through stdin on the CPU, against the JAX package: the counterpart of
`tools/shell.py`.  Timing is switched off first, so the output is
deterministic; rows must equal the reference's `connect(0.01)` rows and
messages the reference's."""

import os
import subprocess
import sys

import pytest

from duckdb_cubit_tpu.api import connect as ref_connect

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SELECT = ("SELECT l_returnflag, l_linestatus, count(*) AS c,\n"
          "       sum(l_quantity) AS q\n"
          "  FROM lineitem WHERE l_shipdate <= CAST('1998-09-02' AS date)\n"
          " GROUP BY l_returnflag, l_linestatus\n"
          " ORDER BY l_returnflag, l_linestatus;")
BAD = "SELECT nope FROM lineitem;"


def shell(stdin: str, *args) -> list[str]:
    """Run the shell on the CPU; -> its output lines with the prompts
    taken off."""
    proc = subprocess.run(
        [sys.executable, "-m", "duckdb_cubit_tpu_torch.shell",
         "--device", "cpu", *args], input=stdin, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = []
    for line in proc.stdout.splitlines():
        while line.startswith(("sql> ", "...> ")):
            line = line[5:]
        lines.append(line)
    return lines


def table(rows) -> list[str]:
    return [" | ".join(r) for r in rows] + [f"({len(rows)} rows)"]


def _after(session, n):
    """The lines between the n-th and (n+1)-th markers."""
    idx = [i for i, line in enumerate(session)
           if line == "unknown command \\mark"]
    return session[idx[n] + 1:idx[n + 1]]


@pytest.fixture(scope="module")
def ref():
    return ref_connect(sf=0.01)


@pytest.fixture(scope="module")
def session():
    """One SF0.01 session.  Each command follows a marker, the unknown
    command `\\mark`, whose message delimits that command's output."""
    stdin = "\n".join([
        "\\timing", "\\mark d", "\\d", "\\mark tpch", "\\tpch 6",
        "\\mark select", SELECT, "\\mark explain",
        "\\explain SELECT count(*) AS c FROM nation", "\\mark bad", BAD,
        "\\mark end", "\\q", "SELECT 1;"]) + "\n"
    return shell(stdin, "--sf", "0.01")


def test_timing_off_and_load(session):
    assert session[0].startswith("duckdb_cubit_tpu_torch shell")
    assert session[1].startswith("TPC-H sf0.01 loaded in ")
    assert session[2] == "timing off"


def test_tables(session, ref):
    want = [f"{name:12} {t.num_rows:>12} rows  indexes: "
            f"{','.join(t.indexes) or '-'}"
            for name, t in ref.catalog.tables.items()]
    assert len(want) == 8
    assert _after(session, 0) == want


def test_tpch_query_rows(session, ref):
    assert _after(session, 1) == table(ref.tpch_query(6).strings())


def test_multi_line_select(session, ref):
    assert _after(session, 2) == table(ref.sql(SELECT.rstrip(";")).strings())


def test_explain_prints_a_plan(session):
    plan = _after(session, 3)
    assert plan[0] == "project" and "table_scan(nation" in "\n".join(plan)
    assert any(line.startswith("-- pipelines") for line in plan)


def test_messages_are_the_reference_ones(session, ref):
    with pytest.raises(Exception) as e:
        ref.sql(BAD.rstrip(";"))
    assert _after(session, 4) == [f"error: {e.value}"]
    # `\q` ends the session: the statement after it never runs
    assert session[-2:] == ["unknown command \\mark", ""]


def test_session_without_a_catalog():
    out = shell("\\timing\nCREATE TABLE t (k INTEGER, s VARCHAR);\n"
                "INSERT INTO t VALUES\n  (1, 'a'), (2, NULL);\n"
                "SELECT k, s FROM t ORDER BY k;\n")
    assert out[1:] == ["timing off", "CREATE TABLE t",
                       "INSERT 2 (first rowid 0)", "1 | a", "2 | NULL",
                       "(2 rows)", ""]
