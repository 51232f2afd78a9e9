"""A whole run of each cell on the CPU at SF0.01: the cell assembled from
its files by name, the traffic, the window, the reference and the last
line; and the run's refusals (no card, no engine)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from tpchbench import generator, run
from tpchbench.reference import queries
from tpchbench.reference.db import Database

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["tpch-sf1.power", "tpch-sf1-rf.power-test"]
REHEARSE = ("import json, sys\n"
            "from tpchbench import run\n"
            "res, rec = run.run_cell(run.load_benchmark(), sys.argv[1], "
            "int(sys.argv[2]), 0.5, bool(int(sys.argv[3])), device='cpu', "
            "sf=0.01)\n"
            "print(json.dumps(res))\n")


def _known_divergences(cell, seed):
    """Answers where the engine gives no row and SQL one row of NULLs (an
    aggregate without GROUP BY over no rows; ROADMAP queue 3)."""
    from tpchbench import datagen
    c = run.find(run.load_benchmark()["workloads"], cell, "workload")
    traffic = generator.Traffic(generator.load_mix(c["traffic"]), 0.01, seed)
    db = Database(datagen.base_tables(0.01))
    if traffic.refresh:
        db.insert(*datagen.update_set(0.01, traffic.update_set(0)))
    return sum(queries.answer(n, db, traffic.params(0)[n]).rows == [["NULL"]]
               for n in traffic.order)


@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_on_the_cpu(cell, traced):
    seed = 2**31 + 17
    # a process of its own: the refresh cell changes the engine's catalog,
    # which `connect` shares within a process
    p = subprocess.run([sys.executable, "-c", REHEARSE, cell, str(seed),
                        str(traced)], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "compared"
    assert res["failed"] == 0 and res["attempted"] >= 22
    bench = run.load_benchmark()
    want = {m["name"] for m in run.metrics_for(bench, cell, bool(traced))}
    got = set(res["metrics"])
    assert got <= want
    # a CPU run never writes a device metric
    device_metrics = {m["name"] for m in bench["per_layer"] + bench[
        "end_to_end"] if m["source"] == "device_trace"}
    assert not got & device_metrics
    assert res["device"]["platform"] == "cpu"
    if not traced:
        assert got == want
    known = _known_divergences(cell, seed)
    assert res["compared"]["wrong_cells"]["value"] == known
    assert res["compared"]["double_gap"]["value"] <= 1e-12
    assert res["correct"] == (known == 0)
    # the numbers compared close standard error, each beside its limit
    tail = p.stderr.strip().splitlines()[-2:]
    assert tail[0].startswith("wrong_cells ") and " limit " in tail[0]
    assert tail[1].startswith("double_gap ") and " limit " in tail[1]


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "tpchbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_run_refuses_without_the_engine(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "tpchbench"), tmp_path / "tpchbench",
                    ignore=shutil.ignore_patterns("_cache", "_build",
                                                  "__pycache__"))
    for argv in ([sys.executable, "-m", "tpchbench.run", "--workload",
                  CELLS[0], "--seed", "1", "--seconds", "1"],
                 [sys.executable, "-c", REHEARSE, CELLS[0], "1", "0"]):
        p = subprocess.run(argv, cwd=tmp_path, capture_output=True,
                           text=True, timeout=300,
                           env={**os.environ, "PYTHONPATH": ""})
        assert p.returncode != 0
        assert "{" not in p.stdout


def test_a_cell_is_found_by_its_names_alone(tmp_path):
    """Every piece of a cell comes from a file named in BENCHMARK.json."""
    bench = run.load_benchmark()
    for cell in bench["workloads"]:
        cfg = run.load_config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert any(c["file"] == f"tpchbench/configs/{cell['config']}.json"
                   for c in bench["configs"])
        generator.load_mix(cell["traffic"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(run.load_reader(m["name"]))
