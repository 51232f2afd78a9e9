"""The control and the faults: each must come out as not correct.

The control is the reference computed one precision below the
configuration's (DECIMAL in float64 dollars, DOUBLE in float32) in the
engine's place.  The faults break the timed path underneath a run on the
CPU at SF0.01: an answer altered where it is produced, half of each answer
left out, and refresh functions that leave the state unchanged."""

import pytest

from tpchbench import control, run

SF = 0.01


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
@pytest.mark.parametrize("cell", ["tpch-sf1.power", "tpch-sf1-rf.power-test"])
def test_control_fails(cell, seed):
    r = control.readings(cell, seed, sf=SF)
    assert r["fails_limits"], r


def _run(cell, seed=2**31 + 41):
    res, _ = run.run_cell(run.load_benchmark(), cell, seed, 0.3, False,
                          device="cpu", sf=SF)
    return res


def test_an_answer_altered(monkeypatch):
    from duckdb_cubit_tpu_torch import api
    strings = api.Result.strings

    def altered(self):
        rows = strings(self)
        if rows and rows[0]:
            c = rows[0][-1]
            try:
                rows[0][-1] = repr(float(c) * (1 + 1e-6) + 1e-6)
            except ValueError:
                rows[0][-1] = c + "x"
        return rows

    monkeypatch.setattr(api.Result, "strings", altered)
    res = _run("tpch-sf1.power")
    assert res["correct"] is False
    assert (res["compared"]["wrong_cells"]["value"] > 1
            or res["compared"]["double_gap"]["value"] > 1e-9)


def test_half_of_each_answer_left_out(monkeypatch):
    from duckdb_cubit_tpu_torch import api
    strings = api.Result.strings
    monkeypatch.setattr(api.Result, "strings",
                        lambda self: strings(self)[: (len(strings(self))
                                                      + 1) // 2])
    res = _run("tpch-sf1.power")
    assert res["correct"] is False
    assert res["compared"]["wrong_cells"]["value"] > 1


def test_refresh_leaves_the_state_unchanged(monkeypatch):
    """INSERT and DELETE report rows but change nothing."""
    from duckdb_cubit_tpu_torch import api
    sql = api.Connection.sql

    def unchanged(self, query, profile=False):
        head = query.lstrip()[:6].upper()
        if head == "INSERT":
            return api.Result(None, status=f"INSERT {query.count('), (') + 1}")
        if head == "DELETE":
            keys = query[query.index("IN (") + 4:].count(",") + 1
            return api.Result(None, status=f"DELETE {keys}")
        return sql(self, query, profile)

    monkeypatch.setattr(api.Connection, "sql", unchanged)
    res = _run("tpch-sf1-rf.power-test")
    assert res["correct"] is False
    assert res["compared"]["wrong_cells"]["value"] > 1
