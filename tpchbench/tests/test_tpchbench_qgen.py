"""Substitution parameters stay inside TPC-H clause 2.4's domains and are the
same for the same seed."""

import datetime

import numpy as np
import pytest

from tpchbench import generator, qgen

SEEDS = [0, 1, 2**31 + 11, 3 * 2**31 + 5, -7]


def _draws(seed, k=4):
    rng = generator.seed_rng(seed)
    return [qgen.draw_set(rng, 1.0) for _ in range(k)]


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_parameters(seed):
    assert _draws(seed) == _draws(seed)
    t1 = generator.Traffic(generator.load_mix("power"), 1.0, seed)
    t2 = generator.Traffic(generator.load_mix("power"), 1.0, seed)
    assert t1.cycle(0) == t2.cycle(0)


def test_other_seeds_other_parameters():
    assert _draws(1) != _draws(2)


def _month_start(d):
    return d.day == 1


@pytest.mark.parametrize("seed", range(40))
def test_parameters_in_their_domains(seed):
    nations = qgen.dist("nations")
    regions = qgen.dist("regions")
    for p in _draws(seed, 1):
        assert 60 <= p[1]["delta"] <= 120
        assert 1 <= p[2]["size"] <= 50
        assert p[2]["type"] in {"TIN", "NICKEL", "BRASS", "STEEL", "COPPER"}
        assert p[2]["region"] in regions
        assert p[3]["segment"] in qgen.dist("msegmnt")
        assert datetime.date(1995, 3, 1) <= p[3]["date"] <= datetime.date(
            1995, 3, 31)
        for n in (4, 15):
            d = p[n]["date"]
            assert _month_start(d) and datetime.date(1993, 1, 1) <= d <= \
                datetime.date(1997, 10, 1)
        for n in (5, 6, 12, 20):
            d = p[n]["date"]
            assert d.month == 1 and d.day == 1 and 1993 <= d.year <= 1997
        assert 2 <= p[6]["discount"] <= 9 and p[6]["quantity"] in (24, 25)
        assert p[7]["nation1"] != p[7]["nation2"]
        assert {p[7]["nation1"], p[7]["nation2"]} <= set(nations)
        n8 = nations.index(p[8]["nation"])
        assert p[8]["region"] == regions[qgen.NATION_REGION[n8]]
        assert p[8]["type"] in qgen.dist("p_types")
        assert p[9]["color"] in qgen.dist("colors")
        d = p[10]["date"]
        assert _month_start(d) and datetime.date(1993, 2, 1) <= d <= \
            datetime.date(1995, 1, 1)
        assert p[11]["fraction"] == pytest.approx(0.0001)
        assert p[12]["shipmode1"] != p[12]["shipmode2"]
        assert p[13]["word1"] in qgen.Q13_WORD1
        assert p[13]["word2"] in qgen.Q13_WORD2
        d = p[14]["date"]
        assert _month_start(d) and 1993 <= d.year <= 1997
        assert p[16]["brand"][:6] == "Brand#" and all(
            "1" <= ch <= "5" for ch in p[16]["brand"][6:])
        assert len(set(p[16]["sizes"])) == 8 and all(
            1 <= s <= 50 for s in p[16]["sizes"])
        assert p[17]["container"] in qgen.dist("p_cntr")
        assert 312 <= p[18]["quantity"] <= 315
        assert 1 <= p[19]["quantity1"] <= 10
        assert 10 <= p[19]["quantity2"] <= 20
        assert 20 <= p[19]["quantity3"] <= 30
        assert p[20]["nation"] in nations and p[21]["nation"] in nations
        codes = p[22]["codes"]
        assert len(set(codes)) == 7 and all(10 <= int(c) <= 34
                                            for c in codes)


def test_stream_order_is_appendix_a_stream_00():
    assert sorted(qgen.STREAM_00) == list(range(1, 23))
    for mix in ("power", "power-test"):
        assert generator.load_mix(mix)["order"] == qgen.STREAM_00


def test_refresh_cycle_wraps_the_stream():
    t = generator.Traffic(generator.load_mix("power-test"), 0.01, 5)
    steps = t.cycle(0)
    assert steps[0][0] == "rf1" and steps[-1][0] == "rf2"
    assert [s[1] for s in steps[1:-1]] == qgen.STREAM_00
    assert t.cycle(1)[0][1] == steps[0][1] + 1
    assert steps[0][2][0] == "BEGIN" and steps[0][2][-1] == "COMMIT"


def test_update_sets_use_unused_keys_and_delete_base_keys():
    from tpchbench import datagen
    base = datagen.base_tables(0.01)
    okeys = np.asarray(base["orders"]["o_orderkey"])
    for u in (1, 2, 7):
        orders, lines = datagen.update_set(0.01, u)
        assert len(orders["o_orderkey"]) == datagen.set_size(0.01)
        assert not np.isin(orders["o_orderkey"], okeys).any()
        assert np.isin(lines["l_orderkey"], orders["o_orderkey"]).all()
        assert np.isin(datagen.delete_keys(0.01, u), okeys).all()
    a, _ = datagen.update_set(0.01, 1)
    b, _ = datagen.update_set(0.01, 2)
    assert not np.isin(a["o_orderkey"], b["o_orderkey"]).any()
