"""What the TPC-H cells send, frozen: every statement of the warm-up and of
cycles 0-2, with the label its spans are named by, for both mixes at
SF0.01 on two seeds, and the power mix's query texts at SF1 (the
substitution parameters need no data).  The digests were taken from the
harness before its engine-facing half became a suite; the traffic is
built here as `run.run_cell` builds it."""

import hashlib

import pytest

from tpchbench import run

SEEDS = (2**31 + 17, 3217001701)

FROZEN = {
    "power/2147483665/0.01": "90228e427e831b9d",
    "power/2147483665/1": "bdd51bafa8a10b41",
    "power/3217001701/0.01": "0ee075e413a88986",
    "power/3217001701/1": "e71bd8b09594d0c1",
    # warm-up, cycle 0, cycle 1, cycle 2
    "power-test/2147483665/0.01": ("90228e427e831b9d", "73522d816121bd62",
                                   "1b226c361fa5752f", "c60660f0eff7d9a4"),
    "power-test/3217001701/0.01": ("0ee075e413a88986", "643c6c05d334c8a0",
                                   "795e7150a5a03304", "7382252204279409"),
}
CASES = [(mix, seed, sf) for mix in ("power", "power-test") for seed in SEEDS
         for sf in ((0.01, 1.0) if mix == "power" else (0.01,))]


def digest(steps, label) -> str:
    h = hashlib.sha256()
    for s in steps:
        if s[0] == "query":
            piece = f"query|{label(s[1])}|{s[2]}"
        else:
            piece = f"{s[0]}|{s[1]}|" + "\n".join(s[2])
        h.update(piece.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def _traffic(mix: str, seed: int, sf: float):
    config = run.load_config("tpch-sf1-rf" if mix == "power-test"
                             else "tpch-sf1")
    suite = run.load_suite(config)
    return suite.traffic(config, run.load_mix(mix), suite.scale(config, sf),
                         seed)


@pytest.mark.parametrize("mix,seed,sf", CASES,
                         ids=[f"{m}-{s}-sf{f:g}" for m, s, f in CASES])
def test_the_statements_sent_are_frozen(mix, seed, sf):
    t = _traffic(mix, seed, sf)
    got = tuple(digest(steps, t.label) for steps in
                [t.warmup()] + [t.cycle(c) for c in range(3)])
    want = FROZEN[f"{mix}/{seed}/{sf:g}"]
    if isinstance(want, str):      # one substitution set, no refresh
        want = (want,) * 4
    assert got == want


def test_the_labels_are_the_span_names():
    t = _traffic("power", SEEDS[0], 0.01)
    assert [t.label(n) for n in (1, 6, 22)] == ["q01", "q06", "q22"]
