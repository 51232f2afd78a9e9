"""The one traffic generator: a mix's data file and a seed -> statements.

A mix is `traffic/<name>.json`:

- `order`: the query numbers of one stream, in the order they are sent;
- `substitution_sets`: how many parameter sets the seed draws; stream `c`
  uses set `c mod k`, so 1 repeats one set for the whole window;
- `refresh`: whether each stream is wrapped in RF1 before it and RF2 after
  it (the power test's sequence, clause 5.3.7);
- `first_update_set`: with `refresh`, the range the seed draws the first
  update set from; cycle `c` uses the next ones in turn.

A step is ("query", n, sql) or ("rf1" | "rf2", update set, [statements]).
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import qgen, refresh

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for `seed` (any integer) and an optional sub-stream."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])


class Traffic:
    def __init__(self, mix: dict, sf: float, seed: int):
        self.sf = sf
        rng = seed_rng(seed)
        self.param_sets = [qgen.draw_set(rng, sf)
                           for _ in range(int(mix["substitution_sets"]))]
        self.order = [int(n) for n in mix["order"]]
        self.refresh = bool(mix.get("refresh", False))
        lo, hi = mix.get("first_update_set", [1, 1])
        self.first_set = int(rng.integers(lo, hi + 1))

    def params(self, cycle: int) -> dict:
        return self.param_sets[cycle % len(self.param_sets)]

    def update_set(self, cycle: int) -> int:
        return self.first_set + cycle

    def warmup(self) -> list:
        """Every distinct query text the window sends, once."""
        seen, steps = set(), []
        for c in range(len(self.param_sets)):
            for n in self.order:
                sql = qgen.text(n, self.params(c)[n])
                if sql not in seen:
                    seen.add(sql)
                    steps.append(("query", n, sql))
        return steps

    def cycle(self, c: int) -> list:
        p = self.params(c)
        steps = [("query", n, qgen.text(n, p[n])) for n in self.order]
        if self.refresh:
            u = self.update_set(c)
            steps = ([("rf1", u, refresh.rf1(self.sf, u))] + steps
                     + [("rf2", u, refresh.rf2(self.sf, u))])
        return steps
