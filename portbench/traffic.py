"""The one generator of the benchmark's traffic: a parameter scan.

A workload file's `draws` lists, for each drawn parameter, the interval it
is drawn from uniformly and the parameters tied to it (`tied`: name ->
factor, e.g. the second puncture's momentum as minus the first's). Every
other parameter is the params file's. Solve i of a run takes the i-th
draw of the stream that `--seed` starts; the solves whose outputs the
check keeps are `check.sample` indices drawn below `check.within` from a
second stream of the same seed.
"""

from __future__ import annotations

import numpy as np


class Scan:
    def __init__(self, workload: dict, seed: int):
        self.draws = workload["draws"]
        self._rng = np.random.default_rng(
            np.random.SeedSequence([seed % 2**64, 0]))
        self._made: list = []

    def draw(self, i: int) -> dict:
        """The parameters of solve i (draws are made in order)."""
        while len(self._made) <= i:
            out = {}
            for d in self.draws:
                v = float(self._rng.uniform(d["low"], d["high"]))
                out[d["key"]] = v
                for k, f in d.get("tied", {}).items():
                    out[k] = f * v
            self._made.append(out)
        return self._made[i]


def sample(workload: dict, seed: int) -> list:
    """The indices of the solves whose outputs a run keeps for the check
    (the last solve of the window is kept besides)."""
    chk = workload["check"]
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 1]))
    n = min(chk["sample"], chk["within"])
    return sorted(int(i) for i in rng.choice(chk["within"], n,
                                             replace=False))
