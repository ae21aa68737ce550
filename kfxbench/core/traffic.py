"""What every traffic generator shares: a mix's parameters, read from
``kfxbench/traffic/<mix>.json``, and the tables its sizes are drawn from.
The mix's ``kind`` names its generator, ``kfxbench/generators/<kind>.py``
(``core/bench.py`` finds it by that name), which makes the inputs from the
seed; a new kind is a new file there.

Every size is drawn from a table of stratified quantiles of the mix's
distribution (``table`` entries at the quantiles (i + 0.5) / n), and the
seed only permutes the table and draws the token ids. So every seed gives
the same set of sizes in another order, and seeds change which requests
come when, not how much work there is. ``Dealer`` deals a table to
clients in rounds of one a client, each round a spread of the whole
table, so that even the few dozen requests of one window carry nearly the
same work for every seed.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import List

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"


def load(name: str, directory: Path = TRAFFIC_DIR) -> dict:
    with open(directory / f"{name}.json") as f:
        return json.load(f)

def seed64(seed: int) -> int:
    """Any whole number as a 63-bit seed."""
    return int(seed) % (1 << 63)


def lognormal_table(spec: dict, n: int) -> np.ndarray:
    """``n`` whole sizes at the stratified quantiles of a log-normal with
    ``median`` and ``sigma``, clipped to [``min``, ``max``]."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    vals = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def uniform_int_table(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole numbers spread evenly over [lo, hi]."""
    return lo + (np.arange(n) * (hi - lo + 1)) // n


def share_table(shares: List[float], n: int) -> np.ndarray:
    """``n`` category indices in the proportions ``shares``."""
    edges = np.cumsum(shares) / float(sum(shares))
    return np.searchsorted(edges, (np.arange(n) + 0.5) / n).astype(np.int64)


class Dealer:
    """Deals a table's entries in rounds of one entry a client. The table
    (``clients`` x R sorted entries) is cut into R interleaved blocks, block
    k holding entries k, k + R, k + 2R, ...: each block spans the whole
    distribution. Round j deals block order[j % R] to the clients in a
    seeded order, so every round, the first (all clients in flight at
    once) included, has nearly the same sizes whatever the seed, and the
    first R rounds together are the table itself."""

    def __init__(self, table: np.ndarray, rng: np.random.Generator,
                 clients: int):
        table = np.sort(table)
        rounds = len(table) // clients
        if rounds < 1 or len(table) % clients:
            raise ValueError(f"a table of {len(table)} does not deal "
                             f"whole rounds to {clients} clients")
        self.blocks = [table[k::rounds] for k in range(rounds)]
        self.order = rng.permutation(rounds)
        self.seats = [rng.permutation(clients) for _ in range(rounds)]

    def __call__(self, client: int, j: int) -> int:
        k = self.order[j % len(self.blocks)]
        return int(self.blocks[k][self.seats[k][client]])
