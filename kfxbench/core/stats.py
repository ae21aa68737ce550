"""Tails and window sums over the records a driver returns."""

from __future__ import annotations

import bisect
import math
from typing import List, Sequence, Tuple

# Seconds between two stamps of one delivery at most.
DELIVERY_GAP_S = 0.1


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (an infinite value, a failed
    request, stays infinite)."""
    if not values:
        return math.nan
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def in_window(serve: dict) -> List[dict]:
    """Requests submitted in the window."""
    lo, hi = serve["t_open"], serve["t_close"]
    return [q for q in serve["requests"] if lo <= q["t_submit"] < hi]


def deliveries(serve: dict) -> List[Tuple[float, float, int]]:
    """Every delivery of the run in time order, as (first stamp, last
    stamp, tokens): a token stamped within ``DELIVERY_GAP_S`` of the one
    before belongs to its delivery (the engine hands a decode chunk's
    tokens over in one pass)."""
    stamps = sorted(t for q in serve["requests"] for t in q["times"])
    out: List[List] = []
    for t in stamps:
        if out and t - out[-1][1] <= DELIVERY_GAP_S:
            out[-1][1] = t
            out[-1][2] += 1
        else:
            out.append([t, t, 1])
    return [tuple(d) for d in out]


def delivered_by(serve: dict, t: float) -> float:
    """Tokens delivered by the time ``t``. Where ``t`` falls between two
    deliveries, the later one is credited pro rata over the time from the
    one before, in which its tokens were made; after the last delivery,
    nothing more."""
    stamps = sorted(tt for q in serve["requests"] for tt in q["times"])
    n = bisect.bisect_right(stamps, t)
    ds = deliveries(serve)
    for prev, nxt in zip(ds, ds[1:]):
        if prev[1] <= t < nxt[0]:
            return n + nxt[2] * (t - prev[1]) / (nxt[0] - prev[1])
    return float(n)
