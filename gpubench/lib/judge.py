"""What every job kind's comparison shares: the relative gap of two
readings, the worst reading over the answers checked and the verdict
against a cell's limits.  The numbers themselves are the job kind's
(``jobs/<kind>.py``: ``readings`` and ``control``)."""
from __future__ import annotations

import math


def rel(a, b) -> float:
    """|a - b| / |b|; infinite where either is not finite."""
    a, b = float(a), float(b)
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / abs(b)


def shortfall(got, best) -> float:
    """How far ``got`` falls below ``best``, relative to |best| (0 where it
    does not); infinite where either is not finite."""
    got, best = float(got), float(best)
    if not (math.isfinite(got) and math.isfinite(best)):
        return math.inf
    return max(0.0, (best - got) / abs(best))


def worst(readings: list) -> dict:
    """The largest of each number over the answers checked."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def verdict(readings: dict, limits: dict) -> bool:
    """Every number within its limit (a NaN is not)."""
    return all(readings[k] <= limits[k] for k in limits)
