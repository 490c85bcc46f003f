"""Window statistics, written here: the program computes none of them.

* ``p95``: the nearest-rank 95th percentile (the ceil(0.95 n)-th
  smallest), over every sample given;
* ``rate``: a count over the whole window's length.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest rank: the smallest value with at least ``q`` of the
    samples at or below it; None for no samples."""
    if not values:
        return None
    xs = sorted(values)
    k = max(1, math.ceil(q * len(xs)))
    return xs[k - 1]


def p95(values: Sequence[float]) -> Optional[float]:
    return percentile(values, 0.95)


def rate(count: float, t0: float, t1: float) -> float:
    if t1 <= t0:
        raise ValueError(f"empty window [{t0}, {t1}]")
    return count / (t1 - t0)
