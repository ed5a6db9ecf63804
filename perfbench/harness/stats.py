"""Window arithmetic shared by the metric readers."""

from __future__ import annotations

import math
from typing import List, Optional


def percentile(values: List[float], p: float) -> float:
    """Linear-interpolated percentile (``p`` in [0, 100]), as
    ``numpy.percentile``'s default method and the program's telemetry
    (``repro_torch.observability.metrics.percentile``) take it; NaN on
    empty."""
    if not values:
        return float("nan")
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    rank = (p / 100.0) * (len(xs) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (rank - lo))


def rate(count: float, seconds: float) -> Optional[float]:
    return count / seconds if count > 0 and seconds > 0 else None


def gaps_in_window(times: List[float], t0: float, t1: float) -> List[float]:
    """Gaps between consecutive events of one stream whose both ends lie
    in ``[t0, t1]``."""
    inside = [t for t in times if t0 <= t <= t1]
    return [b - a for a, b in zip(inside, inside[1:])]
