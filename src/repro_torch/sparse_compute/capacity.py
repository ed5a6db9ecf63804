"""Capacity controller: observed critical-row counts -> bucketed static
capacities.

Packed compute runs at a static capacity per chunk, picked from a small
static **bucket set** by an EMA of the observed critical-row counts and
a safety margin: each chunk takes the smallest bucket covering the
margin-scaled estimate, so the packed kernels see a few fixed shapes and
under-capacity chunks degrade gracefully (overflow rows fall back to
their window leader --
:func:`repro_torch.core.sparse_exec.compact_rows`).  A copy of the
reference package's controller; the port keeps its own.

This is the static-shape analogue of the ASIC's dynamic-allocation FIFO
scheduler (Sec. IV-D): load balance comes from the pack, dynamic sizing
from the bucket choice, and "FIFO recovery" is the leader gather.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

__all__ = ["CapacityController", "default_buckets"]


def default_buckets(total: int, align: int = 8) -> Tuple[int, ...]:
    """Quarter-steps of ``total`` aligned up to ``align`` (always includes
    ``total`` itself, so full capacity -- exact numerics -- is reachable)."""
    align = max(1, align)
    up = lambda v: min(total, -(-v // align) * align)
    return tuple(sorted({up(max(1, (total * q) // 4)) for q in (1, 2, 3)}
                        | {total}))


class CapacityController:
    """EMA-tracked critical-row counts bucketed into static capacities.

    ``total`` is the full row count (the chunk size): the first chunk --
    before any observation -- runs at ``total``, i.e. exact, and every
    later chunk at the smallest bucket covering ``ceil(margin * ema)``.
    ``margin`` trades wasted slots against overflow fallbacks.
    """

    def __init__(self, total: int, align: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 margin: float = 1.25, ema: float = 0.5):
        if total < 1:
            raise ValueError(f"capacity total must be >= 1, got {total}")
        self.total = total
        self.buckets = tuple(sorted(
            {min(total, max(1, int(b))) for b in buckets} | {total}
        )) if buckets is not None else default_buckets(total, align)
        self.margin = margin
        self.ema = ema
        self._est: Optional[float] = None
        self.stats = {"observations": 0, "overflows": 0,
                      "picks": {b: 0 for b in self.buckets}}

    def observe(self, n_critical: int) -> None:
        """Record a chunk's observed critical-row count (post-execution).
        Counts above the capacity served are still observed -- that is how
        the estimate recovers after an overflow."""
        n = float(n_critical)
        self._est = n if self._est is None else (
            (1.0 - self.ema) * self._est + self.ema * n)
        self.stats["observations"] += 1

    def note_overflow(self) -> None:
        self.stats["overflows"] += 1

    def capacity(self) -> int:
        """Smallest bucket covering the margin-scaled estimate; ``total``
        (exact) until the first observation."""
        if self._est is None:
            pick = self.total
        else:
            need = min(self.total, max(1, math.ceil(self.margin * self._est)))
            pick = next((b for b in self.buckets if b >= need), self.total)
        self.stats["picks"][pick] = self.stats["picks"].get(pick, 0) + 1
        return pick

    @property
    def overflow_rate(self) -> float:
        """Fraction of observed chunks that overflowed their bucket into
        the window-leader fallback (0.0 before any observation)."""
        obs = self.stats["observations"]
        return self.stats["overflows"] / obs if obs else 0.0

    def snapshot(self) -> dict:
        """Telemetry view: the raw stats plus the live EMA estimate, the
        overflow-fallback rate, and the mean bucket occupancy (picked
        slots actually demanded, weighted by picks)."""
        picks = dict(self.stats["picks"])
        n_picks = sum(picks.values())
        mean_bucket = (sum(b * n for b, n in picks.items()) / n_picks
                       if n_picks else float(self.total))
        return {**self.stats, "picks": picks, "estimate": self._est,
                "overflow_rate": self.overflow_rate,
                "mean_bucket": mean_bucket,
                "occupancy": (self._est / mean_bucket
                              if self._est is not None and mean_bucket
                              else None)}
