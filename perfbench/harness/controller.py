"""The capacity controller's rule, frozen: observed critical-row counts ->
bucketed static capacities (a copy of ``repro_torch.sparse_compute.
capacity.CapacityController``'s arithmetic).

The reference replays a served prompt at the capacities the program picked
for its chunks; this copy checks those picks by themselves: replayed over
the program's own observations in the order it made them, it has to pick
what the program picked, every time.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence, Tuple


def default_buckets(total: int, align: int = 8) -> Tuple[int, ...]:
    up = lambda v: min(total, -(-v // align) * align)
    return tuple(sorted({up(max(1, (total * q) // 4)) for q in (1, 2, 3)}
                        | {total}))


class Controller:
    def __init__(self, total: int, buckets: Optional[Sequence[int]] = None,
                 margin: float = 1.25, ema: float = 0.5):
        self.total = total
        self.buckets = (tuple(sorted({min(total, max(1, int(b)))
                                      for b in buckets} | {total}))
                        if buckets is not None else default_buckets(total))
        self.margin, self.ema = margin, ema
        self.est: Optional[float] = None

    def observe(self, n: int) -> None:
        n = float(n)
        self.est = n if self.est is None else (
            (1.0 - self.ema) * self.est + self.ema * n)

    def capacity(self) -> int:
        if self.est is None:
            return self.total
        need = min(self.total, max(1, math.ceil(self.margin * self.est)))
        return next((b for b in self.buckets if b >= need), self.total)


def replay_mismatches(events: Iterable[Tuple[str, int]], total: int,
                      buckets=None, margin: float = 1.25) -> int:
    """``events``: one controller's ``("pick", capacity)`` and ``("obs",
    count)`` in the program's order.  Returns how many picks differ from
    the rule's."""
    ctl = Controller(total, buckets, margin)
    bad = 0
    for kind, v in events:
        if kind == "obs":
            ctl.observe(v)
        elif ctl.capacity() != v:
            bad += 1
    return bad
