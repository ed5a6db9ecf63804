"""Loops of like iterations, counted by trip count in a dry run.

:func:`scan` is the eager form of ``lax.scan``: ``body(carry, i) ->
(carry, y)`` for ``i = 0 .. n - 1``, every iteration with the same shapes
(only values differ).  It runs every iteration, as a plain loop does --
on the card, on plain tensors, under ``FlopCounterMode``.

Under a trip-counting :class:`~repro_torch.launch.op_analysis.OpAnalysis`
(the dry run's) it runs iteration 0 only and has the analysis count it
``n`` times, as the reference's ``parse_hlo_stats`` counts a ``while``
body times its ``known_trip_count``.  The carry after iteration 0 stands
for the last one (a carry keeps its shapes), and each other iteration's
``y`` is stood in for by empty tensors of its shapes, placements and
dtypes, which the analysis holds as live buffers of their own.  A loop
whose outputs need a gradient runs every iteration there too: a backward
outside the loop would see only the one traced.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.tree import leaves

__all__ = ["scan"]


def _trip_counter():
    """The active trip-counting analysis, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "trip_count", False):
            return mode
    return None


def _needs_grad(tree) -> bool:
    return any(isinstance(t, torch.Tensor) and t.requires_grad
               for t in leaves(tree))


def scan(body: Callable[[Any, int], Tuple[Any, Any]], carry: Any, n: int
         ) -> Tuple[Any, List[Any]]:
    """``(carry, [y_0, .., y_{n-1}])`` of ``n`` iterations of ``body``
    (module docstring)."""
    counter = _trip_counter() if n > 1 else None
    ys = []
    if counter is not None:
        mark = counter.snapshot()
        carry, y = body(carry, 0)
        ys.append(y)
        if not _needs_grad((carry, y)):
            counter.count_again(mark, n - 1)
            ys.extend(counter.stand_in(y) for _ in range(n - 1))
            return carry, ys
    for i in range(len(ys), n):
        carry, y = body(carry, i)
        ys.append(y)
    return carry, ys
