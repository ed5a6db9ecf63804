"""Row-wise top-k of the PAM: the per-row kept-entry count.

The streaming planner selects the top-k entries of each PAM row by
bisection (:func:`repro_torch.core.spls_chunked.bisect_topk_mask`), which
takes ``k`` as a plain number; this module keeps the count rule.
"""

from __future__ import annotations

import math

__all__ = ["topk_count"]


def topk_count(L: int, k_ratio: float) -> int:
    """Number of kept entries per row; at least 1."""
    return max(1, min(L, math.ceil(k_ratio * L)))
