"""Local (fixed-window) similarity on the SPA -> critical / similar rows.

Sec. III-B: the SPA is partitioned into non-overlapping row windows of
width ``w``.  Within each window rows are compared with the normalized L1
distance; a row whose distance to an earlier *critical* row is at most the
threshold ``s`` becomes *similar* and points at that row (its leader).
The greedy leader scan runs over the static window width only.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = ["LocalSimilarity", "windowed_l1", "local_similarity",
           "num_windows"]


class LocalSimilarity(NamedTuple):
    """is_critical (..., L) bool; leader (..., L) int32 row whose attention
    row this row reuses (``leader[i] == i`` iff critical); dist
    (..., nw, w, w) normalized pairwise distances."""

    is_critical: torch.Tensor
    leader: torch.Tensor
    dist: torch.Tensor


def num_windows(L: int, w: int) -> int:
    return math.ceil(L / w)


def windowed_l1(spa: torch.Tensor, w: int, eps: float = 1e-6) -> torch.Tensor:
    """(..., L, Lk) -> (..., nw, w, w) with
    ``d[i,j] = ||a_i - a_j||_1 / (||a_i||_1 + ||a_j||_1 + eps)``."""
    *lead, L, Lk = spa.shape
    nw = num_windows(L, w)
    pad = nw * w - L
    if pad:
        spa = F.pad(spa, (0, 0, 0, pad))
    xp = spa.reshape(*lead, nw, w, Lk)
    # abs in place: the pairwise difference is the largest intermediate of
    # a plan (O(rows * w * Lk)), and a second copy of it would double peak
    diff = (xp[..., :, None, :] - xp[..., None, :, :]).abs_().sum(-1)
    norm = xp.abs().sum(-1)
    denom = norm[..., :, None] + norm[..., None, :] + eps
    return (diff / denom).to(torch.float32)


def local_similarity(spa: torch.Tensor, w: int, s: float,
                     valid_len: Optional[int] = None) -> LocalSimilarity:
    """Greedy leader clustering within fixed windows.

    Row 0 of each window is critical; each later row joins the *first*
    earlier critical row of its window within distance ``s``, else it is
    critical itself.  Rows at or past ``valid_len`` are non-critical with
    ``leader = row index`` and never lead.
    """
    *lead, L, _ = spa.shape
    if valid_len is None:
        valid_len = L
    nw = num_windows(L, w)
    d = windowed_l1(spa, w)                                   # (..., nw, w, w)
    row_ids = torch.arange(nw * w, dtype=torch.int32,
                           device=spa.device).reshape(nw, w)
    valid = (row_ids < valid_len).expand(*lead, nw, w)

    is_crit = [None] * w
    leader_off = [None] * w
    is_crit[0] = valid[..., 0]
    leader_off[0] = torch.zeros(valid.shape[:-1], dtype=torch.int32,
                                device=spa.device)
    for j in range(1, w):
        elig = torch.stack([is_crit[i] & (d[..., i, j] <= s)
                            for i in range(j)], dim=-1)
        found = elig.any(-1)
        # argmax of the first True (torch returns the first maximum)
        first = elig.to(torch.int32).argmax(-1).to(torch.int32)
        vj = valid[..., j]
        is_crit[j] = vj & ~found
        leader_off[j] = torch.where(vj & found, first,
                                    torch.full_like(first, j))

    crit = torch.stack(is_crit, dim=-1)
    loff = torch.stack(leader_off, dim=-1)
    base = (torch.arange(nw, dtype=torch.int32, device=spa.device) * w)[:, None]
    leader = (loff + base).reshape(*lead, nw * w)[..., :L]
    crit = crit.reshape(*lead, nw * w)[..., :L]
    leader = torch.clamp(leader, max=L - 1)
    return LocalSimilarity(is_critical=crit, leader=leader, dist=d)
