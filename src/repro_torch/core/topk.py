"""Row-wise top-k pruning of the PAM -> Sparsified Predicted Attention (SPA).

The SPA keeps, for every attention row, only the ``ceil(k_ratio * L)``
largest predicted scores.  It drives the intra-row attention mask, the
inputs of the local-similarity stage (distances are taken on the SPA, not
the dense PAM) and K/V column pruning: columns empty in the SPA are dead.

The exact plan selects the top-k entries by rank (:func:`row_topk_mask`);
the streaming planner by bisection
(:func:`repro_torch.core.spls_chunked.bisect_topk_mask`), which takes
``k`` as a plain number.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.sharding.logical import map_local

__all__ = ["row_topk_mask", "sparsify_pam", "kv_keep_from_mask",
           "topk_count"]


def topk_count(L: int, k_ratio: float) -> int:
    """Number of kept entries per row; at least 1."""
    return max(1, min(L, math.ceil(k_ratio * L)))


def row_topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask keeping exactly ``k`` largest entries of the last axis.

    Ties go to the earlier position, as ``jax.lax.top_k`` breaks them (a
    hardware top-k unit streaming left to right).  ``torch.topk`` promises
    no tie order, so the order comes from a stable descending sort, which
    keeps equal values in index order.
    """
    L = scores.shape[-1]
    if k >= L:
        return torch.ones_like(scores, dtype=torch.bool)

    def keep(s):
        idx = torch.sort(s, dim=-1, descending=True, stable=True).indices
        return torch.zeros_like(s, dtype=torch.bool).scatter_(
            -1, idx[..., :k], True)

    return map_local(keep, scores)


def sparsify_pam(pam: torch.Tensor, k_ratio: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PAM -> (SPA values, boolean keep-mask).  The SPA has the dropped
    entries zeroed: the similarity stage treats "not selected" as exactly
    zero, which is what a hardware SPA buffer holds."""
    mask = row_topk_mask(pam, topk_count(pam.shape[-1], k_ratio))
    return torch.where(mask, pam, torch.zeros_like(pam)), mask


def kv_keep_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """Column-based K/V sparsification (Sec. III-C): a key/value position
    survives iff *any* SPA row references it.  (..., L, L) -> (..., L)."""
    return mask.any(dim=-2)
