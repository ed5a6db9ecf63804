"""Execution of the formal computation under a SPLS plan: packing.

Dynamic row counts become static capacities: critical rows are packed
into a fixed-capacity buffer (stable order, critical first), computed
densely at the reduced size, and read back through the leader map.  With
capacity equal to the row count this is exactly the simulation-mode
semantics (similar rows reuse their leader's output); below it, overflow
rows fall back to their window leader.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["gather_rows", "pack_by_mask", "Compaction", "compact_rows",
           "masked_softmax"]

_NEG = -1e30


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the row axis (-2) with a (..., L) index map whose
    leading dims equal ``x``'s."""
    idx = idx.long()[..., None].expand(*idx.shape, x.shape[-1])
    return torch.gather(x, -2, idx)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, axis=-1)`` with idx broadcast to x's
    leading dims."""
    lead = torch.broadcast_shapes(x.shape[:-1], idx.shape[:-1])
    return torch.gather(x.expand(*lead, x.shape[-1]), -1,
                        idx.long().expand(*lead, idx.shape[-1]))


def _pack_order(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable critical-first pack order of ``mask`` (..., L): ``order``
    lists True rows in index order then False rows; ``order_pos[row]`` is
    the unclamped slot each row would occupy."""
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    order_pos = torch.argsort(order, dim=-1, stable=True)
    return order.to(torch.int32), order_pos.to(torch.int32)


def pack_by_mask(mask: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack True positions of ``mask`` (..., L) first, truncated to
    capacity.  Returns ``perm (..., C)`` source row per packed slot and
    ``slot_of (..., L)`` the packed slot of each source row, clamped into
    [0, C)."""
    L = mask.shape[-1]
    C = min(capacity, L)
    order, order_pos = _pack_order(mask)
    return order[..., :C], torch.clamp(order_pos, max=C - 1)


class Compaction(NamedTuple):
    """Static-capacity packing of critical rows: ``perm`` names the source
    row each packed slot computes, ``src_slot`` the packed slot each output
    row reads (leader indirection resolved, overflow redirected to the
    window leader)."""

    perm: torch.Tensor        # (..., C) int32
    src_slot: torch.Tensor    # (..., *extra, L) int32
    n_critical: torch.Tensor  # (...,) int32


def _window_leader(crit: torch.Tensor, window: int) -> torch.Tensor:
    """(..., L) index of the first critical row in each row's window
    (``L`` where a window has none -- callers must guard)."""
    L = crit.shape[-1]
    ids = torch.arange(L, dtype=torch.int32, device=crit.device)
    cand = torch.where(crit, ids, torch.full_like(ids, L))
    pad = (-L) % window
    if pad:
        cand = F.pad(cand, (0, pad), value=L)
    nw = cand.shape[-1] // window
    wmin = cand.reshape(*cand.shape[:-1], nw, window).amin(-1)
    return wmin[..., (ids // window).long()]


def compact_rows(crit: torch.Tensor, capacity: int,
                 leader: Optional[torch.Tensor] = None,
                 window: Optional[int] = None) -> Compaction:
    """Turn a critical-row mask (+ leader map) into a :class:`Compaction`.

    crit: (..., L) bool; leader: (..., *extra, L) int32 row each output row
    recovers from (extra axes broadcast against ``crit``'s); ``None``
    means every row reads itself.  A row whose leader did not fit the
    capacity reads its leader's **window leader** (the first critical row
    of that window) when ``window`` is given and that row is packed; the
    last packed slot is the final fallback.
    """
    L = crit.shape[-1]
    C = min(capacity, L)
    order, order_pos = _pack_order(crit)
    perm = order[..., :C]
    target = leader if leader is not None else torch.arange(
        L, dtype=torch.int32, device=crit.device).expand(crit.shape)
    extra = target.dim() - crit.dim()
    op = order_pos.reshape(order_pos.shape[:-1] + (1,) * extra + (L,))
    op = op.expand(target.shape[:-1] + (L,))
    if window is not None:
        wl = _window_leader(crit, window)
        wl = wl.reshape(wl.shape[:-1] + (1,) * extra + (L,)).expand(op.shape)
        wlt = _take(wl, target)
        wls = torch.clamp(wlt, max=L - 1)
        overflow = _take(op, target) >= C
        fb_ok = (wlt < L) & (_take(op, wls) < C)
        target = torch.where(overflow & fb_ok, wls, target)
    src_slot = torch.clamp(_take(op, target), max=C - 1)
    return Compaction(perm=perm, src_slot=src_slot.to(torch.int32),
                      n_critical=crit.sum(-1).to(torch.int32))


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the mask's True entries; all-masked rows give zeros."""
    scores = scores.masked_fill(~mask, _NEG)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m) * mask.to(scores.dtype)
    return e / (e.sum(-1, keepdim=True) + 1e-9)
