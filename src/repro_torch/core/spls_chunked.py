"""Progressive (row-chunked) SPLS plan construction.

The accelerator never materializes the full Predicted Attention Matrix:
its *progressive generation scheme* (Sec. IV-C) predicts Q, attention and
similarity one local window at a time.  The serving planner follows it:
each prefill chunk (a multiple of the similarity window ``w``) emits one
:class:`ChunkPlanBlock` against every column seen so far -- its intra-row
top-k mask, its per-window critical/leader structure, its OR into the K/V
column-keep vote, and its MFI votes for FFN sparsity.

:func:`chunked_plan_scan` drives the same block over a whole long
sequence and keeps only the plan-lite fields (:class:`ChunkedPlan`, no
O(L^2) mask): its peak is O(row_block * L) per head.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.loops import scan
from repro_torch.observability.trace import phase
from repro_torch.sharding.logical import (arange_like, from_local,
                                         head_placements, is_dtensor)

from .mfi import mfi_ffn_sparsity
from .predict import head_scores
from .similarity import local_similarity
from .topk import topk_count

__all__ = ["CAUSAL_FILL", "ChunkedPlan", "ChunkPlanBlock", "plan_chunk",
           "plan_chunk_votes", "bisect_topk_mask", "chunked_plan_scan",
           "votes_from_kv_any"]

# Causal / invalid-column fill for PAM blocks.  Must round-trip bfloat16
# (bf16 max is ~3.39e38) and sit far below any real predicted score so the
# bisection's lo-init can exclude it with a simple `< -1e29` test.
CAUSAL_FILL = -3e38


def bisect_topk_mask(pam32: torch.Tensor, k, n_iters: int = 12
                     ) -> torch.Tensor:
    """Threshold-based row-wise top-k via bisection on the last axis.

    ``n_iters`` halvings pin the k-th value to ``range / 2^n_iters``; a few
    tie entries more or less are harmless for column-keep and similarity.
    Fill entries (``< -1e29``, e.g. :data:`CAUSAL_FILL`) never pass the
    threshold and are excluded from the lo-init.
    """
    hi = pam32.amax(-1, keepdim=True)
    # the range must span only *valid* entries: the fill value would
    # otherwise eat every bisection step
    lo = torch.where(pam32 < -1e29, hi, pam32).amin(-1, keepdim=True)

    def halve(lo_hi, _):
        lo, hi = lo_hi
        mid = 0.5 * (lo + hi)
        cnt = (pam32 >= mid).sum(-1, keepdim=True)
        return (torch.where(cnt >= k, mid, lo),
                torch.where(cnt >= k, hi, mid)), None

    (lo, _), _ = scan(halve, (lo, hi), n_iters)
    return pam32 >= lo


class ChunkPlanBlock(NamedTuple):
    """Plan for one row block of the PAM over ``S`` column slots; leading
    dims ``(B, KV, G)``, ``C`` rows."""

    mask: torch.Tensor          # (B, KV, G, C, S) bool intra-row SPA mask
    q_critical: torch.Tensor    # (B, KV, G, C) bool
    q_leader: torch.Tensor      # (B, KV, G, C) int32 *global* row ids
    kv_any: torch.Tensor        # (B, KV, G, S) bool: this block's column OR
    ffn_critical: torch.Tensor  # (B, C) bool
    ffn_leader: torch.Tensor    # (B, C) int32 global row ids


def _block_pam_mask(qh_blk: torch.Tensor, kh: torch.Tensor, *, k, row0,
                    n_valid_rows, n_cols, causal: bool,
                    scale: Optional[float]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PAM block -> top-k mask.  Returns ``(mask (B,KV,G,C,S), pam32)``.

    The PAM is computed in float32, rounded to bfloat16 (the prediction is
    already 8-bit math; the reference stores the block in bf16) and widened
    again, so both packages threshold the same values.  The bisection is
    the phase ``spls.topk`` of a serving engine's trace.
    """
    Dh = qh_blk.shape[-1]
    C = qh_blk.shape[-2]
    S = kh.shape[-2]
    scale = scale if scale is not None else Dh ** -0.5
    pam = (head_scores(qh_blk, kh) * scale).to(torch.bfloat16)
    qi = row0 + arange_like(qh_blk, C)
    kj = arange_like(qh_blk, S)
    cmask = (kj[None, :] < n_cols).expand(C, S)
    if causal:
        cmask = cmask & (kj[None, :] <= qi[:, None])
    pam = pam.masked_fill(~cmask, CAUSAL_FILL)
    pam32 = pam.to(torch.float32)
    valid_rows = arange_like(qh_blk, C) < n_valid_rows
    with phase("spls.topk"):
        mask = bisect_topk_mask(pam32, k)
    mask = mask & cmask & valid_rows[:, None]
    return mask, pam32


def plan_chunk_votes(qh_blk: torch.Tensor, kh: torch.Tensor, *, k, row0,
                     n_valid_rows, n_cols, causal: bool = True,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Column-keep contribution only: ``(B, KV, G, S)`` bool.  The page-
    prune vote needs just the zero-column detection, so the similarity
    stage (the largest intermediate of a full block) is skipped."""
    mask, _ = _block_pam_mask(qh_blk, kh, k=k, row0=row0,
                              n_valid_rows=n_valid_rows, n_cols=n_cols,
                              causal=causal, scale=scale)
    return mask.any(dim=-2)


def plan_chunk(qh_blk: torch.Tensor, kh: torch.Tensor, *, k, row0,
               n_valid_rows, n_cols, s_threshold: float, window: int,
               f_threshold: int, causal: bool = True,
               scale: Optional[float] = None) -> ChunkPlanBlock:
    """SPLS plan for a single row block -- the progressive-generation unit.

    qh_blk: (B, KV, G, C, Dh) predicted q heads for rows ``row0 ..
    row0+C``; kh: (B, KV, S, Dh) predicted k heads for every column slot
    seen so far.  ``row0`` and C must be window multiples, so similarity
    windows are exactly those of an unchunked pass.  Padded rows are never
    critical and never lead; padded/future columns are filled with
    :data:`CAUSAL_FILL` and never voted for.
    """
    B, KVp, Gp, C, Dh = qh_blk.shape

    def per_head(qh_blk, kh):
        mask, pam32 = _block_pam_mask(qh_blk, kh, k=k, row0=row0,
                                      n_valid_rows=n_valid_rows,
                                      n_cols=n_cols, causal=causal,
                                      scale=scale)
        spa = torch.where(mask, pam32, torch.zeros_like(pam32))
        sim = local_similarity(spa, window, s_threshold,
                               valid_len=n_valid_rows)
        return mask, sim.is_critical, sim.leader, mask.any(dim=-2)

    if is_dtensor(qh_blk):
        # every stage but MFI is local to a (batch, head) row: each device
        # runs it on its own shards (op by op, DTensor would plan each)
        mesh = qh_blk.device_mesh
        head, kv = head_placements(qh_blk)
        outs = per_head(qh_blk.redistribute(mesh, head).to_local(),
                        kh.redistribute(mesh, kv).to_local())
        mask, crit, lead, kv_any = (
            from_local(t, mesh, head, (B, KVp, Gp, *t.shape[3:]))
            for t in outs)
    else:
        mask, crit, lead, kv_any = per_head(qh_blk, kh)
    leaders_h = lead.reshape(B, KVp * Gp, C)        # block-local for MFI
    ffn = mfi_ffn_sparsity(leaders_h, window, f_threshold)
    return ChunkPlanBlock(mask=mask, q_critical=crit,
                          q_leader=lead + row0,     # block-local -> global
                          kv_any=kv_any, ffn_critical=ffn.is_critical,
                          ffn_leader=ffn.leader + row0)


def votes_from_kv_any(kv_any: torch.Tensor) -> torch.Tensor:
    """(B, KV, G, S) per-head column-keep bools -> (S,) head-vote counts
    (of batch row 0).  The cross-chunk accumulator is an OR per head, after
    which the vote is the head count."""
    B, S = kv_any.shape[0], kv_any.shape[-1]
    return kv_any.reshape(B, -1, S).sum(dim=1).to(torch.int32)[0]


class ChunkedPlan(NamedTuple):
    """Plan-lite for long-sequence execution (no O(L^2) mask); leading
    head dims ``(B, KV, G)`` match the attention layout."""

    q_critical: torch.Tensor    # (B, KV, G, L) bool
    q_leader: torch.Tensor      # (B, KV, G, L) int32
    kv_keep: torch.Tensor       # (B, KV, G, L) bool
    ffn_critical: torch.Tensor  # (B, L) bool
    ffn_leader: torch.Tensor    # (B, L) int32


def chunked_plan_scan(qh: torch.Tensor, kh: torch.Tensor, *, k_ratio: float,
                      s_threshold: float, window: int, f_threshold: int,
                      row_block: int = 512, causal: bool = True,
                      scale: Optional[float] = None) -> ChunkedPlan:
    """Build the plan from predicted (already quantized) heads ``qh (B,
    KV, G, L, Dh)`` / ``kh (B, KV, L, Dh)``, one row block of the PAM at a
    time; peak memory O(row_block * L) per head instead of O(L^2).

    Each step is one :func:`plan_chunk` -- the primitive the streaming
    step and the progressive plan share -- and only its plan-lite fields
    leave the loop; the K/V keep mask carries across blocks as an OR.  MFI
    is window-local and row blocks are window multiples, so the per-block
    FFN structure concatenates into exactly the whole-sequence vote.
    """
    B, KVp, Gp, L, Dh = qh.shape
    if L % row_block or row_block % window:
        raise ValueError(f"L ({L}) must be a multiple of row_block "
                         f"({row_block}), and row_block of the window "
                         f"({window})")
    k = topk_count(L, k_ratio)

    def block(kv_keep, i):
        r0 = i * row_block
        pb = plan_chunk(qh[..., r0:r0 + row_block, :], kh, k=k, row0=r0,
                        n_valid_rows=row_block, n_cols=L,
                        s_threshold=s_threshold, window=window,
                        f_threshold=f_threshold, causal=causal, scale=scale)
        return kv_keep | pb.kv_any, (pb.q_critical, pb.q_leader,
                                     pb.ffn_critical, pb.ffn_leader)

    kv_keep, ys = scan(block, torch.zeros_like(qh[..., 0], dtype=torch.bool),
                       L // row_block)
    crit, lead, fcrit, flead = zip(*ys)
    return ChunkedPlan(q_critical=torch.cat(crit, -1),
                       q_leader=torch.cat(lead, -1), kv_keep=kv_keep,
                       ffn_critical=torch.cat(fcrit, -1),
                       ffn_leader=torch.cat(flead, -1))
