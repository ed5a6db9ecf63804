"""Execution of the formal computation under a SPLS plan.

* **simulation** -- dense math with gather/mask semantics: similar rows
  reuse their leader's attention / FFN output, pruned K/V columns get no
  probability mass (:func:`spls_attention`, :func:`spls_ffn`).
* **capacity** -- dynamic row counts become static capacities: critical
  rows are packed into a fixed-capacity buffer (stable order, critical
  first), computed densely at the reduced size, and read back through the
  leader map (:func:`pack_by_mask`, :func:`unpack_by_leader`,
  :func:`compact_rows`, :func:`spls_attention_packed`,
  :func:`spls_attention_chunked`, :func:`spls_ffn_packed`).  With
  capacity equal to the row count this is the simulation-mode row
  semantics; below it, overflow rows fall back to their window leader.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.loops import scan

from .spls import SparsityPlan

__all__ = ["gather_rows", "pack_by_mask", "unpack_by_leader", "Compaction",
           "compact_rows", "masked_softmax", "spls_attention",
           "spls_attention_packed", "spls_attention_chunked", "spls_ffn",
           "spls_ffn_packed"]

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


def unpack_by_leader(packed: torch.Tensor, slot_of: torch.Tensor,
                     leader: torch.Tensor) -> torch.Tensor:
    """Scatter packed rows back to full length through the leader map:
    ``out[row] = packed[slot_of[leader[row]]]``."""
    return gather_rows(packed, torch.gather(slot_of, -1, leader.long()))


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


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return s if cap is None else torch.tanh(s / cap) * cap


def spls_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   plan: SparsityPlan, scale: Optional[float] = None,
                   softcap: Optional[float] = None) -> torch.Tensor:
    """Simulation-mode sparse attention; q, k, v share their leading dims
    with the plan's (``(B, KV, G, L, Dh)``).  A similar row's output is its
    leader's (both the Q vector and the SPA mask row are the leader's);
    pruned K/V columns receive no probability mass."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    L = plan.attn_mask.shape[-1]
    lead = plan.q_leader.long()
    q_eff = gather_rows(q, lead)
    mask_eff = torch.gather(plan.attn_mask, -2,
                            lead[..., None].expand(*lead.shape, L))
    s = _softcap(torch.matmul(q_eff, k.transpose(-1, -2)) * scale, softcap)
    return torch.matmul(masked_softmax(s, mask_eff), v)


def spls_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          plan: SparsityPlan, q_capacity: int,
                          kv_capacity: int, scale: Optional[float] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Capacity-mode sparse attention; q, k, v share their leading dims
    with the plan's.  Critical Q rows are packed to ``q_capacity`` and
    kept K/V columns to ``kv_capacity`` per (batch, head); a (Cq x Ckv)
    masked softmax runs on the packed rows, whose outputs are scattered
    back through the leader map.  Rows past the capacity read the last
    packed slot (:func:`pack_by_mask`).  Differentiable: every gather's
    backward accumulates over repeated indices."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    q_perm, q_slot = pack_by_mask(plan.q_critical, q_capacity)
    kv_perm, _ = pack_by_mask(plan.kv_keep, kv_capacity)
    qp = gather_rows(q, q_perm)
    kp = gather_rows(k, kv_perm)
    vp = gather_rows(v, kv_perm)
    # packed mask: rows by q_perm, columns by kv_perm; slots past the kv
    # keep count stay dead even where mask bits are set
    L = plan.attn_mask.shape[-1]
    qi = q_perm.long()
    mrows = torch.gather(plan.attn_mask, -2,
                         qi[..., None].expand(*qi.shape, L))
    mp = _take(mrows, kv_perm[..., None, :])
    kv_alive = torch.gather(plan.kv_keep, -1, kv_perm.long())
    mp = mp & kv_alive[..., None, :]
    s = _softcap(torch.matmul(qp, kp.transpose(-1, -2)) * scale, softcap)
    op = torch.matmul(masked_softmax(s, mp), vp)
    return unpack_by_leader(op, q_slot, plan.q_leader)


def spls_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           plan, q_capacity: int, kv_capacity: int,
                           scale: Optional[float] = None,
                           softcap: Optional[float] = None,
                           kv_chunk: int = 2048, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """Capacity-mode sparse attention with an online softmax over packed
    KV chunks.  q: (B, KV, G, L, Dh); k / v: (B, KV, L, Dh).  Critical Q
    rows and surviving K/V columns are packed to static capacities; the
    packed positions carry their original ids, so the causal and window
    masks are index based.  No intra-row top-k mask: row and column
    sparsity are what a tiled kernel realizes, which makes this the oracle
    of the flash backends under a plan."""
    B, KVp, Gp, L, Dh = q.shape
    scale = scale if scale is not None else Dh ** -0.5
    Cq, Ck = min(q_capacity, L), min(kv_capacity, L)
    kv_chunk = min(kv_chunk, Ck)
    q_perm, q_slot = pack_by_mask(plan.q_critical, Cq)
    kv_perm, _ = pack_by_mask(plan.kv_keep, Ck)
    qp = gather_rows(q, q_perm)                              # (B,K,G,Cq,D)
    kr = k[:, :, None].expand(B, KVp, Gp, L, Dh)
    vr = v[:, :, None].expand(B, KVp, Gp, L, Dh)
    kp = gather_rows(kr, kv_perm)                            # (B,K,G,Ck,D)
    vp = gather_rows(vr, kv_perm)
    kv_alive = torch.gather(plan.kv_keep, -1, kv_perm.long())
    pad = (-Ck) % kv_chunk
    if pad:   # ragged capacity: dead padded columns keep the chunk grid
        kp = F.pad(kp, (0, 0, 0, pad))
        vp = F.pad(vp, (0, 0, 0, pad))
        kv_perm = F.pad(kv_perm, (0, pad))
        kv_alive = F.pad(kv_alive, (0, pad))
        Ck += pad
    qi = q_perm[..., :, None]
    # made like the packed rows, so that DTensor rows lay them out alike
    m_run = torch.full_like(qp[..., 0], _NEG, dtype=torch.float32)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros_like(qp, dtype=torch.float32)

    def chunk(run, j):
        m_run, l_run, acc = run
        c0 = j * kv_chunk
        k_c, v_c = kp[..., c0:c0 + kv_chunk, :], vp[..., c0:c0 + kv_chunk, :]
        id_c = kv_perm[..., None, c0:c0 + kv_chunk]
        s = torch.matmul(qp, k_c.transpose(-1, -2)).float() * scale
        s = _softcap(s, softcap)
        mask = kv_alive[..., None, c0:c0 + kv_chunk]
        if causal:
            mask = mask & (id_c <= qi)
        if window is not None:
            mask = mask & (qi - id_c < window)
            if not causal:
                mask = mask & (id_c - qi < window)
        s = s.masked_fill(~mask, _NEG)
        m_new = torch.maximum(m_run, s.amax(-1))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None]) * mask.float()
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p.to(v_c.dtype),
                                                   v_c).float()
        return (m_new, l_run, acc), None

    (m_run, l_run, acc), _ = scan(chunk, (m_run, l_run, acc), Ck // kv_chunk)
    op = (acc / l_run.clamp(min=1e-9)[..., None]).to(q.dtype)
    return unpack_by_leader(op, q_slot, plan.q_leader)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def spls_ffn(x: torch.Tensor, ffn_fn: Callable[[torch.Tensor], torch.Tensor],
             plan: SparsityPlan) -> torch.Tensor:
    """Simulation-mode sparse FFN: compute dense, recover similar tokens
    from their MFI leader (x: (B, L, D))."""
    return gather_rows(ffn_fn(x), plan.ffn_leader)


def spls_ffn_packed(x: torch.Tensor,
                    ffn_fn: Callable[[torch.Tensor], torch.Tensor],
                    plan: SparsityPlan, capacity: int,
                    window: Optional[int] = None) -> torch.Tensor:
    """Capacity-mode sparse FFN: pack critical tokens, compute, scatter;
    with ``window``, overflow rows read their window leader's output
    (:func:`compact_rows`)."""
    comp = compact_rows(plan.ffn_critical, capacity, leader=plan.ffn_leader,
                        window=window)
    return gather_rows(ffn_fn(gather_rows(x, comp.perm)), comp.src_slot)
