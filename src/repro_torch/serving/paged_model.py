"""Model execution against the block-pool paged KV cache.

* :func:`paged_decode_step` -- one batched decode tick.  Each layer writes
  the new token's K/V into the slot the block table names (inactive rows
  write to the null page) and attends through the paged-decode backends
  (``torch_paged_decode`` / ``cuda_paged_decode``).
* :func:`paged_prefill_chunk` -- chunked prefill without SPLS: one prompt
  chunk is projected at its original positions, written into freshly
  allocated slots, and attends over every slot written so far (cross-chunk
  causal attention).
* :func:`paged_prefill_chunk_spls` -- one SPLS prompt chunk (the paper's
  progressive generation scheme): the chunk's predicted K heads extend the
  paged predictor cache, the planner emits the chunk's plan block against
  every column seen so far, and the chunk executes either in simulation
  mode (``dense``: every row computed, similar rows read their leader's Q
  and FFN output) or with packed compute -- Q and attention only on the
  cross-head union of critical rows, the FFN only on FFN-critical rows,
  leaders broadcasting to their followers, and under ``vote_horizon == 1``
  K/V only for the columns the chunk's own vote keeps.
* :func:`compact_slots` -- the end-of-prefill prune compaction.
* :func:`scatter_prefill` -- a whole-prompt prefill's kept KV columns
  into pages.

Where the reference threads caches through pure functions and donates the
old buffers, these functions update the page pool, the predictor cache and
``pos_pages`` **in place** (index assignment into views of the stacked
tensors) and return only what is new.  The engine owns the host-side pool
bookkeeping.  The chunk steps' attention (a gather of the sequence's pages
and dense masked scores) is plain PyTorch, as it is plain XLA in the
reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.planner import (PlanContext, own_column_keep,
                                     pack_within_capacity)
from repro_torch.core.sparse_exec import (compact_rows, gather_rows,
                                          masked_softmax, pack_by_mask)
from repro_torch.models.attention import output_proj, project_kv, \
    project_qkv
from repro_torch.models.attn_backend import get_backend, \
    resolve_paged_backend
from repro_torch.models.common import dtype_of, rms_norm, softcap
from repro_torch.models.model import embed_inputs, head_logits, \
    period_params
from repro_torch.models.moe import ffn_forward
from repro_torch.sparse_compute import is_packed, packed_mlp, \
    packed_project_q

from .pager import POS_SENTINEL

__all__ = ["paged_decode_step", "paged_prefill_chunk",
           "paged_prefill_chunk_spls", "compact_slots", "scatter_prefill"]


def _write_slots(pages: torch.Tensor, rows: torch.Tensor,
                 flat: torch.Tensor) -> None:
    """In place: ``pages (KV, N, ps, Dh)`` slot ``flat[i]`` <- ``rows[:,
    i]`` for ``rows (KV, M, Dh)``.  Duplicate targets in ``flat`` only ever
    name null-page slots (padded chunk rows, inactive decode rows); which
    write lands there is unspecified on CUDA and harmless, because the
    null page is never read live."""
    KV, N, ps, Dh = pages.shape
    pages.view(KV, N * ps, Dh)[:, flat] = rows.to(pages.dtype)


def _residual_ffn(cfg, blk, bp, x: torch.Tensor, h: torch.Tensor,
                  ffn_leader: Optional[torch.Tensor] = None, ffn_comp=None,
                  compute_backend: str = "dense") -> torch.Tensor:
    """Attention residual + optional post-norms + FFN residual.
    ``ffn_leader`` ((B, L) local row ids) is the simulation-mode sparse
    FFN: similar rows copy their MFI leader's output.  ``ffn_comp`` (a
    :class:`~repro_torch.core.sparse_exec.Compaction`) switches to the
    packed sparse FFN: only critical rows are computed, leaders broadcast
    to followers."""
    if cfg.use_post_norm:
        h = rms_norm(h, bp["post_ln1"], cfg.norm_eps)
    x = x + h
    if blk.has_ffn:
        xn2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
        if ffn_comp is not None and not blk.use_moe:
            h2 = packed_mlp(cfg, bp["ffn"], xn2, ffn_comp, compute_backend)
        else:
            h2 = ffn_forward(cfg, blk.use_moe, bp["ffn"], xn2)
            if ffn_leader is not None:
                h2 = gather_rows(h2, ffn_leader)
        if cfg.use_post_norm:
            h2 = rms_norm(h2, bp["post_ln2"], cfg.norm_eps)
        x = x + h2
    return x


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def paged_decode_step(cfg, params, cache, pos_pages: torch.Tensor,
                      tables: torch.Tensor, kv_len: torch.Tensor,
                      cur_pos: torch.Tensor, tokens: torch.Tensor,
                      backend: Optional[str] = None) -> torch.Tensor:
    """One batched decode tick over the paged cache.

    tokens: (B, 1) int32; tables: (B, P) int32; kv_len: (B,) int32 written
    slots; cur_pos: (B,) int32 original position of this token.  Every
    layer writes the token's K/V at slot ``kv_len`` (whose page the engine
    has already ensured) and attends over ``kv_len + 1`` slots.  Updates
    ``cache`` and ``pos_pages`` in place; returns logits (B, 1, V).
    """
    N, ps = pos_pages.shape
    P = tables.shape[1]
    # the engine allocates the page of slot kv_len before the tick; the
    # clamp only bounds the index explicitly (inactive rows have kv_len 0
    # and all-null tables, so they resolve to the null page)
    page_idx = (kv_len // ps).clamp(max=P - 1).long()
    page = tables.gather(1, page_idx[:, None])[:, 0]
    flat = (page * ps + kv_len % ps).long()
    pos_pages.view(-1)[flat] = cur_pos.to(torch.int32)
    n_valid = (kv_len + 1).to(torch.int32)
    fn = get_backend(resolve_paged_backend(backend or cfg.attn_backend,
                                           pos_pages.device))
    dtype = dtype_of(cfg.compute_dtype)
    x = embed_inputs(cfg, params, tokens)
    for pi in range(cfg.n_periods):
        for blk, bp, kc in zip(cfg.period, period_params(params, pi, dtype),
                               cache):
            k_pages, v_pages = kc.k_pages[pi], kc.v_pages[pi]
            xn = rms_norm(x, bp["ln1"], cfg.norm_eps)
            q, k_new, v_new = project_qkv(cfg, bp["attn"], xn,
                                          cur_pos[:, None])
            _write_slots(k_pages, k_new[:, :, 0].transpose(0, 1), flat)
            _write_slots(v_pages, v_new[:, :, 0].transpose(0, 1), flat)
            o = fn(cfg, q[:, :, :, 0].contiguous(), k_pages, v_pages,
                   pos_pages=pos_pages, tables=tables, kv_len=n_valid,
                   pos=cur_pos, window=blk.window)
            h = output_proj(cfg, bp["attn"], o[:, :, :, None])
            x = _residual_ffn(cfg, blk, bp, x, h)
    return head_logits(cfg, params, x)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def _chunk_slots(table: torch.Tensor, pos_pages: torch.Tensor, start: int,
                 valid: int, CS: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk destination slots; writes the chunk's original ids into
    ``pos_pages`` in place (slot == original position during prefill).

    Padded rows (index >= valid) all go to null-page slot 0 and write
    POS_SENTINEL, not their would-be position, so the null page stays
    inert.  Returns ``(sl (CS,) slot ids, flat (CS,) scatter targets)``.
    """
    N, ps = pos_pages.shape
    P = table.shape[0]
    idx = torch.arange(CS, dtype=torch.int32, device=table.device)
    sl = start + idx
    live = idx < valid
    # padded rows may run past the table; bound the lookup explicitly
    page = table[(sl // ps).clamp(max=P - 1).long()]
    flat = torch.where(live, page * ps + sl % ps, 0).long()
    pos_pages.view(-1)[flat] = torch.where(
        live, sl, torch.full_like(sl, POS_SENTINEL))
    return sl, flat


def _check_chunk(cfg, CS: int, valid: int) -> None:
    if not cfg.causal:
        raise ValueError("chunked prefill needs causal attention")
    if not 1 <= valid <= CS:
        raise ValueError(f"valid ({valid}) must be in [1, {CS}]")


def paged_prefill_chunk(cfg, params, cache, pos_pages: torch.Tensor,
                        table: torch.Tensor, start: int,
                        tokens: torch.Tensor, valid: int) -> torch.Tensor:
    """One prompt chunk for a single sequence (B = 1), without SPLS.

    tokens: (1, CS) the chunk padded to the static chunk size; start:
    slots written so far (== the chunk's first original position: this
    path never prunes); valid: real tokens in the chunk; table: (P,) the
    sequence's block table, with pages for ``start + valid`` slots
    allocated.  The chunk's queries attend over every slot written so far
    plus the chunk, masked by original position (causal, the block's
    ``window``) with ``attn_softcap``.  Updates ``cache`` and
    ``pos_pages`` in place; returns the logits (1, 1, V) of the chunk's
    last valid row (the LM head runs on that row only).
    """
    _, CS = tokens.shape
    _check_chunk(cfg, CS, valid)
    N, ps = pos_pages.shape
    S = table.shape[0] * ps
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    dtype = dtype_of(cfg.compute_dtype)
    dev = tokens.device
    tl = table.long()

    sl, flat = _chunk_slots(table, pos_pages, start, valid, CS)
    positions = sl[None, :]
    pg = pos_pages[tl].reshape(S)                    # slot -> original id
    slot_idx = torch.arange(S, device=dev)
    row_pos = positions[0][:, None]
    m = (slot_idx[None, :] < start + valid) & (pg[None, :] <= row_pos)

    x = embed_inputs(cfg, params, tokens)
    for pi in range(cfg.n_periods):
        for blk, bp, kc in zip(cfg.period, period_params(params, pi, dtype),
                               cache):
            k_pages, v_pages = kc.k_pages[pi], kc.v_pages[pi]
            xn = rms_norm(x, bp["ln1"], cfg.norm_eps)
            q, k_new, v_new = project_qkv(cfg, bp["attn"], xn, positions)
            _write_slots(k_pages, k_new[0], flat)
            _write_slots(v_pages, v_new[0], flat)
            kg = k_pages[:, tl].reshape(1, KV, 1, S, Dh)
            vg = v_pages[:, tl].reshape(1, KV, 1, S, Dh)
            s = softcap(torch.matmul(q, kg.transpose(-1, -2)) * Dh ** -0.5,
                        cfg.attn_softcap)
            mb = m
            if blk.window is not None:
                mb = mb & (row_pos - pg[None, :] < blk.window)
            s = torch.where(mb, s, torch.full_like(s, -1e30))
            a = torch.softmax(s.float(), dim=-1).to(q.dtype)
            h = output_proj(cfg, bp["attn"], torch.matmul(a, vg))
            x = _residual_ffn(cfg, blk, bp, x, h)
    return head_logits(cfg, params, x[:, valid - 1:valid])


# ---------------------------------------------------------------------------
# SPLS chunked prefill (the paper's progressive generation scheme, Sec. IV-C)
# ---------------------------------------------------------------------------

def paged_prefill_chunk_spls(cfg, params, cache, pred_cache,
                             pos_pages: torch.Tensor, table: torch.Tensor,
                             start: int, tokens: torch.Tensor, valid: int,
                             topk_k: int, q_capacity: Optional[int] = None,
                             ffn_capacity: Optional[int] = None,
                             kv_capacity: Optional[int] = None,
                             compute_backend: str = "dense",
                             live: Optional[torch.Tensor] = None,
                             last_keep: Optional[int] = None,
                             kv_vote_need: int = 1):
    """One SPLS prompt chunk for a single sequence (B = 1).

    tokens: (1, CS) the chunk padded to the static chunk size; start:
    slots written so far (== the chunk's first original position: columns
    stay dense until the end-of-prefill compaction); valid: real tokens in
    the chunk; table: (P,) the sequence's block table, with pages for
    ``start + valid`` slots allocated; topk_k: the prompt's top-k count.

    Every layer (1) extends its paged predictor cache with the chunk's
    predicted K heads as int8 codes + per-token scale, (2) emits the
    chunk's plan block against every column seen so far, and (3) runs the
    chunk's attention and FFN over all written slots:

    * ``compute_backend="dense"`` (simulation mode): Q, K and V for every
      row; a similar row uses its leader's Q row and mask row, and its
      MFI leader's FFN output;
    * a packed backend: Q and attention on the cross-head union of
      critical rows packed to ``q_capacity``, the FFN on FFN-critical rows
      packed to ``ffn_capacity`` (overflow rows fall back to their window
      leader).  At full capacities this is the dense path's arithmetic.

    **Horizon-finalized votes** (``live`` / ``kv_capacity`` /
    ``last_keep``, see :mod:`repro_torch.core.planner`): ``live`` (S,)
    marks the columns a finite ``vote_horizon`` has not finalized as
    pruned; the others are denied attention in every layer, while the
    prediction and vote stay horizon-independent.  With ``kv_capacity``
    (``vote_horizon == 1``, packed compute only), layer 0 of period 0
    decides which of the chunk's own columns won ``kv_vote_need`` heads'
    votes (plus the ``last_keep`` anchor), packs them to ``kv_capacity``,
    and only those are projected and written; every layer shares that
    decision, as a page slot is shared by every layer.  Without them every
    chunk column is projected until the end-of-prefill vote.

    Updates ``cache``, ``pred_cache`` and ``pos_pages`` in place.  Returns
    ``(logits (1, 1, V) of the chunk's last valid row, kv_any (1, KV, G,
    S) layer 0's per-head column-keep bits, counts (n_periods, 3) int32)``
    with counts the per-period max of (union-critical rows, FFN-critical
    rows, vote-surviving own columns under ``kv_capacity`` else 0) -- the
    capacity controllers' observations.
    """
    _, CS = tokens.shape
    w = cfg.spls.window
    if CS % w:
        raise ValueError(
            f"prefill_chunk ({CS}) must be a multiple of the SPLS "
            f"similarity window ({w}): chunk boundaries must align with "
            f"similarity windows for chunked prefill to reproduce the "
            f"full-prefill plan")
    _check_chunk(cfg, CS, valid)
    packed = is_packed(compute_backend)
    if kv_capacity is not None:
        if not packed:
            raise ValueError("kv_capacity rides on a packed compute backend, "
                             f"got {compute_backend!r}")
        if live is None or last_keep is None:
            raise ValueError("kv_capacity needs the liveness mask and the "
                             "decode anchor (live, last_keep)")
    Cq = min(q_capacity or CS, CS)
    Cf = min(ffn_capacity or CS, CS)
    Ckv = min(kv_capacity, CS) if kv_capacity is not None else None
    N, ps = pos_pages.shape
    S = table.shape[0] * ps
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    scfg = cfg.spls
    dtype = dtype_of(cfg.compute_dtype)
    dev = tokens.device
    ctx = PlanContext.for_config(cfg, mode="structured")
    tl = table.long()

    sl, flat = _chunk_slots(table, pos_pages, start, valid, CS)
    positions = sl[None, :]
    n_cols = start + valid
    slot_idx = torch.arange(S, device=dev)
    ridx = torch.arange(CS, device=dev)
    if any(b.window is not None for b in cfg.period):
        # window mask over slots (slot == position during prefill)
        age = positions[0][:, None] - slot_idx[None, :]

    x = embed_inputs(cfg, params, tokens)
    kv_any = None
    # the vote_horizon == 1 decision of layer 0 (period 0), shared by all
    kv_written = live_all = n_kv = None
    counts = []
    for pi in range(cfg.n_periods):
        cnt = torch.zeros(3, dtype=torch.int64, device=dev)
        for blk, bp, kc, pk in zip(cfg.period,
                                   period_params(params, pi, dtype),
                                   cache, pred_cache):
            k_pages, v_pages = kc.k_pages[pi], kc.v_pages[pi]
            codes_pg, scale_pg = pk.codes[pi], pk.scale[pi]
            xn = rms_norm(x, bp["ln1"], cfg.norm_eps)
            # prediction: extend the predictor code pages, emit the plan.
            # The prediction and vote stay horizon-independent: finalized
            # columns keep their top-k candidacy and are only denied
            # materialization and attention below
            qh, k_codes, k_scale = ctx.encode_pred_qk(bp["attn"], xn)
            _write_slots(codes_pg, k_codes, flat)
            scale_pg.view(-1)[flat] = k_scale
            kh_all = ctx.decode_pred_k(codes_pg[:, tl].reshape(KV, S, Dh),
                                       scale_pg[tl].reshape(S),
                                       dtype=dtype)[None]
            pb = ctx.plan_block(qh, kh_all, k=topk_k, row0=start,
                                n_valid_rows=valid, n_cols=n_cols)
            if kv_any is None:
                kv_any = pb.kv_any
            lead_local = pb.q_leader - start
            crit_any = pb.q_critical.any(dim=2).any(dim=1)      # (1, CS)
            n_ffn = (pb.ffn_critical[0] & (ridx < valid)).sum()
            if Ckv is not None and kv_written is None:
                # which of this chunk's own columns get a K/V projection
                ok = own_column_keep(pb.kv_any, start=start, chunk=CS,
                                     valid=valid, last_keep=last_keep,
                                     vote_need=kv_vote_need)
                kv_written = pack_within_capacity(
                    ok, Ckv, anchor=start + ridx == last_keep)
                live_all = live.clone()
                end = min(start + CS, S)
                live_all[start:end] = kv_written[:end - start]
                n_kv = ok.sum()
            cnt = torch.maximum(cnt, torch.stack(
                [crit_any.sum(), n_ffn,
                 n_kv if n_kv is not None else torch.zeros_like(n_ffn)]))
            # formal K/V at original positions: every chunk row, except
            # under vote_horizon == 1, where only the kept columns
            if not packed:
                q, k_new, v_new = project_qkv(cfg, bp["attn"], xn, positions)
                kv_flat = flat
            elif Ckv is not None:
                # pack order over the anchor-reserved written set: at most
                # Ckv True rows, so every written column lands in the perm
                # (filler slots scatter to the null page)
                kv_perm, _ = pack_by_mask(kv_written, Ckv)
                k_new, v_new = project_kv(
                    cfg, bp["attn"], xn, positions, perm=kv_perm,
                    compute_backend=compute_backend)
                kp = kv_perm.long()
                kv_flat = torch.where(kv_written[kp], flat[kp], 0)
            else:
                k_new, v_new = project_kv(cfg, bp["attn"], xn, positions)
                kv_flat = flat
            _write_slots(k_pages, k_new[0], kv_flat)
            _write_slots(v_pages, v_new[0], kv_flat)
            kg = k_pages[:, tl].reshape(1, KV, 1, S, Dh)
            vg = v_pages[:, tl].reshape(1, KV, 1, S, Dh)
            mask = pb.mask
            if blk.window is not None:
                mask = mask & (age < blk.window)
            if live_all is not None:
                # finalized earlier, or dropped by this chunk's K/V pack:
                # never projected, so never attended
                mask = mask & live_all
            elif live is not None:
                # a finite horizon without the K/V pack: earlier-finalized
                # columns are pruned, this chunk's own always materialize
                mask = mask & live
            # the two modes differ only in which q / mask rows the shared
            # score-softmax-AV block sees
            if packed:
                # only the union rows' scores (every head's leaders are in
                # the union); every row then reads its leader's packed
                # slot, overflow rows their window leader's
                qcomp = compact_rows(crit_any, Cq, leader=lead_local,
                                     window=w)
                perm = qcomp.perm[0]
                q_sel = packed_project_q(cfg, bp["attn"], xn, sl, perm,
                                         compute_backend)
                mask_sel = mask.index_select(-2, perm.long())
            else:
                # similar rows use their leader's Q row and mask row
                # (leaders are window-local, hence chunk-local)
                q_sel = gather_rows(q, lead_local)
                mask_sel = gather_rows(mask, lead_local)
            s = torch.matmul(q_sel, kg.transpose(-1, -2)) * Dh ** -0.5
            s = softcap(s, cfg.attn_softcap)
            o = torch.matmul(masked_softmax(s, mask_sel), vg)
            if packed:
                o = gather_rows(o, qcomp.src_slot)
            h = output_proj(cfg, bp["attn"], o)
            ffn_comp = None
            if packed and scfg.ffn_sparsity and not blk.use_moe:
                ffn_comp = compact_rows(pb.ffn_critical, Cf,
                                        leader=pb.ffn_leader - start,
                                        window=w)
            x = _residual_ffn(
                cfg, blk, bp, x, h,
                ffn_leader=(pb.ffn_leader - start if scfg.ffn_sparsity
                            else None),
                ffn_comp=ffn_comp, compute_backend=compute_backend)
        counts.append(cnt)
    x_last = x[:, valid - 1:valid]
    return (head_logits(cfg, params, x_last), kv_any,
            torch.stack(counts).to(torch.int32))


def compact_slots(cache, pos_pages: torch.Tensor, table: torch.Tensor,
                  keep: torch.Tensor) -> None:
    """End-of-prefill SPLS compaction, in place within a sequence's pages.

    keep: (S,) bool over the sequence's logical slots (slot == original
    position during prefill; slots past the prompt are False).  Kept slots
    move, in original order, to the first ``n_kept`` slots of the
    sequence's *own* pages; the freed tail is sentinel-filled so window
    masks never admit a stale id.  The engine frees the pages past
    ``ceil(n_kept / ps)`` afterwards.
    """
    N, ps = pos_pages.shape
    S = table.shape[0] * ps
    sl = torch.arange(S, device=pos_pages.device)
    flat = table.long()[sl // ps] * ps + sl % ps
    perm = torch.argsort((~keep).to(torch.int8), stable=True)
    n_kept = keep.sum()
    src = flat[perm]
    pos_flat = pos_pages.view(-1)
    # unallocated table tails alias null-page slots: every such target is a
    # j >= n_kept slot, so it receives POS_SENTINEL (and, below, garbage
    # K/V in an unspecified order -- harmless, the null page is never read
    # live).  The right-hand sides are gathered copies, read before any
    # write lands.
    vals = torch.where(sl < n_kept, pos_flat[src],
                       torch.full_like(sl, POS_SENTINEL).to(pos_flat.dtype))
    pos_flat[flat] = vals.to(pos_flat.dtype)
    for pc in cache:
        for pages in (pc.k_pages, pc.v_pages):
            nP, KV, N_, ps_, Dh = pages.shape
            pf = pages.view(nP, KV, N_ * ps_, Dh)
            pf[:, :, flat] = pf[:, :, src]


def scatter_prefill(cache, pos_pages: torch.Tensor, dense_cache,
                    keep_idx: torch.Tensor, flat: torch.Tensor) -> None:
    """Move a whole-prompt prefill's kept KV columns into pages, in place.

    dense_cache: the per-block cache of :func:`repro_torch.models.prefill`
    on a batch of one (``k / v (n_periods, 1, KV, S, Dh)``); keep_idx:
    (n_kept,) original positions that survive SPLS pruning (all of them
    without pruning); flat: (n_kept,) destination flat page slots.  The kept
    columns land compacted and ``pos_pages`` records their original ids.
    """
    pos_pages.view(-1)[flat.long()] = keep_idx.to(torch.int32)
    keep = keep_idx.long()
    for pc, dc in zip(cache, dense_cache):
        for pages, dense in ((pc.k_pages, dc.k), (pc.v_pages, dc.v)):
            nP, KV, N, ps, Dh = pages.shape
            pages.view(nP, KV, N * ps, Dh)[:, :, flat.long()] = \
                dense[:, 0].index_select(2, keep).to(pages.dtype)
