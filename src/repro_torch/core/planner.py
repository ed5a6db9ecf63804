"""The SPLS planner: one owner of the predictor state behind every plan.

:class:`PlanContext` owns the quantized predictor state -- the head
layout, the HLog prediction, and the int8 code encoding of the paged
predictor cache -- and emits plans through it:

* **exact** -- :meth:`PlanContext.plan_exact`: full PAM, exact top-k,
  per-tensor quantization -- the paper's Fig. 5a as one shot, and what
  ``block_forward(plan_mode="auto")`` builds below
  ``models.blocks._SPLS_CHUNK_THRESHOLD`` (:func:`build_block_plan`);
* **long sequence** -- :meth:`PlanContext.plan_scan`: the same numerics
  one row block at a time (:func:`~repro_torch.core.spls_chunked.
  chunked_plan_scan`), O(row_block * L) peak, a plan-lite
  :class:`~repro_torch.core.spls_chunked.ChunkedPlan`
  (:func:`build_block_plan_chunked`);
* **streaming serving** -- :meth:`PlanContext.encode_pred_qk` /
  :meth:`PlanContext.decode_pred_k` / :meth:`PlanContext.plan_block`,
  driven one chunk at a time by
  :func:`repro_torch.serving.paged_model.paged_prefill_chunk_spls`; the
  column votes accumulate across chunks into the page-prune vote;
* **progressive full sequence** -- :meth:`PlanContext.iter_blocks` /
  :meth:`PlanContext.plan_progressive` (window-aligned row blocks,
  per-token quantization): what a whole-prompt prefill builds, and
  exactly what the streaming step reproduces chunk by chunk;
* **horizon-finalized column votes** -- :func:`own_column_keep` and
  :func:`pack_within_capacity` decide on the device which of a chunk's own
  columns get a K/V projection (``vote_horizon == 1``), and
  :func:`horizon_update_live` mirrors that decision on the host and
  finalizes columns whose probation expired (any finite horizon).

Plans take the attention's head layout
(:func:`repro_torch.models.attention.head_shard_mode`): structured ``(B,
KV, G, ...)``, or under a mesh whose model axis only ``H`` divides, flat
``(B, H, 1, ...)`` -- the structured plan with its head dims flattened, so
both layouts plan alike on every device.  The predicted heads and the
paged predictor cache (:meth:`PlanContext.encode_pred_qk`) keep the
structured layout.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding.logical import arange_like, constrain, is_dtensor

from .predict import head_scores, predict_qk, predict_qk_pre
from .quantizers import (PROJECTORS, quantize_dequantize,
                         symmetric_quantize)
from .spls import SPLSConfig, SparsityPlan
from .mfi import mfi_ffn_sparsity
from .similarity import local_similarity
from .spls_chunked import (ChunkedPlan, ChunkPlanBlock, chunked_plan_scan,
                           plan_chunk, plan_chunk_votes, votes_from_kv_any)
from .topk import kv_keep_from_mask, sparsify_pam, topk_count

__all__ = ["PlanContext", "build_block_plan", "build_block_plan_chunked",
           "build_block_plan_progressive", "progressive_plan_blocks",
           "votes_from_kv_any", "own_column_keep", "pack_within_capacity",
           "horizon_update_live"]


def _progressive_row_block(L: int, w: int) -> int:
    """Row-block size of the progressive plan: a window multiple, at
    most ~512 rows (the PAM block is O(row_block * L) per head)."""
    return max(w, (min(512, L) // w) * w)


@dataclasses.dataclass(frozen=True)
class PlanContext:
    """Static planning context: SPLS hyper-parameters + head layout."""

    scfg: SPLSConfig
    D: int
    KV: int
    G: int
    Dh: int
    causal: bool
    mode: str = "structured"

    @classmethod
    def for_config(cls, cfg, mode: Optional[str] = None) -> "PlanContext":
        if mode is None:
            from repro_torch.models.attention import head_shard_mode
            mode = head_shard_mode(cfg)
        scfg = cfg.spls
        if scfg.causal != cfg.causal:
            scfg = dataclasses.replace(scfg, causal=cfg.causal)
        return cls(scfg=scfg, D=cfg.d_model, KV=cfg.n_kv_heads,
                   G=cfg.n_heads // cfg.n_kv_heads,
                   Dh=cfg.resolved_head_dim, causal=cfg.causal, mode=mode)

    def _weights2d(self, p: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        wq = p["wq"].reshape(self.D, self.KV * self.G * self.Dh)
        wk = p["wk"].reshape(self.D, self.KV * self.Dh)
        return wq, wk

    @property
    def head_names(self) -> Tuple:
        """Logical sharding axes of the plan's two head dims."""
        return (("heads", None) if self.mode == "flat"
                else ("kv_heads", "qgroups"))

    def _in_layout(self, plan):
        """A plan (a NamedTuple of the planner, or one tensor) in this
        context's head layout.  Plans are computed in the structured
        layout and a flat plan is that plan with ``(KV, G)`` flattened to
        ``(H, 1)``: the flat layout's own PAM products would round
        otherwise on the card and flip near-ties, so the two layouts could
        plan differently for the same input."""
        def one(t):
            if t.dim() < 3 or tuple(t.shape[1:3]) != (self.KV, self.G):
                return t
            return t.reshape(t.shape[0], self.KV * self.G, 1, *t.shape[3:])
        if self.mode != "flat":
            return plan
        if isinstance(plan, torch.Tensor):
            return one(plan)
        return type(plan)(*(one(t) for t in plan))

    def _layout(self, qp: torch.Tensor, kp: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L, H*Dh)/(B, L, KV*Dh) predictions -> ``qh (B, KV, G, L,
        Dh)`` / ``kh (B, KV, L, Dh)``."""
        KV, G, Dh = self.KV, self.G, self.Dh
        B, L = qp.shape[0], qp.shape[1]
        qh = qp.reshape(B, L, KV, G, Dh).permute(0, 2, 3, 1, 4)
        kh = kp.reshape(B, L, KV, Dh).permute(0, 2, 1, 3)
        return qh, kh

    def predict_heads(self, p: dict, xn: torch.Tensor,
                      act_axis: Optional[int] = -1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantized prediction on the normalized block input -> ``(qh (B,
        KV, G, L, Dh), kh (B, KV, L, Dh))``.  ``act_axis=-1`` is the
        streaming-reproducible numerics (per-token scales); ``None`` the
        offline per-tensor variant of the exact and scan plans.  On
        ``DTensor``s the heads are laid out before the products
        (:meth:`_predict_by_head`)."""
        if is_dtensor(xn):
            return self._predict_by_head(p, xn, act_axis)
        wq, wk = self._weights2d(p)
        qp, kp = predict_qk(xn, wq, wk, self.scfg.quant_method,
                            self.scfg.quant_bits, act_axis=act_axis)
        return self._layout(qp, kp)

    def _predict_by_head(self, p: dict, xn: torch.Tensor,
                         act_axis: Optional[int]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`predict_heads` on ``DTensor``s (the dry run): the
        quantized weights are laid out by head before the products, so
        that each device projects only its own heads' ``wq`` / ``wk``
        columns, as the attention's projections do (the reference's XLA
        moves the head constraint on the prediction into the product).
        Flat heads ``qh (B, H, 1, L, Dh)`` / ``kh (B, H, L, Dh)`` (the KV
        weights repeated per device, the product widened after, as
        :func:`~repro_torch.models.attention.project_qkv`'s); structured
        ``(B, KV, G, L, Dh)`` / ``(B, KV, L, Dh)``, the query groups
        outermost in the product where they, not KV, shard.  The scales
        are the plain path's: per tensor, or per token over every head
        (``act_axis=-1``)."""
        from repro_torch.models.attention import (_model_axis,
                                                  flat_kv_share,
                                                  widen_heads)

        method, bits = self.scfg.quant_method, self.scfg.quant_bits
        KV, G, Dh, D = self.KV, self.G, self.Dh, self.D
        quant = lambda t, axis=None: quantize_dequantize(t, method, bits,
                                                         axis=axis)
        xq = quant(xn, act_axis)
        wq, wk = quant(p["wq"]), quant(p["wk"])     # per-tensor scales
        per_token = act_axis is not None
        if self.mode == "flat":
            heads = ("batch", "heads", "seq", None)
            e = flat_kv_share(KV * G, G)
            wq = constrain(wq.reshape(D, KV * G, Dh), (None, "heads", None))
            wk = constrain(wk.repeat_interleave(G // e, 1),
                           (None, "heads", None))
            q = constrain(torch.einsum("bld,dhe->bhle", xq, wq), heads)
            k = constrain(torch.einsum("bld,dhe->bhle", xq, wk), heads)
            tok = (1, 3) if per_token else None
            # a repeated head changes no scale: the max is the same
            return (quant(q, tok)[:, :, None],
                    widen_heads(quant(k, tok), e))
        m = _model_axis()
        if KV % m and G % m == 0:
            q = torch.einsum("bld,dgkh->bgklh", xq,
                             wq.transpose(1, 2)).transpose(1, 2)
        else:
            q = torch.einsum("bld,dkgh->bkglh", xq, wq)
        q = constrain(q, ("batch", "kv_heads", "qgroups", "seq", None))
        k = constrain(torch.einsum("bld,dkh->bklh", xq, wk),
                      ("batch", "kv_heads", "seq", None))
        return (quant(q, (1, 2, 4) if per_token else None),
                quant(k, (1, 3) if per_token else None))

    def encode_pred_qk(self, p: dict, xn: torch.Tensor):
        """Streaming prediction with the K side emitted as int8 codes.

        xn: (1, C, D) normalized chunk input.  Returns ``(qh (1, KV, G, C,
        Dh), k_codes (KV, C, Dh) int8, k_scale (C,) float32)``;
        :meth:`decode_pred_k` turns codes + scale back into the predicted
        K exactly (the log-domain projection is deterministic on the
        integer codes).
        """
        if self.mode != "structured":
            raise ValueError(f"head layout {self.mode!r}: the paged "
                             f"predictor cache keeps the structured layout")
        scfg = self.scfg
        if scfg.quant_bits > 8:
            raise ValueError(
                f"int8 predictor-cache codes require quant_bits <= 8, got "
                f"{scfg.quant_bits}")
        _, C, _ = xn.shape
        wq, wk = self._weights2d(p)
        q_pred, k_pre = predict_qk_pre(xn, wq, wk, scfg.quant_method,
                                       scfg.quant_bits, act_axis=-1)
        kq, kscale = symmetric_quantize(k_pre, bits=scfg.quant_bits,
                                        axis=-1)         # (1, C, KV*Dh)
        qh, _ = self._layout(q_pred, k_pre)
        k_codes = kq.reshape(C, self.KV, self.Dh).permute(1, 0, 2) \
            .to(torch.int8)
        return qh, k_codes, kscale.reshape(C).to(torch.float32)

    def decode_pred_k(self, codes: torch.Tensor, scale: torch.Tensor,
                      dtype=None) -> torch.Tensor:
        """int8 codes (..., S, Dh) + per-token scale (..., S) -> the
        dequantized predicted K heads.  ``dtype`` is the compute dtype the
        codes were encoded from: both factors are cast to it *before* the
        multiply, which reproduces the compute-dtype product exactly."""
        proj = PROJECTORS[self.scfg.quant_method](
            codes.to(torch.float32), self.scfg.quant_bits)
        if dtype is not None:
            proj = proj.to(dtype)
            scale = scale.to(dtype)
        return proj * scale[..., None]

    def plan_block(self, qh_blk: torch.Tensor, kh: torch.Tensor, *, k, row0,
                   n_valid_rows, n_cols) -> ChunkPlanBlock:
        """One window-aligned plan block -- the streaming planning unit."""
        return plan_chunk(qh_blk, kh, k=k, row0=row0,
                          n_valid_rows=n_valid_rows, n_cols=n_cols,
                          s_threshold=self.scfg.s_threshold,
                          window=self.scfg.window,
                          f_threshold=self.scfg.f_threshold,
                          causal=self.causal)

    def vote_block(self, qh_blk: torch.Tensor, kh: torch.Tensor, *, k, row0,
                   n_valid_rows, n_cols) -> torch.Tensor:
        """Column-keep contribution only (skips the similarity stage)."""
        return plan_chunk_votes(qh_blk, kh, k=k, row0=row0,
                                n_valid_rows=n_valid_rows, n_cols=n_cols,
                                causal=self.causal)

    def row_block_for(self, L: int) -> int:
        return _progressive_row_block(L, self.scfg.window)

    def iter_blocks(self, p: dict, xn: torch.Tensor,
                    row_block: Optional[int] = None,
                    votes_only: bool = False) -> Iterator:
        """Iterate the progressive planner's row blocks over a full
        sequence ``xn (B, L, D)``: the one place that owns the predicted-
        head layout, the window-aligned row blocking and the tail padding.
        Yields a :class:`~repro_torch.core.spls_chunked.ChunkPlanBlock`
        per block, or only its ``kv_any`` column-keep bools with
        ``votes_only=True``."""
        B, L, _ = xn.shape
        qh, kh = self.predict_heads(p, xn, act_axis=-1)
        w = self.scfg.window
        rb = row_block or self.row_block_for(L)
        if rb % w:
            raise ValueError(f"row_block ({rb}) must be a multiple of the "
                             f"similarity window ({w})")
        nblk = -(-L // rb)
        pad = nblk * rb - L
        if pad:
            qh = F.pad(qh, (0, 0, 0, pad))
        k = topk_count(L, self.scfg.k_ratio)
        step = self.vote_block if votes_only else self.plan_block
        for i in range(nblk):
            yield self._in_layout(step(
                qh[..., i * rb:(i + 1) * rb, :], kh, k=k, row0=i * rb,
                n_valid_rows=min(rb, L - i * rb), n_cols=L))

    def plan_progressive(self, p: dict, xn: torch.Tensor,
                         row_block: Optional[int] = None) -> SparsityPlan:
        """Full-sequence plan with streaming-reproducible numerics: exactly
        what a chunk-by-chunk streaming prefill reproduces."""
        B, L, _ = xn.shape
        blocks = list(self.iter_blocks(p, xn, row_block))
        mask = torch.cat([b.mask for b in blocks], -2)[..., :L, :]
        q_crit = torch.cat([b.q_critical for b in blocks], -1)[..., :L]
        q_lead = torch.cat([b.q_leader for b in blocks], -1)[..., :L]
        kv_keep = blocks[0].kv_any
        for b in blocks[1:]:
            kv_keep = kv_keep | b.kv_any
        if self.scfg.ffn_sparsity:
            ffn_crit = torch.cat([b.ffn_critical for b in blocks], -1)[..., :L]
            ffn_lead = torch.cat([b.ffn_leader for b in blocks], -1)[..., :L]
        else:
            ffn_crit = torch.ones((B, L), dtype=torch.bool, device=xn.device)
            ffn_lead = torch.arange(L, dtype=torch.int32,
                                    device=xn.device).expand(B, L)
        # attn_mask == mask & kv_keep[..., None, :] identically: a column a
        # row's mask selects is by definition kept in that head
        return SparsityPlan(attn_mask=mask, q_critical=q_crit,
                            q_leader=q_lead, kv_keep=kv_keep,
                            ffn_critical=ffn_crit, ffn_leader=ffn_lead)


    def plan_scan(self, p: dict, xn: torch.Tensor,
                  row_block: Optional[int] = None) -> ChunkedPlan:
        """Long-sequence plan: per-tensor prediction, then the row-block
        loop of :func:`chunked_plan_scan` -- O(row_block * L) peak, plan-
        lite output (no O(L^2) mask)."""
        L = xn.shape[1]
        qh, kh = self.predict_heads(p, xn, act_axis=None)
        scfg = self.scfg
        return self._in_layout(chunked_plan_scan(
            qh, kh, k_ratio=scfg.k_ratio, s_threshold=scfg.s_threshold,
            window=scfg.window, f_threshold=scfg.f_threshold,
            row_block=row_block or self.row_block_for(L),
            causal=scfg.causal))

    def exact_spa(self, p: dict, xn: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The exact plan's first stages: per-tensor prediction, the full
        scaled PAM (causal fill ``finfo.min / 2``), exact row top-k.
        Returns ``(spa, mask)``, both ``(B, KV, G, L, L)``; the masked-out
        causal entries are cleared from both."""
        L = xn.shape[1]
        qh, kh = self.predict_heads(p, xn, act_axis=None)
        pam = head_scores(qh, kh) * self.Dh ** -0.5
        tri = None
        if self.scfg.causal:
            i = arange_like(qh, L)
            tri = i[None, :] <= i[:, None]
            pam = pam.masked_fill(~tri, torch.finfo(pam.dtype).min / 2)
        spa, mask = sparsify_pam(pam, self.scfg.k_ratio)
        if tri is not None:
            mask = mask & tri
            spa = torch.where(mask, spa, torch.zeros_like(spa))
        return spa, mask

    def plan_exact(self, p: dict, xn: torch.Tensor) -> SparsityPlan:
        """Offline exact plan: full PAM, exact top-k, per-tensor
        quantization -- the accuracy-study numerics (the paper's Fig. 5a
        as one shot), MFI across all ``KV * G`` heads.  Not streaming-
        reproducible."""
        scfg = self.scfg
        B, L, _ = xn.shape
        spa, mask = self.exact_spa(p, xn)
        sim = local_similarity(spa, scfg.window, scfg.s_threshold)
        kv_keep = kv_keep_from_mask(mask)
        if scfg.ffn_sparsity:
            leaders = sim.leader.reshape(B, self.KV * self.G, L)
            ffn = mfi_ffn_sparsity(leaders, scfg.window, scfg.f_threshold)
            ffn_crit, ffn_leader = ffn.is_critical, ffn.leader
        else:
            ffn_crit = torch.ones((B, L), dtype=torch.bool, device=xn.device)
            ffn_leader = torch.arange(L, dtype=torch.int32,
                                      device=xn.device).expand(B, L)
        return self._in_layout(SparsityPlan(
            attn_mask=mask & kv_keep[..., None, :],
            q_critical=sim.is_critical, q_leader=sim.leader,
            kv_keep=kv_keep, ffn_critical=ffn_crit, ffn_leader=ffn_leader))


# ---------------------------------------------------------------------------
# horizon-finalized column votes
# ---------------------------------------------------------------------------

def own_column_keep(kv_any: torch.Tensor, *, start: int, chunk: int,
                    valid: int, last_keep: int, vote_need: int = 1
                    ) -> torch.Tensor:
    """Keep decision for the *current* chunk's own columns (on the device).

    kv_any: (B, KV, G, S) this chunk's plan-block column votes; start /
    valid: the chunk's slot window; last_keep: the prompt's final position
    (always kept: it anchors the decode continuation, as in
    ``keep_from_votes``).  Returns (chunk,) bool: a column survives iff at
    least ``vote_need`` heads' rows selected it -- the end-of-prefill
    vote's bar (``ceil(spls_prune_vote * H)``) on the chunk's own plan
    block.  This is the ``vote_horizon == 1`` finalization; it lands
    before formal K/V generation, so the K/V projection can skip the
    pruned columns.
    """
    S = kv_any.shape[-1]
    idx = torch.arange(chunk, device=kv_any.device)
    own = kv_any[..., start:min(start + chunk, S)]
    hv = own.reshape(-1, own.shape[-1]).to(torch.int32).sum(0)
    # a chunk reaching past the table's last slot reads no votes there
    hv = torch.nn.functional.pad(hv, (0, chunk - hv.shape[0]))
    keep = (hv >= vote_need) & (idx < valid)
    return keep | (start + idx == last_keep)


def pack_within_capacity(keep: torch.Tensor, capacity: int,
                         anchor: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(C,) keep mask -> the subset that fits the static capacity in the
    stable pack order (:func:`~repro_torch.core.sparse_exec.pack_by_mask`:
    the n-th kept row takes slot n-1).  Overflow columns leave the keep set
    (never materialized, never attendable); the capacity controller sees
    the overflow and escalates its bucket.

    ``anchor`` (C,) marks the forced decode anchor (the prompt's final
    position): present and kept, it is **reserved a slot** wherever it
    sits -- it is the final chunk's highest index, so plain pack order
    would drop it first, and decode without the last prompt token's K/V is
    a failure where any other overflow only degrades.  The other columns
    are then capped to ``capacity - 1``.
    """
    if anchor is None:
        return keep & (torch.cumsum(keep.to(torch.int32), -1) - 1 < capacity)
    anchor = anchor & keep
    present = anchor.any().to(torch.int32)
    others = keep & ~anchor
    capped = others & (torch.cumsum(others.to(torch.int32), -1) - 1
                       < capacity - present)
    return capped | anchor


def horizon_update_live(live: np.ndarray, head_votes: np.ndarray, *,
                        start: int, valid: int, chunk: int, horizon: int,
                        last_keep: int, vote_need: int = 1,
                        kv_capacity: Optional[int] = None,
                        metrics=None) -> np.ndarray:
    """Host-side liveness update after one streamed chunk's votes landed.

    live: (S,) current live mask; head_votes: (S,) accumulated cross-head
    keep-vote *counts* (layer 0, summed over heads).  A column votable for
    ``horizon`` consecutive chunks (its arrival chunk included) while
    still below ``vote_need`` heads is finalized as pruned; a column that
    reached the bar is never finalized (votes only grow).  With
    ``kv_capacity`` (the ``horizon == 1`` packed-K/V path) the current
    chunk's own columns are also capped to the packed projection capacity
    in pack order -- exactly what :func:`own_column_keep` +
    :func:`pack_within_capacity` wrote on the device, so the host's
    bookkeeping and the device's pages agree.  ``last_keep`` (the prompt's
    final position) is never finalized.

    ``metrics`` (optional, a
    :class:`~repro_torch.observability.metrics.MetricsRegistry`): only this
    function knows whether a column died to the horizon or to the
    kv-capacity pack, so it owns the ``spls/horizon_finalized_cols`` and
    ``spls/horizon_kv_capacity_drops`` counters.
    """
    live = np.asarray(live).copy()
    head_votes = np.asarray(head_votes)
    S = live.shape[0]
    sl = np.arange(S)
    kept_by_vote = head_votes >= vote_need
    if kv_capacity is not None and horizon == 1:
        own = slice(start, min(start + chunk, S))
        sl_own = sl[own]
        anchor = sl_own == last_keep
        keep_own = (kept_by_vote[own] | anchor) & (sl_own - start < valid)
        anchor = anchor & keep_own
        others = keep_own & ~anchor
        written = (others & (np.cumsum(others) - 1
                             < kv_capacity - int(anchor.any()))) | anchor
        if metrics is not None:
            newly_dead = live[own] & ~written
            n_vote = int((newly_dead & ~keep_own).sum())
            n_pack = int((newly_dead & keep_own).sum())
            if n_vote:
                metrics.counter("spls/horizon_finalized_cols").inc(n_vote)
            if n_pack:
                metrics.counter(
                    "spls/horizon_kv_capacity_drops").inc(n_pack)
        live[own] &= written
        return live
    cur = start // chunk
    elapsed = cur - sl // chunk + 1
    dead = (live & ~kept_by_vote & (sl < start + valid)
            & (elapsed >= horizon) & (sl != last_keep))
    if metrics is not None:
        n_dead = int(dead.sum())
        if n_dead:
            metrics.counter("spls/horizon_finalized_cols").inc(n_dead)
    live[dead] = False
    return live


def build_block_plan(cfg, p: dict, xn: torch.Tensor
                     ) -> Optional[SparsityPlan]:
    """Exact-top-k SPLS plan of one block (``p["attn"]`` holds the
    projection weights) from its normalized input, before QKV generation;
    ``None`` when SPLS is disabled."""
    if not cfg.spls.enabled:
        return None
    return PlanContext.for_config(cfg).plan_exact(p["attn"], xn)


def build_block_plan_chunked(cfg, p: dict, xn: torch.Tensor) -> ChunkedPlan:
    """Long-sequence plan of one block: :meth:`PlanContext.plan_scan` with
    row blocks of ``min(512, L)`` rows (at least one window)."""
    ctx = PlanContext.for_config(cfg)
    L = xn.shape[1]
    return ctx.plan_scan(p["attn"], xn,
                         row_block=max(ctx.scfg.window, min(512, L)))


def build_block_plan_progressive(cfg, p: dict, xn: torch.Tensor,
                                 row_block: Optional[int] = None
                                 ) -> Optional[SparsityPlan]:
    """Serving-mode SPLS plan of one block (``p["attn"]`` holds the
    projection weights) from its normalized input; ``None`` when SPLS is
    disabled."""
    if not cfg.spls.enabled:
        return None
    return PlanContext.for_config(cfg).plan_progressive(p["attn"], xn,
                                                        row_block)


def progressive_plan_blocks(cfg, p: dict, xn: torch.Tensor,
                            row_block: Optional[int] = None,
                            votes_only: bool = False) -> Iterator:
    """Iterate the progressive planner's row blocks for a full sequence
    (see :meth:`PlanContext.iter_blocks`)."""
    return PlanContext.for_config(cfg).iter_blocks(
        p["attn"], xn, row_block=row_block, votes_only=votes_only)
