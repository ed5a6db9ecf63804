"""Block-pool paged KV cache: pages, free list, and the SPLS prune vote.

The pool owns ``n_pages`` fixed-size pages per layer, shared by every
sequence in the engine.  A sequence's KV lives in the pages its block table
names; pages are allocated on demand (one page covers ``page_size`` token
slots across *all* KV heads of every layer) and returned to the free list
when the request retires or is preempted.

Page 0 is the reserved **null page**: it fills unallocated block-table
entries and absorbs writes from inactive batch rows and padded chunk rows.
Reads of it are always masked (slot >= kv_len), so its contents never
matter.

SPLS page pruning: prompt positions whose K/V columns lose the cross-head
keep vote receive no slot at all -- the kept columns are compacted into
pages and each slot remembers its *original* position id (``pos_pages``),
which keeps RoPE, causality and sliding windows exact after compaction.
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.planner import progressive_plan_blocks, \
    votes_from_kv_any
from repro_torch.models.common import dtype_of, rms_norm
from repro_torch.models.model import embed_inputs, period_params

__all__ = ["NULL_PAGE", "POS_SENTINEL", "PagedKVCache", "PredKCache",
           "PagePool", "init_paged_cache", "init_pos_pages",
           "init_pred_cache", "keep_from_votes", "spls_token_votes",
           "spls_token_keep"]

NULL_PAGE = 0
# pos_pages filler for never-written slots.  Correctness never rests on it:
# unwritten/stale slots are excluded by the `slot < kv_len` mask (and by
# `id <= position` in the chunked-prefill path).  The sentinel only keeps
# such slots inert in position arithmetic -- a window test `pos - id <
# window` on a sentinel passes, so the kv_len mask must always stay ANDed.
POS_SENTINEL = 1 << 30


class PagedKVCache(NamedTuple):
    """One period block's page pool: k/v_pages ``(n_periods, KV, n_pages,
    ps, Dh)``."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor


class PredKCache(NamedTuple):
    """One period block's paged SPLS predictor cache as **int8 HLog codes
    + per-token scale**: codes ``(n_periods, KV, n_pages, ps, Dh)`` int8,
    scale ``(n_periods, n_pages, ps)`` float32.  The planner dequantizes on
    read (:meth:`repro_torch.core.planner.PlanContext.decode_pred_k`)."""

    codes: torch.Tensor
    scale: torch.Tensor


class PagePool:
    """Free-list allocator over the shared page pool (host-side).

    Page ids are plain ints; the engine owns the device tensors.
    Allocation is all-or-nothing so a request can never deadlock holding
    half of what it needs.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is the null page)")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: deque = deque(range(1, n_pages))
        self._allocated: set = set()
        self.peak_in_use = 0
        self.guard_trips = 0

    @property
    def capacity(self) -> int:
        """Allocatable pages (the null page is never handed out)."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.capacity - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size) if n_tokens > 0 else 0

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages from the free list, or None if short."""
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        self._allocated.update(pages)
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return pages

    def free(self, pages: List[int]) -> None:
        """Return pages to the free list; raises on a double-free or a
        foreign/null page (two sequences would otherwise share a page)."""
        for p in pages:
            if p not in self._allocated:
                self.guard_trips += 1
                raise ValueError(
                    f"page {p} is not currently allocated "
                    f"({'null page' if p == NULL_PAGE else 'double-free or foreign page'}); "
                    f"refusing to free it twice -- two sequences would "
                    f"share one page")
            self._allocated.discard(p)
            self._free.append(p)


def init_paged_cache(cfg, n_pages: int, page_size: int,
                     device) -> tuple:
    """One :class:`PagedKVCache` per period block, ``(n_periods, KV,
    n_pages, ps, Dh)`` zeros in the compute dtype."""
    dtype = dtype_of(cfg.compute_dtype)
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_periods, KV, n_pages, page_size, Dh)

    def one_block(blk):
        if blk.mixer != "attn":
            raise NotImplementedError(
                "the paged cache covers attention blocks only: the paged "
                "engine is attention-only, as the reference's is (SSM "
                "state is O(1) per slot and is not paged)")
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device))

    return tuple(one_block(blk) for blk in cfg.period)


def init_pos_pages(n_pages: int, page_size: int, device) -> torch.Tensor:
    """(n_pages, ps) int32 original-position ids, sentinel-filled; shared by
    every layer."""
    return torch.full((n_pages, page_size), POS_SENTINEL, dtype=torch.int32,
                      device=device)


def init_pred_cache(cfg, n_pages: int, page_size: int, device) -> tuple:
    """Paged SPLS predictor cache: per attention block, the predicted K
    heads of every written slot as int8 codes + per-token scale,
    page-parallel with the KV pool (same block table, same flat slots)."""
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.spls.quant_bits > 8:
        raise ValueError(
            f"int8 predictor-cache codes require spls.quant_bits <= 8, "
            f"got {cfg.spls.quant_bits}")
    return tuple(PredKCache(
        codes=torch.zeros((cfg.n_periods, KV, n_pages, page_size, Dh),
                          dtype=torch.int8, device=device),
        scale=torch.zeros((cfg.n_periods, n_pages, page_size),
                          dtype=torch.float32, device=device))
        for _ in cfg.period)


def keep_from_votes(votes: np.ndarray, n_heads: int,
                    vote: float) -> np.ndarray:
    """Threshold head votes into a keep mask; the final token is always
    kept (it anchors the decode continuation)."""
    need = max(1, math.ceil(vote * n_heads))
    keep = np.array(np.asarray(votes) >= need)
    keep[-1] = True
    return keep


def spls_token_votes(cfg, params, prompt: torch.Tensor) -> torch.Tensor:
    """(Lp,) int32 head votes for keeping each prompt KV column.

    The SPLS prediction (HLog PAM -> bisection top-k -> zero-column
    detection) on the layer-0 normalized input, through the planner's
    progressive plan over window-aligned row blocks (never a dense Lp x
    Lp plan); counts how many of the H = KV * G heads retain each column.
    The votes equal what the streaming chunk step accumulates chunk by
    chunk, for any chunking.
    """
    blk0 = period_params(params, 0, dtype_of(cfg.compute_dtype))[0]
    x = embed_inputs(cfg, params, prompt[None, :])
    xn = rms_norm(x, blk0["ln1"], cfg.norm_eps)
    kv_any = None
    for blk in progressive_plan_blocks(cfg, blk0, xn, votes_only=True):
        kv_any = blk if kv_any is None else (kv_any | blk)
    return votes_from_kv_any(kv_any)


def spls_token_keep(cfg, params, prompt: torch.Tensor,
                    vote: float = 0.5) -> np.ndarray:
    """(Lp,) bool keep mask for prompt KV columns: a token keeps its page
    slot iff at least ``ceil(vote * H)`` heads retain its column (the last
    token always).  All True when SPLS is disabled."""
    Lp = int(prompt.shape[0])
    if not cfg.spls.enabled:
        return np.ones((Lp,), bool)
    votes = spls_token_votes(cfg, params, prompt)
    return keep_from_votes(votes.cpu().numpy(), cfg.n_heads, vote)
