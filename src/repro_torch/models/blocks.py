"""Transformer / Mamba blocks with SPLS: whole-sequence forward and
one-token decode.

A block is (pre-norm -> mixer -> residual) + optional (pre-norm -> FFN ->
residual), with optional post-norms.  With SPLS on and an attention mixer,
the plan is built from the *normalized block input* and the attention
projection weights -- prediction before QKV generation, as in the paper's
Fig. 5a -- then attention and the FFN execute under it.  Plan construction
lives in the planner (:mod:`repro_torch.core.planner`); this module selects
the plan and executes under it.  A Mamba mixer has no attention matrix to
predict, so SPLS does not apply to it (nor to its FFN: FFN sparsity needs
per-head leaders); in hybrid models the attention blocks still use it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.planner import (build_block_plan,
                                     build_block_plan_chunked,
                                     build_block_plan_progressive,
                                     progressive_plan_blocks)
from repro_torch.core.sparse_exec import (compact_rows, spls_ffn,
                                          spls_ffn_packed)
# the submodules, not the package: importing ``repro_torch.sparse_compute``
# first runs its accounting module, which imports this package
from repro_torch.sparse_compute.backend import (is_packed,
                                                resolve_compute_backend)
from repro_torch.sparse_compute.packed import packed_mlp

from .attention import (attention_decode, attention_forward,
                        head_shard_mode, init_attention, init_kv_cache)
from .common import rms_norm
from .mamba import (init_mamba, init_mamba_cache, mamba_decode,
                    mamba_forward)
from .moe import ffn_forward, init_ffn

__all__ = ["init_block", "init_block_cache", "block_forward", "block_decode",
           "build_block_plan", "build_block_plan_chunked",
           "build_block_plan_progressive", "progressive_plan_blocks"]

# at and above this length "auto" plans row block by row block (a
# ChunkedPlan, no O(L^2) mask); below it, the exact plan
_SPLS_CHUNK_THRESHOLD = 8192


def init_block(cfg, blk, gen: torch.Generator, dtype, device) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    p = {"ln1": zeros()}
    if blk.mixer == "attn":
        p["attn"] = init_attention(cfg, gen, dtype, device)
    else:
        p["mamba"] = init_mamba(cfg, gen, dtype, device)
    if blk.has_ffn:
        p["ln2"] = zeros()
        p["ffn"] = init_ffn(cfg, blk.use_moe, gen, dtype, device)
    if cfg.use_post_norm:
        p["post_ln1"] = zeros()
        if blk.has_ffn:
            p["post_ln2"] = zeros()
    return p


def init_block_cache(cfg, blk, batch, max_len: int, dtype, device):
    """A :class:`~repro_torch.models.attention.KVCache` for an attention
    block, a :class:`~repro_torch.models.mamba.MambaCache` for a Mamba
    block; ``batch`` is an int or a tuple of leading dims."""
    if blk.mixer == "attn":
        return init_kv_cache(cfg, batch, max_len, dtype, device)
    return init_mamba_cache(cfg, batch, dtype, device)


def _capacities(cfg, L: int) -> Tuple[Optional[int], Optional[int]]:
    s = cfg.spls
    qc = None if s.q_capacity_ratio >= 1.0 else max(
        s.window, math.ceil(s.q_capacity_ratio * L))
    kc = None if s.kv_capacity_ratio >= 1.0 else max(
        s.window, math.ceil(s.kv_capacity_ratio * L))
    return qc, kc


def block_forward(cfg, blk, p: dict, x: torch.Tensor,
                  cache_len: Optional[int] = None,
                  attn_backend: Optional[str] = None,
                  plan_mode: str = "auto"):
    """Whole-sequence block.  x: (B, L, D).

    With ``cache_len`` (prefill) also returns the block's cache (see
    :func:`init_block_cache`).  ``plan_mode="progressive"`` builds the
    SPLS plan with the streaming-reproducible planner (what the serving
    engines use); ``"auto"`` builds the exact-top-k plan, and at ``L >=
    _SPLS_CHUNK_THRESHOLD`` the row-block
    :class:`~repro_torch.core.spls_chunked.ChunkedPlan`.
    """
    if plan_mode not in ("auto", "progressive"):
        raise ValueError(f"unknown plan_mode {plan_mode!r}")
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    plan, cache = None, None
    if blk.mixer == "attn":
        # the padded head layout runs dense, as in the reference: a plan
        # over padded heads would count their garbage votes
        if head_shard_mode(cfg) != "padded":
            if plan_mode == "progressive":
                plan = build_block_plan_progressive(cfg, p, xn)
            elif cfg.spls.enabled and x.shape[1] >= _SPLS_CHUNK_THRESHOLD:
                plan = build_block_plan_chunked(cfg, p, xn)
            else:
                plan = build_block_plan(cfg, p, xn)
        qc, kc = _capacities(cfg, x.shape[1]) if plan is not None \
            else (None, None)
        h = attention_forward(cfg, p["attn"], xn, window=blk.window,
                              plan=plan, q_capacity=qc, kv_capacity=kc,
                              cache_len=cache_len, backend=attn_backend)
    else:
        h = mamba_forward(cfg, p["mamba"], xn,
                          want_cache=cache_len is not None)
    if cache_len is not None:
        h, cache = h
    if cfg.use_post_norm:
        h = rms_norm(h, p["post_ln1"], cfg.norm_eps)
    x = x + h

    if blk.has_ffn:
        xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        fn = lambda t: ffn_forward(cfg, blk.use_moe, p["ffn"], t)
        if plan is not None and cfg.spls.ffn_sparsity:
            if qc is not None:
                # capacity mode: the compute backend decides how the packed
                # rows execute (MoE keeps its own routing as the pack)
                cb = resolve_compute_backend(cfg.compute_backend,
                                             sparse=True, device=x.device)
                if is_packed(cb) and not blk.use_moe:
                    comp = compact_rows(plan.ffn_critical, qc,
                                        leader=plan.ffn_leader,
                                        window=cfg.spls.window)
                    h2 = packed_mlp(cfg, p["ffn"], xn2, comp, cb)
                else:
                    h2 = spls_ffn_packed(xn2, fn, plan, qc,
                                         window=cfg.spls.window)
            else:
                h2 = spls_ffn(xn2, fn, plan)
        else:
            h2 = fn(xn2)
        if cfg.use_post_norm:
            h2 = rms_norm(h2, p["post_ln2"], cfg.norm_eps)
        x = x + h2
    if cache_len is not None:
        return x, cache
    return x


def block_decode(cfg, blk, p: dict, x: torch.Tensor, cache, pos: torch.Tensor,
                 attn_backend: Optional[str] = None):
    """One-token decode.  x: (B, 1, D); the cache is updated in place.
    Returns ``(x, cache)``."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    if blk.mixer == "attn":
        h, cache = attention_decode(cfg, p["attn"], xn, cache, pos,
                                    window=blk.window, backend=attn_backend)
    else:
        h, cache = mamba_decode(cfg, p["mamba"], xn, cache)
    if cfg.use_post_norm:
        h = rms_norm(h, p["post_ln1"], cfg.norm_eps)
    x = x + h
    if blk.has_ffn:
        xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        h2 = ffn_forward(cfg, blk.use_moe, p["ffn"], xn2)
        if cfg.use_post_norm:
            h2 = rms_norm(h2, p["post_ln2"], cfg.norm_eps)
        x = x + h2
    return x, cache
