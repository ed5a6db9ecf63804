"""The token model: parameters, whole-sequence forward, prefill and
one-token decode over a contiguous cache.

The layer stack is ``cfg.period`` (a tuple of blocks) repeated
``cfg.n_periods`` times.  Parameters keep the reference's tree: period
leaves are stacked on a leading ``(n_periods, ...)`` axis, so bridging
weights from the reference package is a plain copy
(:func:`repro_torch.weights.params_from_jax`).  Where the reference
traverses the stack with ``lax.scan``, the port runs a Python loop over
periods.  The paged serving path runs its own loop around the paged cache
and uses :func:`embed_inputs` / :func:`head_logits` as seams.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device

from .attention import KVCache, init_attention, init_kv_cache
from .blocks import block_decode, block_forward
from .common import dense_init, dtype_of, rms_norm, softcap
from .moe import init_ffn

__all__ = ["init_block", "init_params", "embed_inputs", "head_logits",
           "period_params", "forward", "init_cache", "decode_step",
           "prefill"]

Params = Dict[str, Any]


def init_block(cfg, blk, gen: torch.Generator, dtype, device) -> dict:
    if blk.mixer != "attn":
        raise NotImplementedError(
            "Mamba blocks are not ported yet (ROADMAP.md, Queue A item 10)")
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    p = {"ln1": zeros(), "attn": init_attention(cfg, gen, dtype, device)}
    if blk.has_ffn:
        p["ln2"] = zeros()
        p["ffn"] = init_ffn(cfg, blk.use_moe, gen, dtype, device)
    if cfg.use_post_norm:
        p["post_ln1"] = zeros()
        if blk.has_ffn:
            p["post_ln2"] = zeros()
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg, seed: int = 0,
                device: Optional[str] = None) -> Params:
    """Random parameters from ``seed`` (a ``torch.Generator`` on the CPU,
    so a seed gives the same weights on every device), placed on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator().manual_seed(seed)
    p: Params = {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                     dtype, dev, fan_in=cfg.d_model)}
    p["periods"] = tuple(
        _stack([init_block(cfg, blk, gen, dtype, dev)
                for _ in range(cfg.n_periods)])
        for blk in cfg.period)
    p["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
    if not cfg.tied_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                  dev, fan_in=cfg.d_model)
    return p


def embed_inputs(cfg, params: Params, inputs: torch.Tensor) -> torch.Tensor:
    """Token frontend: (B, L) int -> (B, L, D)."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            "the embeddings input stub is not ported yet (ROADMAP.md, "
            "Queue A item 10)")
    x = params["embed"][inputs.long()].to(dtype_of(cfg.compute_dtype))
    if cfg.scale_embedding:
        x = x * cfg.d_model ** 0.5
    return x


def head_logits(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head (tied: ``x @ embed.T``): (B, L, D) -> (B, L,
    V)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    return softcap(x @ w.to(x.dtype), cfg.final_softcap)


def period_params(params: Params, pi: int, dtype) -> tuple:
    """Period ``pi``'s block params: views into the stacked leaves, cast to
    the compute dtype (a no-op view when it already matches)."""
    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        return t[pi].to(dtype) if t.is_floating_point() else t[pi]
    return tuple(one(bp) for bp in params["periods"])


def forward(cfg, params: Params, inputs: torch.Tensor) -> torch.Tensor:
    """inputs: (B, L) int tokens -> logits (B, L, V).  With SPLS on, each
    block runs under its exact-top-k plan (``plan_mode="auto"``; the
    row-block plan from ``blocks._SPLS_CHUNK_THRESHOLD`` tokens on)."""
    dtype = dtype_of(cfg.compute_dtype)
    x = embed_inputs(cfg, params, inputs)
    for pi in range(cfg.n_periods):
        for blk, bp in zip(cfg.period, period_params(params, pi, dtype)):
            x = block_forward(cfg, blk, bp, x)
    return head_logits(cfg, params, x)


def init_cache(cfg, batch: int, max_len: int,
               device: Optional[str] = None) -> tuple:
    """One :class:`~repro_torch.models.attention.KVCache` per period block,
    stacked over periods: ``k / v (n_periods, B, KV, max_len, Dh)`` zeros
    in the compute dtype, on ``device`` (default: the card)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.compute_dtype)
    if any(blk.mixer != "attn" for blk in cfg.period):
        raise NotImplementedError(
            "Mamba blocks are not ported yet (ROADMAP.md, Queue A item 10)")
    return tuple(init_kv_cache(cfg, (cfg.n_periods, batch), max_len, dtype,
                               dev) for _ in cfg.period)


def decode_step(cfg, params: Params, cache: tuple, tokens: torch.Tensor,
                pos: torch.Tensor):
    """One decode step.  tokens: (B, 1) int; pos: (B,) int32 write index.

    Every layer writes the token's K/V at ``pos`` into ``cache`` **in
    place** (the reference threads a new cache through its scan).  Returns
    ``(logits (B, 1, V), cache)``.
    """
    dtype = dtype_of(cfg.compute_dtype)
    x = embed_inputs(cfg, params, tokens)
    for pi in range(cfg.n_periods):
        for blk, bp, c in zip(cfg.period, period_params(params, pi, dtype),
                              cache):
            x, _ = block_decode(cfg, blk, bp, x, KVCache(c.k[pi], c.v[pi]),
                                pos)
    return head_logits(cfg, params, x), cache


def prefill(cfg, params: Params, inputs: torch.Tensor,
            max_len: Optional[int] = None, plan_mode: str = "auto"):
    """Process a whole prompt: inputs (B, L) -> ``(logits (B, L, V),
    cache)`` with the cache as :func:`init_cache` lays it out, right-padded
    to ``max_len`` (default L).

    With SPLS on this is the paper's scenario: each block's plan is
    predicted before its QKV generation and the prompt runs sparsely
    (``plan_mode="progressive"``, the streaming-reproducible plan the
    serving engines use); the cache still holds every position.
    """
    L = inputs.shape[1]
    S = max_len or L
    dtype = dtype_of(cfg.compute_dtype)
    x = embed_inputs(cfg, params, inputs)
    per_period = []
    for pi in range(cfg.n_periods):
        caches = []
        for blk, bp in zip(cfg.period, period_params(params, pi, dtype)):
            x, c = block_forward(cfg, blk, bp, x, cache_len=S,
                                 plan_mode=plan_mode)
            caches.append(c)
        per_period.append(caches)
    cache = tuple(KVCache(k=torch.stack([cs[bi].k for cs in per_period]),
                          v=torch.stack([cs[bi].v for cs in per_period]))
                  for bi in range(len(cfg.period)))
    return head_logits(cfg, params, x), cache
