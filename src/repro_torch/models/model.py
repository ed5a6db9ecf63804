"""Parameters, embedding frontend and LM head of the token model.

The layer stack is ``cfg.period`` (a tuple of blocks) repeated
``cfg.n_periods`` times.  Parameters keep the reference's tree: period
leaves are stacked on a leading ``(n_periods, ...)`` axis, so bridging
weights from the reference package is a plain copy
(:func:`repro_torch.weights.params_from_jax`).  The serving path runs its
own loop over periods around the paged cache; whole-sequence ``forward``
and ``prefill`` wait for a later slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device

from .attention import init_attention
from .common import dense_init, dtype_of, rms_norm, softcap
from .moe import init_ffn

__all__ = ["init_block", "init_params", "embed_inputs", "head_logits"]

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
