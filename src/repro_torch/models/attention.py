"""GQA attention projections with RoPE and qk-norm (structured layout).

Weights keep the reference's explicit (KV, G) structure (``G = n_heads //
n_kv_heads`` query heads per KV group): ``wq (D, KV, G, Dh)``, ``wk/wv (D,
KV, Dh)``, ``wo (KV, G, Dh, D)``.  On one card the reference picks the
*structured* head layout, so that is the only one ported.  The paged
serving path projects Q/K/V and re-projects the attention output itself
around its block-pool cache; these are its seams.
"""

from __future__ import annotations

import torch

from .common import apply_rope, dense_init, rms_norm, rope_freqs

__all__ = ["init_attention", "project_qkv", "project_kv", "output_proj"]


def _check_mode(mode: str) -> None:
    if mode != "structured":
        raise NotImplementedError(
            f"head layout {mode!r}: only the structured layout is ported")


def init_attention(cfg, gen: torch.Generator, dtype, device) -> dict:
    D, KV, Dh = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // KV
    p = {
        "wq": dense_init(gen, (D, KV, G, Dh), dtype, device, fan_in=D),
        "wk": dense_init(gen, (D, KV, Dh), dtype, device, fan_in=D),
        "wv": dense_init(gen, (D, KV, Dh), dtype, device, fan_in=D),
        "wo": dense_init(gen, (KV, G, Dh, D), dtype, device,
                         fan_in=KV * G * Dh),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((Dh,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((Dh,), dtype=dtype, device=device)
    return p


def _kv_rows(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """x (B, L, D) -> k/v (B, KV, L, Dh), k normed and RoPE'd."""
    Dh = cfg.resolved_head_dim
    k = torch.einsum("bld,dkh->bklh", x, p["wk"])
    v = torch.einsum("bld,dkh->bklh", x, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    sin, cos = rope_freqs(positions, Dh, cfg.rope_theta)
    k = apply_rope(k, sin[:, None], cos[:, None])
    return k, v


def project_qkv(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                mode: str = "structured"):
    """x (B, L, D), positions (B, L) -> q (B, KV, G, L, Dh), k/v (B, KV,
    L, Dh)."""
    _check_mode(mode)
    Dh = cfg.resolved_head_dim
    q = torch.einsum("bld,dkgh->bkglh", x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    sin, cos = rope_freqs(positions, Dh, cfg.rope_theta)
    q = apply_rope(q, sin[:, None, None], cos[:, None, None])
    k, v = _kv_rows(cfg, p, x, positions)
    return q, k, v


def project_kv(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
               mode: str = "structured"):
    """K/V-only projection: row-for-row the k/v half of
    :func:`project_qkv` (the packed serving prefill projects Q itself)."""
    _check_mode(mode)
    return _kv_rows(cfg, p, x, positions)


def output_proj(cfg, p: dict, o: torch.Tensor,
                mode: str = "structured") -> torch.Tensor:
    """o (B, KV, G, L, Dh) -> (B, L, D)."""
    _check_mode(mode)
    return torch.einsum("bkgld,kgdm->blm", o, p["wo"])
