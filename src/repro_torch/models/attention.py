"""GQA attention with RoPE, qk-norm, sliding window, logit soft-capping,
KV-cache decode and SPLS sparse execution (structured layout).

Weights keep the reference's explicit (KV, G) structure (``G = n_heads //
n_kv_heads`` query heads per KV group): ``wq (D, KV, G, Dh)``, ``wk/wv (D,
KV, Dh)``, ``wo (KV, G, Dh, D)``.  On one card the reference picks the
*structured* head layout, so that is the only one ported.

:func:`attention_forward` (whole sequence, optionally returning the
prefill cache) and :func:`attention_decode` (one token against the
contiguous cache) dispatch through the backend registry
(:mod:`repro_torch.models.attn_backend`).  The paged serving path projects
Q/K/V and re-projects the attention output itself around its block-pool
cache; :func:`project_qkv`, :func:`project_kv` and :func:`output_proj` are
its seams.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.spls import SparsityPlan
from repro_torch.core.spls_chunked import ChunkedPlan

from .attn_backend import get_backend, resolve_backend
from .common import apply_rope, dense_init, rms_norm, rope_freqs

__all__ = ["init_attention", "project_qkv", "project_kv", "output_proj",
           "KVCache", "init_kv_cache", "attention_forward",
           "attention_decode"]


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, KV, S_max, Dh)
    v: torch.Tensor       # (B, KV, S_max, Dh)


def init_kv_cache(cfg, batch, max_len: int, dtype, device) -> KVCache:
    """Zeros ``(*batch, KV, max_len, Dh)``; ``batch`` is an int or a tuple
    of leading dims (the model stacks one cache per period)."""
    lead = tuple(batch) if isinstance(batch, tuple) else (batch,)
    shape = lead + (cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


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
               mode: str = "structured", perm: Optional[torch.Tensor] = None,
               compute_backend: str = "dense"):
    """K/V-only projection: row-for-row the k/v half of
    :func:`project_qkv` (the packed serving prefill projects Q itself).

    With ``perm`` (a packed column subset from the horizon-finalized prune
    vote, :mod:`repro_torch.core.planner`) the projection runs through
    :func:`repro_torch.sparse_compute.packed.packed_project_kv` on
    ``compute_backend``: only the ``C = len(perm)`` surviving columns are
    computed, ``(1, KV, C, Dh)`` out."""
    _check_mode(mode)
    if perm is not None:
        from repro_torch.sparse_compute.packed import packed_project_kv
        if x.shape[0] != 1:
            raise ValueError("the packed K/V projection is per sequence "
                             f"(batch 1), got batch {x.shape[0]}")
        return packed_project_kv(cfg, p, x, positions.reshape(-1), perm,
                                 compute_backend)
    return _kv_rows(cfg, p, x, positions)


def output_proj(cfg, p: dict, o: torch.Tensor,
                mode: str = "structured") -> torch.Tensor:
    """o (B, KV, G, L, Dh) -> (B, L, D)."""
    _check_mode(mode)
    return torch.einsum("bkgld,kgdm->blm", o, p["wo"])


def attention_forward(cfg, p: dict, x: torch.Tensor,
                      window: Optional[int] = None,
                      plan: Optional[Union[SparsityPlan, ChunkedPlan]] = None,
                      q_capacity: Optional[int] = None,
                      kv_capacity: Optional[int] = None,
                      cache_len: Optional[int] = None,
                      backend: Optional[str] = None):
    """Whole-sequence attention.  x: (B, L, D) -> (B, L, D).

    With ``cache_len`` also returns the right-padded :class:`KVCache`
    ``(B, KV, cache_len, Dh)`` (prefill).  ``backend`` overrides
    ``cfg.attn_backend`` (see :mod:`repro_torch.models.attn_backend`).
    """
    B, L, _ = x.shape
    positions = torch.arange(L, device=x.device).expand(B, L)
    q, k, v = project_qkv(cfg, p, x, positions)
    name = resolve_backend(backend or cfg.attn_backend, x.device, "forward",
                           plan, L=L, q_capacity=q_capacity)
    o = get_backend(name)(cfg, q, k, v, window=window, plan=plan,
                          q_capacity=q_capacity, kv_capacity=kv_capacity)
    out = output_proj(cfg, p, o)
    if cache_len is not None:
        pad = (0, 0, 0, cache_len - L)
        return out, KVCache(k=F.pad(k, pad), v=F.pad(v, pad))
    return out


def attention_decode(cfg, p: dict, x: torch.Tensor, cache: KVCache,
                     pos: torch.Tensor, window: Optional[int] = None,
                     backend: Optional[str] = None):
    """One-token decode.  x: (B, 1, D); pos: (B,) current write index.

    Writes the token's K/V at slot ``pos`` of each row **in place** (one
    ``scatter_`` per cache tensor; the reference returns an updated copy)
    and attends over slots ``<= pos``.  Returns ``(out (B, 1, D),
    cache)``.
    """
    B = x.shape[0]
    S = cache.k.shape[2]
    q, k_new, v_new = project_qkv(cfg, p, x, pos[:, None])
    # the reference's dynamic_update_slice clamps the start into range
    idx = pos.long().clamp(0, S - 1).view(B, 1, 1, 1).expand_as(k_new)
    cache.k.scatter_(2, idx, k_new.to(cache.k.dtype))
    cache.v.scatter_(2, idx, v_new.to(cache.v.dtype))
    name = resolve_backend(backend or cfg.attn_backend, x.device, "decode")
    o = get_backend(name)(cfg, q[:, :, :, 0], cache.k, cache.v, pos=pos,
                          window=window)
    return output_proj(cfg, p, o[:, :, :, None]), cache
