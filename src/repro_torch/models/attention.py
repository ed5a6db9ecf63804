"""GQA attention with RoPE, qk-norm, sliding window, logit soft-capping,
KV-cache decode and SPLS sparse execution.

Weights keep the reference's explicit (KV, G) structure (``G = n_heads //
n_kv_heads`` query heads per KV group): ``wq (D, KV, G, Dh)``, ``wk/wv (D,
KV, Dh)``, ``wo (KV, G, Dh, D)``.  :func:`head_shard_mode` picks how heads
bind to the model axis of the mesh that
:func:`repro_torch.sharding.axis_rules` installed, as the reference's does:

  * **structured** -- no mesh, or KV or G divides the model axis: q is
    ``(B, KV, G, L, Dh)``, k / v ``(B, KV, L, Dh)``.
  * **flat** -- neither divides but ``H = KV * G`` does (qwen3-0.6b,
    h2o-danube3, dbrx, jamba, pixtral on 16): heads flattened, q ``(B, H,
    1, L, Dh)``, the KV heads repeated per query head, k / v ``(B, H, L,
    Dh)``.
  * **padded** -- nothing divides (musicgen's 24 heads on 16): the heads
    are zero-padded to the next multiple of the axis, ``H'``; ``wk / wv``
    are repeated per head, so q is ``(B, H', 1, L, Dh)`` and k / v ``(B,
    H', L, Dh)``; the padded heads' ``wo`` rows are zero, so they add
    nothing to the output.  No SPLS plan is built in this mode.

Decode keeps the structured layout: it reads and writes a ``(B, KV, S,
Dh)`` cache.  The prefill cache of :func:`attention_forward` is structured
in the structured and flat layouts only; in the padded layout it holds the
``H'`` repeated and padded heads, as the reference's does, so a padded
prefill cannot be followed by :func:`attention_decode` (ROADMAP.md, Parity
rules).

The layouts only pick shapes: tensors stay plain, one global view on every
rank, so no logical-axis annotation is made on the activations.

:func:`attention_forward` (whole sequence, optionally returning the
prefill cache) and :func:`attention_decode` (one token against the
contiguous cache) dispatch through the backend registry
(:mod:`repro_torch.models.attn_backend`).  The paged serving path projects
Q/K/V and re-projects the attention output itself around its block-pool
cache, in the structured layout; :func:`project_qkv`, :func:`project_kv`
and :func:`output_proj` are its seams.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.spls import SparsityPlan
from repro_torch.core.spls_chunked import ChunkedPlan
from repro_torch.sharding.logical import _current_mesh, mesh_axis_sizes

from .attn_backend import get_backend, resolve_backend
from .common import apply_rope, dense_init, rms_norm, rope_freqs

__all__ = ["init_attention", "project_qkv", "project_kv", "output_proj",
           "KVCache", "init_kv_cache", "attention_forward",
           "attention_decode", "head_shard_mode"]


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


def _model_axis() -> int:
    mesh = _current_mesh()
    return 1 if mesh is None else mesh_axis_sizes(mesh).get("model", 1)


def head_shard_mode(cfg) -> str:
    """``"structured"`` | ``"flat"`` | ``"padded"`` under the installed
    mesh (module docstring); ``"structured"`` without one."""
    m = _model_axis()
    KV = cfg.n_kv_heads
    G = cfg.n_heads // max(KV, 1)
    if m <= 1 or KV % m == 0 or G % m == 0:
        return "structured"
    if cfg.n_heads % m == 0:
        return "flat"
    return "padded"


def _pad_heads_to(cfg) -> int:
    """The padded head count ``H'``: the next multiple of the model axis."""
    m = _model_axis()
    return -(-cfg.n_heads // m) * m


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


def _padded_weights(cfg, p: dict):
    """``wq / wk / wv (D, H', Dh)`` of the padded layout: ``wq`` zero-padded
    to ``H'`` heads, ``wk / wv`` repeated per query head and padded
    likewise (each padded head attends on its own)."""
    D, KV, Dh = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
    H = cfg.n_heads
    pad = (0, 0, 0, _pad_heads_to(cfg) - H)
    per_head = lambda w: F.pad(w.repeat_interleave(H // KV, dim=1), pad)
    return (F.pad(p["wq"].reshape(D, H, Dh), pad), per_head(p["wk"]),
            per_head(p["wv"]))


def project_qkv(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                mode: str = "structured"):
    """x (B, L, D), positions (B, L) -> q, k, v in ``mode``'s layout:
    structured q (B, KV, G, L, Dh), k/v (B, KV, L, Dh); flat / padded q
    (B, H', 1, L, Dh), k/v (B, H', L, Dh).  The flat layout is the
    structured products laid out flat (the KV heads repeated), so the two
    layouts compute alike bit for bit on every device."""
    Dh = cfg.resolved_head_dim
    if mode == "padded":
        wq, wk, wv = _padded_weights(cfg, p)
        q = torch.einsum("bld,dhe->bhle", x, wq)[:, :, None]
        k, v = _kv_rows(cfg, dict(p, wk=wk, wv=wv), x, positions)
    else:
        q = torch.einsum("bld,dkgh->bkglh", x, p["wq"])
        k, v = _kv_rows(cfg, p, x, positions)
        if mode == "flat":
            B, KV, G, L, _ = q.shape
            q = q.reshape(B, KV * G, 1, L, Dh)
            k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    sin, cos = rope_freqs(positions, Dh, cfg.rope_theta)
    q = apply_rope(q, sin[:, None, None], cos[:, None, None])
    return q, k, v


def project_kv(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
               mode: str = "structured", perm: Optional[torch.Tensor] = None,
               compute_backend: str = "dense"):
    """K/V-only projection: row-for-row the k/v half of
    :func:`project_qkv` (the packed serving prefill projects Q itself),
    in the structured layout.

    With ``perm`` (a packed column subset from the horizon-finalized prune
    vote, :mod:`repro_torch.core.planner`) the projection runs through
    :func:`repro_torch.sparse_compute.packed.packed_project_kv` on
    ``compute_backend``: only the ``C = len(perm)`` surviving columns are
    computed, ``(1, KV, C, Dh)`` out."""
    if mode != "structured":
        raise ValueError(f"head layout {mode!r}: the packed serving path "
                         f"keeps the structured layout")
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
    """o in ``mode``'s layout -> (B, L, D); a flat ``o`` goes through the
    structured product, a padded head's ``wo`` rows are zero."""
    if mode == "padded":
        H, Dh, D = cfg.n_heads, cfg.resolved_head_dim, cfg.d_model
        wo = F.pad(p["wo"].reshape(H, Dh, D),
                   (0, 0, 0, 0, 0, _pad_heads_to(cfg) - H))
        out = torch.einsum("bhld,hdm->blm", o[:, :, 0], wo)
    else:
        if mode == "flat":
            o = o.reshape(o.shape[0], *p["wo"].shape[:2], *o.shape[3:])
        out = torch.einsum("bkgld,kgdm->blm", o, p["wo"])
    return out


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
    mode = head_shard_mode(cfg)
    positions = torch.arange(L, device=x.device).expand(B, L)
    q, k, v = project_qkv(cfg, p, x, positions, mode)
    name = resolve_backend(backend or cfg.attn_backend, x.device, "forward",
                           plan, L=L, q_capacity=q_capacity)
    o = get_backend(name)(cfg, q, k, v, window=window, plan=plan,
                          q_capacity=q_capacity, kv_capacity=kv_capacity)
    out = output_proj(cfg, p, o, mode)
    if cache_len is not None:
        if mode == "flat":  # back to one copy of each KV head
            G = cfg.n_heads // cfg.n_kv_heads
            k, v = k[:, ::G], v[:, ::G]
        pad = (0, 0, 0, cache_len - L)
        return out, KVCache(k=F.pad(k, pad), v=F.pad(v, pad))
    return out


def attention_decode(cfg, p: dict, x: torch.Tensor, cache: KVCache,
                     pos: torch.Tensor, window: Optional[int] = None,
                     backend: Optional[str] = None):
    """One-token decode.  x: (B, 1, D); pos: (B,) current write index.

    Writes the token's K/V at slot ``pos`` of each row **in place** (one
    ``scatter_`` per cache tensor; the reference returns an updated copy)
    and attends over slots ``<= pos``, in the structured layout under any
    mesh, as the reference.  Returns ``(out (B, 1, D), cache)``.
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
