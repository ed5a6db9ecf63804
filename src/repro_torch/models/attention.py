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

On plain tensors (one global view on every rank) the layouts only pick
shapes and ``constrain`` returns its input; on the ``DTensor``s of the dry
run (:mod:`repro_torch.launch.dryrun`) ``constrain`` lays q / k / v and
the output out where the reference constrains them, and the attention
itself runs on each device's (batch, head) shards (:func:`_per_head`).

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
from repro_torch.sharding.logical import (_current_mesh, constrain,
                                         from_local, head_placements,
                                         is_dtensor, mesh_axis_sizes)

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


def flat_kv_share(n_heads: int, G: int) -> int:
    """On ``DTensor``s in the flat layout: how many of a device's heads
    share one KV head (h2o-danube3's 2 of G 4 on 16 devices), 1 where a
    device's heads span KV groups.  The KV weights are repeated ``G /
    share`` times before the product and its result widened ``share``
    times after (:func:`widen_heads`), so each device projects its KV
    head once."""
    per_dev = n_heads // _model_axis()
    return per_dev if G % per_dev == 0 else 1


def widen_heads(t: torch.Tensor, e: int) -> torch.Tensor:
    """(B, C, L, Dh) -> (B, C * e, L, Dh), each head repeated ``e`` times
    in place (a shard of the C heads stays a plain shard)."""
    if e == 1:
        return t
    B, C, L, Dh = t.shape
    return t[:, :, None].expand(B, C, e, L, Dh).reshape(B, C * e, L, Dh)


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


def _kv_rows(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
             names=("batch", "kv_heads", "seq", None)):
    """x (B, L, D) -> k/v (B, KV, L, Dh), k normed and RoPE'd; ``names``
    lay k / v out on a mesh (the reference's constraint)."""
    Dh = cfg.resolved_head_dim
    k = constrain(torch.einsum("bld,dkh->bklh", x, p["wk"]), names)
    v = constrain(torch.einsum("bld,dkh->bklh", x, p["wv"]), names)
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
    (B, H', 1, L, Dh), k/v (B, H', L, Dh).  On plain tensors the flat
    layout is the structured products laid out flat (the KV heads
    repeated), so the two layouts compute alike bit for bit on every
    device.  On ``DTensor``s (the dry run) it is the reference's flat
    program instead: q through the (H, Dh) product and k / v through
    per-head weights (``wk`` / ``wv`` repeated over the G heads of a group
    before the product), each device projecting its own heads.  So the dry
    run counts that program, not the plain flat one: the two agree up to
    rounding, not bit for bit, and an SPLS plan may differ at a
    near-tie."""
    Dh = cfg.resolved_head_dim
    heads = ("batch", "heads", "seq", None)
    if mode == "padded" or (mode == "flat" and is_dtensor(x)):
        # a DTensor's flat heads are the reference's product over (H, Dh)
        # (its head axis cannot unflatten into (KV, G) on the model axis);
        # on DTensors the weights are laid out by head first, so that each
        # device projects its own heads (XLA moves the constraint on q / k
        # / v into the product)
        e = 1
        if mode == "padded":
            ws = _padded_weights(cfg, p)
        else:
            # a device's heads within one KV group (h2o-danube3's 2 of G 4)
            # share one copy of the group's k / v, widened to them after
            # the product: each device projects its KV head once
            G = cfg.n_heads // cfg.n_kv_heads
            e = flat_kv_share(cfg.n_heads, G)
            ws = (p["wq"].reshape(cfg.d_model, cfg.n_heads, Dh),
                  *(p[w].repeat_interleave(G // e, 1) for w in ("wk", "wv")))
        wq, wk, wv = (constrain(w, (None, "heads", None)) for w in ws)
        q = constrain(torch.einsum("bld,dhe->bhle", x, wq), heads)[:, :, None]
        k, v = _kv_rows(cfg, dict(p, wk=wk, wv=wv), x, positions, heads)
        k, v = widen_heads(k, e), widen_heads(v, e)
    else:
        m = _model_axis()
        if is_dtensor(x) and cfg.n_kv_heads % m and (
                cfg.n_heads // cfg.n_kv_heads) % m == 0:
            # query groups on the model axis (llama3's G 16 over 16): the
            # product with the groups outermost, so that a shard of them
            # stays a plain shard when the einsum flattens (G, KV, Dh) and
            # each device projects its own groups (with KV outermost
            # ``DTensor`` gathers ``wq`` and every device projects them all)
            q = torch.einsum("bld,dgkh->bgklh", x,
                             p["wq"].transpose(1, 2)).transpose(1, 2)
        else:
            q = torch.einsum("bld,dkgh->bkglh", x, p["wq"])
        q = constrain(q, ("batch", "kv_heads", "qgroups", "seq", None))
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
    structured product (a flat ``DTensor`` through the reference's product
    over (H, Dh)), a padded head's ``wo`` rows are zero."""
    if mode == "padded" or (mode == "flat" and is_dtensor(o)):
        H, Dh, D = cfg.n_heads, cfg.resolved_head_dim, cfg.d_model
        wo = p["wo"].reshape(H, Dh, D)
        if mode == "padded":
            wo = F.pad(wo, (0, 0, 0, 0, 0, _pad_heads_to(cfg) - H))
        # laid out by head, as o: each device multiplies its own heads, and
        # so does the product's backward
        wo = constrain(wo, ("heads", None, None))
        if is_dtensor(o):
            # one product over (H, Dh), heads outermost: a shard of the
            # heads stays a plain shard (einsum's flattening would stride it)
            B, Hp, _, L, _ = o.shape
            out = o[:, :, 0].permute(0, 2, 1, 3).reshape(B, L, Hp * Dh) \
                @ wo.reshape(Hp * Dh, D)
        else:
            out = torch.einsum("bhld,hdm->blm", o[:, :, 0], wo)
    elif is_dtensor(o) and o.shape[-1] % _model_axis():
        # a DTensor's einsum lays a partial sum over the model axis out on
        # Dh before it flattens (KV, G, Dh); a Dh that the axis does not
        # divide (h2o-danube3's 120 on 16) cannot flatten so.  One product
        # over (KV, G, Dh), heads outermost, as the reference's program has
        B, KV, G, L, Dh = o.shape
        out = o.permute(0, 3, 1, 2, 4).reshape(B, L, KV * G * Dh) \
            @ p["wo"].reshape(KV * G * Dh, -1)
    else:
        if mode == "flat":
            o = o.reshape(o.shape[0], *p["wo"].shape[:2], *o.shape[3:])
        out = torch.einsum("bkgld,kgdm->blm", o, p["wo"])
    return constrain(out, ("batch", "seq", "embed"))


def _per_head(fn, q, k, v, plan):
    """``fn(q, k, v, plan) -> o`` (like q) on ``DTensor``s: attention is
    local to its (batch, head) rows, so each device runs ``fn`` on its own
    shards -- q's batch and head dims keep their mesh axes, the sequence
    and feature dims are gathered whole, k / v and the plan's per-head
    fields are laid out as q -- and ``o`` is q's layout.  (Op by op,
    ``DTensor`` would plan a redistribution for every product of the
    chunk loop.)"""
    mesh = q.device_mesh
    head, kv = head_placements(q)

    def local(t, pl):
        return t.redistribute(mesh, pl).to_local()

    if plan is not None:
        plan = type(plan)(*(
            local(t, head) if is_dtensor(t) and tuple(t.shape[:3])
            == tuple(q.shape[:3]) else t for t in plan))
    o = fn(local(q, head), local(k, kv), local(v, kv), plan)
    return from_local(o, mesh, head, q.shape)


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
    if is_dtensor(x):   # laid out as x's rows, not whole on every device
        positions = torch.zeros_like(x[..., 0], dtype=torch.long) + positions
    q, k, v = project_qkv(cfg, p, x, positions, mode)
    name = resolve_backend(backend or cfg.attn_backend, x.device, "forward",
                           plan, L=L, q_capacity=q_capacity)
    fn = lambda q, k, v, plan: get_backend(name)(
        cfg, q, k, v, window=window, plan=plan, q_capacity=q_capacity,
        kv_capacity=kv_capacity)
    o = _per_head(fn, q, k, v, plan) if is_dtensor(q) else fn(q, k, v, plan)
    out = output_proj(cfg, p, o, mode)
    if cache_len is not None:
        if mode == "flat":  # back to one copy of each KV head
            if is_dtensor(k):
                # heads over the model axis -> the sequence (an
                # all-to-all), so that the copies drop without a gather
                k, v = (constrain(t, ("batch", None, "act_seq", None))
                        for t in (k, v))
            G = cfg.n_heads // cfg.n_kv_heads
            k, v = k[:, ::G], v[:, ::G]
        if is_dtensor(k) and cache_len == L:
            return out, KVCache(k=k, v=v)
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
    slot = pos.long().clamp(0, S - 1)
    if is_dtensor(cache.k):
        # DTensor has no in-place scatter on a sequence-sharded cache: the
        # write is a select against the slot, copied back in place
        hit = (torch.arange(S, device=x.device) == slot[:, None])
        hit = hit[:, None, :, None]
        cache.k.copy_(torch.where(hit, k_new.to(cache.k.dtype), cache.k))
        cache.v.copy_(torch.where(hit, v_new.to(cache.v.dtype), cache.v))
    else:
        idx = slot.view(B, 1, 1, 1).expand_as(k_new)
        cache.k.scatter_(2, idx, k_new.to(cache.k.dtype))
        cache.v.scatter_(2, idx, v_new.to(cache.v.dtype))
    name = resolve_backend(backend or cfg.attn_backend, x.device, "decode")
    o = get_backend(name)(cfg, q[:, :, :, 0], cache.k, cache.v, pos=pos,
                          window=window)
    return output_proj(cfg, p, o[:, :, :, None]), cache
