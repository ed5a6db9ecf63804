"""Attention backend registry of the port: forward, decode and paged-decode
sites.

Forward backends (whole sequence) share::

    fn(cfg, q, k, v, *, window, plan, q_capacity, kv_capacity) -> o

with ``q: (B, KV, G, L, Dh)``, ``k / v: (B, KV, L, Dh)``, ``o`` like ``q``.

  * ``torch_dense``   -- materialized scores; with a plan, the simulation-
    mode SPLS semantics (:func:`spls_attention`: leader-row recovery plus
    the full intra-row SPA mask).
  * ``torch_packed``  -- capacity-mode SPLS (:func:`spls_attention_packed`):
    critical rows and kept columns packed to static capacities, a masked
    softmax at the reduced size; without a plan, ``torch_dense``.
  * ``torch_chunked`` -- KV-chunked online softmax; with a plan,
    :func:`spls_attention_chunked` (packed rows and columns, index-based
    masks, no intra-row mask): the oracle of the flash backends under a
    plan.
  * ``torch_flash`` / ``cuda_flash`` -- :func:`repro_torch.kernels.
    flash_attention_plain` / the CUDA kernel :func:`repro_torch.kernels.
    flash_attention`, with the SPLS plan lowered to block sparsity as the
    reference's ``pallas_flash`` does: ``kv_keep`` feeds the kernel's keep
    mask (dead K tiles are skipped), critical Q rows are packed to a
    capacity rounded up to whole ``PALLAS_BLOCK_Q`` tiles, carried with
    their original positions (``q_pos``) and scattered back through the
    leader map.  The intra-row top-k mask is not applied.

Decode backends (one token, contiguous cache) share::

    fn(cfg, q, k, v, *, pos, window) -> o

with ``q: (B, KV, G, Dh)``, ``k / v: (B, KV, S, Dh)``, ``pos: (B,)``.

  * ``torch_dense_decode`` / ``torch_flash_decode`` -- one plain version,
    :func:`repro_torch.kernels.flash_decode_plain` (dense masked softmax
    over the whole cache).
  * ``cuda_flash_decode`` -- the CUDA kernel :func:`repro_torch.kernels.
    flash_decode`.

Paged decode backends (the serving engine's block-pool KV cache) share::

    fn(cfg, q, k_pages, v_pages, *, pos_pages, tables, kv_len, pos,
       window) -> o

with ``q: (B, KV, G, Dh)``, ``k/v_pages: (KV, N, ps, Dh)``, ``pos_pages:
(N, ps)``, ``tables: (B, P)``, ``kv_len / pos: (B,)``.

  * ``torch_paged_decode`` -- gather the block table into a contiguous
    view, then dense masked softmax.
  * ``cuda_paged_decode``  -- the CUDA kernel
    (:func:`repro_torch.kernels.paged_flash_decode`).

The reference package's names are aliases (``xla_dense``,
``xla_packed``, ``xla_chunked``, ``pallas_flash``, ``xla_dense_decode``,
``pallas_flash_decode``, ``xla_paged_decode``, ``pallas_paged_decode``),
so one ``ServeConfig`` drives both packages.  :func:`register_backend`
adds a backend to a site, as the reference's does, and
:func:`available_backends` lists them.

``"auto"`` resolves by the device of the tensors: the kernel on the card,
its plain version on the CPU, at every site -- except that the forward
site sends a long-sequence :class:`~repro_torch.core.spls_chunked.
ChunkedPlan` to ``torch_chunked`` on both devices, as the reference sends
it to ``xla_chunked`` even on a TPU (its only consumer with O(Cq *
chunk) memory; no kernel serves that route in either package).  Choosing
by device is the one deliberate difference from the reference's
``resolve_backend``, which picks ``xla_dense`` on a CPU -- a backend that
keeps the intra-row top-k mask the flash path drops.  Here the CPU and the
card compute the same function, and the CPU tests name the reference's
backend explicitly.

Training.  No kernel of either package has a backward: the reference's
Pallas kernels define no ``custom_vjp``, and ``jax.grad`` through its
``flash_attention`` fails in Pallas's JVP rule (an ``AssertionError`` in
``_pallas_call_jvp_rule``, jax 0.9.0), so the reference trains only
through its XLA backends.  ``torch_dense``, ``torch_packed`` and
``torch_chunked`` are their counterparts: registered backends of their
own, differentiable by autograd, and not the plain version of any kernel.
With a ``platform`` (the reference's argument, or
:func:`repro_torch.device.route_as`, which
:func:`repro_torch.launch.steps.make_loss_grad` sets to ``"cpu"``)
``"auto"`` follows the reference's rule for that platform on any device:
on ``"cpu"`` a ``ChunkedPlan`` -> ``torch_chunked``; a plan with reduced q
capacity -> ``torch_packed``; a plan -> ``torch_dense``;
``L > CHUNK_THRESHOLD`` -> ``torch_chunked``; otherwise ``torch_dense``;
decode sites the plain decodes.  A kernel backend named explicitly stays
the kernel, whose wrapper refuses inputs that need a gradient.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import route_platform
from repro_torch.sharding.logical import arange_like
from repro_torch.core.sparse_exec import (gather_rows, pack_by_mask,
                                          spls_attention,
                                          spls_attention_chunked,
                                          spls_attention_packed,
                                          unpack_by_leader)
from repro_torch.core.spls import SparsityPlan
from repro_torch.core.spls_chunked import ChunkedPlan
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 flash_decode, flash_decode_plain,
                                 paged_decode_plain, paged_flash_decode)

from .common import softcap as _softcap

__all__ = ["AUTO", "CHUNK_THRESHOLD", "FORWARD_BACKENDS", "DECODE_BACKENDS",
           "PAGED_DECODE_BACKENDS", "PALLAS_BLOCK_Q", "register_backend",
           "available_backends", "resolve_backend", "resolve_paged_backend",
           "get_backend", "site_backend"]

AUTO = "auto"
KV_CHUNK = 2048
# the reference's CPU "auto" chunks KV above this many tokens
CHUNK_THRESHOLD = 8192
# the reference's Pallas q tile: SPLS q packing rounds the capacity up to
# it, whatever tile the CUDA kernel uses, so both packages pack the same rows
PALLAS_BLOCK_Q = 128
_ALIASES = {"xla_dense": "torch_dense", "xla_packed": "torch_packed",
            "xla_chunked": "torch_chunked", "pallas_flash": "cuda_flash",
            "xla_dense_decode": "torch_dense_decode",
            "pallas_flash_decode": "cuda_flash_decode",
            "xla_paged_decode": "torch_paged_decode",
            "pallas_paged_decode": "cuda_paged_decode"}


# ---------------------------------------------------------------------------
# forward backends
# ---------------------------------------------------------------------------

def _band_mask(L: int, window: Optional[int], causal: bool,
               like: torch.Tensor) -> torch.Tensor:
    """(L, L) attention band, made as ``like`` is (:func:`arange_like`)."""
    i = arange_like(like, L)[:, None]
    j = arange_like(like, L)[None, :]
    m = (j <= i) if causal else torch.ones_like(j == i)
    if window is not None:
        m = m & (i - j < window) & (j - i < (1 if causal else window))
    return m


def _with_plan_kv(q, k, v):
    B, KV, G, L, Dh = q.shape
    return (k[:, :, None].expand(B, KV, G, L, Dh),
            v[:, :, None].expand(B, KV, G, L, Dh))


def _window_plan(plan: SparsityPlan, L: int, window: Optional[int],
                 causal: bool) -> SparsityPlan:
    """Intersect a block's sliding window into the plan's mask, so SPLS +
    SWA means the same on every backend."""
    if window is None:
        return plan
    return plan._replace(attn_mask=plan.attn_mask & _band_mask(
        L, window, causal, plan.attn_mask))


def torch_dense(cfg, q, k, v, *, window=None, plan=None, q_capacity=None,
                kv_capacity=None) -> torch.Tensor:
    L, Dh = q.shape[-2], q.shape[-1]
    if plan is not None:
        kr, vr = _with_plan_kv(q, k, v)
        plan = _window_plan(plan, L, window, cfg.causal)
        return spls_attention(q, kr, vr, plan, Dh ** -0.5, cfg.attn_softcap)
    s = torch.einsum("bkgqd,bkld->bkgql", q, k) * Dh ** -0.5
    s = _softcap(s, cfg.attn_softcap)
    m = _band_mask(L, window, cfg.causal, q)
    s = s.masked_fill(~m, -1e30)
    a = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bkgql,bkld->bkgqd", a, v)


def torch_packed(cfg, q, k, v, *, window=None, plan=None, q_capacity=None,
                 kv_capacity=None) -> torch.Tensor:
    if plan is None:    # nothing to pack: the dense scores
        return torch_dense(cfg, q, k, v, window=window)
    L, Dh = q.shape[-2], q.shape[-1]
    kr, vr = _with_plan_kv(q, k, v)
    plan = _window_plan(plan, L, window, cfg.causal)
    return spls_attention_packed(q, kr, vr, plan, q_capacity or L,
                                 kv_capacity or L, Dh ** -0.5,
                                 cfg.attn_softcap)


def torch_chunked(cfg, q, k, v, *, window=None, plan=None, q_capacity=None,
                  kv_capacity=None) -> torch.Tensor:
    B, KV, G, L, Dh = q.shape
    if plan is not None:
        return spls_attention_chunked(q, k, v, plan, q_capacity or L,
                                      min(kv_capacity or L, L), Dh ** -0.5,
                                      cfg.attn_softcap, kv_chunk=KV_CHUNK,
                                      causal=cfg.causal, window=window)
    C = min(KV_CHUNK, L)
    pad = (-L) % C
    if pad:     # ragged tail: padded columns are masked by `kj < L`
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    qi = arange_like(q, L)[:, None]
    # made like q, so that a DTensor q lays them out as its own
    m_run = torch.full_like(q[..., 0], -1e30, dtype=torch.float32)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros_like(q, dtype=torch.float32)
    for c0 in range(0, L + pad, C):
        k_c, v_c = k[:, :, c0:c0 + C], v[:, :, c0:c0 + C]
        s = torch.einsum("bkgqd,bkld->bkgql", q, k_c).float() * Dh ** -0.5
        s = _softcap(s, cfg.attn_softcap)
        kj = c0 + arange_like(q, C)[None, :]
        mask = (kj < L).expand(L, C)
        if cfg.causal:
            mask = mask & (kj <= qi)
        if window is not None:
            mask = mask & (qi - kj < window)
            if not cfg.causal:
                mask = mask & (kj - qi < window)
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m_run, s.amax(-1))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None]) * mask.float()
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgql,bkld->bkgqd", p.to(v_c.dtype), v_c).float()
        m_run = m_new
    return (acc / l_run.clamp(min=1e-9)[..., None]).to(q.dtype)


def _flash(attn: Callable, cfg, q, k, v, window, plan, q_capacity):
    """The reference's ``pallas_flash`` lowering around ``attn`` (the
    kernel or its plain version)."""
    B, KV, G, L, Dh = q.shape
    H = KV * G
    # the kernel computes in float32 (float64 inside): a bf16 model casts
    # on the way in and back out, as the Pallas kernel casts on load and
    # stores in q's dtype
    qf = q.reshape(B, H, L, Dh).float()
    k, v = k.float().contiguous(), v.float().contiguous()
    kw = dict(causal=cfg.causal, window=window, softcap=cfg.attn_softcap)
    if plan is None:
        return attn(qf.contiguous(), k, v, **kw).reshape(
            B, KV, G, L, Dh).to(q.dtype)
    # SPLS plan -> block sparsity: kv_keep feeds the keep mask (dead K
    # tiles skipped); critical Q rows are packed to a capacity rounded up
    # to whole reference q tiles, carried with their original positions,
    # and leader-recovered after the call
    crit = plan.q_critical.reshape(B, H, L)
    keep = plan.kv_keep.reshape(B, H, L).contiguous()
    leader = plan.q_leader.reshape(B, H, L)
    bq = min(PALLAS_BLOCK_Q, L)
    Cq = min(q_capacity or L, L)
    Cq = min(L, -(-Cq // bq) * bq)
    q_perm, q_slot = pack_by_mask(crit, Cq)
    qp = gather_rows(qf, q_perm)
    op = attn(qp, k, v, kv_keep=keep, q_pos=q_perm.contiguous(), **kw)
    return unpack_by_leader(op, q_slot, leader).reshape(
        B, KV, G, L, Dh).to(q.dtype)


def torch_flash(cfg, q, k, v, *, window=None, plan=None, q_capacity=None,
                kv_capacity=None) -> torch.Tensor:
    return _flash(flash_attention_plain, cfg, q, k, v, window, plan,
                  q_capacity)


def cuda_flash(cfg, q, k, v, *, window=None, plan=None, q_capacity=None,
               kv_capacity=None) -> torch.Tensor:
    return _flash(flash_attention, cfg, q, k, v, window, plan, q_capacity)


# ---------------------------------------------------------------------------
# decode backends
# ---------------------------------------------------------------------------

def torch_flash_decode(cfg, q, k, v, *, pos, window=None) -> torch.Tensor:
    return flash_decode_plain(q, k, v, pos.to(torch.int32),
                              softcap=cfg.attn_softcap, window=window)


def cuda_flash_decode(cfg, q, k, v, *, pos, window=None) -> torch.Tensor:
    # the kernel takes a ragged S: no pad to the reference's block_k
    return flash_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                        pos.to(torch.int32).contiguous(),
                        softcap=cfg.attn_softcap, window=window)


# ---------------------------------------------------------------------------
# paged decode backends
# ---------------------------------------------------------------------------

def torch_paged_decode(cfg, q, k_pages, v_pages, *, pos_pages, tables,
                       kv_len, pos, window=None) -> torch.Tensor:
    return paged_decode_plain(q, k_pages, v_pages, pos_pages, tables,
                              kv_len, pos, softcap=cfg.attn_softcap,
                              window=window)


def cuda_paged_decode(cfg, q, k_pages, v_pages, *, pos_pages, tables,
                      kv_len, pos, window=None) -> torch.Tensor:
    return paged_flash_decode(q, k_pages, v_pages, pos_pages, tables,
                              kv_len, pos, softcap=cfg.attn_softcap,
                              window=window)


FORWARD_BACKENDS: Dict[str, Callable] = {
    "torch_dense": torch_dense, "torch_packed": torch_packed,
    "torch_chunked": torch_chunked, "torch_flash": torch_flash,
    "cuda_flash": cuda_flash}
# one plain decode: the dense masked softmax over j <= pos (and the
# window) is the flash kernel's plain version too
DECODE_BACKENDS: Dict[str, Callable] = {
    "torch_dense_decode": torch_flash_decode,
    "torch_flash_decode": torch_flash_decode,
    "cuda_flash_decode": cuda_flash_decode}
PAGED_DECODE_BACKENDS: Dict[str, Callable] = {
    "torch_paged_decode": torch_paged_decode,
    "cuda_paged_decode": cuda_paged_decode}
_SITES = {"forward": FORWARD_BACKENDS, "decode": DECODE_BACKENDS,
          "paged_decode": PAGED_DECODE_BACKENDS}
# auto: (on the card, on the CPU)
_AUTO = {"forward": ("cuda_flash", "torch_flash"),
         "decode": ("cuda_flash_decode", "torch_flash_decode"),
         "paged_decode": ("cuda_paged_decode", "torch_paged_decode")}


def _site_key(decode: bool, paged: bool) -> str:
    return ("paged_decode" if paged else "decode") if decode else "forward"


def register_backend(name: str, decode: bool = False, paged: bool = False,
                     doc: str = "") -> Callable:
    """Decorator registering ``fn`` under ``name`` at the forward site, or
    with ``decode`` at the decode site (``paged`` too: the paged-decode
    site), with the signature of that site (module docstring); the name
    then resolves through :func:`get_backend` and :func:`resolve_backend`
    like a built-in one.  A ``doc`` becomes ``fn``'s docstring."""

    def deco(fn: Callable) -> Callable:
        _SITES[_site_key(decode, paged)][name] = fn
        fn.__doc__ = doc or fn.__doc__
        return fn

    return deco


def available_backends(decode: Optional[bool] = None,
                       paged: Optional[bool] = None) -> Tuple[str, ...]:
    """Registered backend names, optionally filtered by decode / paged-ness
    (a paged backend is a decode backend, as in the reference)."""
    names = []
    for site, reg in _SITES.items():
        d, pg = site != "forward", site == "paged_decode"
        if (decode is None or d == decode) and (paged is None or pg == paged):
            names.extend(reg)
    return tuple(sorted(names))


def _canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def _site_of(name: str) -> str:
    for site, reg in _SITES.items():
        if name in reg:
            return site
    known = sorted(set().union(*_SITES.values()))
    raise ValueError(f"unknown attention backend {name!r}; registered: "
                     f"{known} (aliases {sorted(_ALIASES)})")


def site_backend(name: Optional[str], site: str = "paged_decode") -> str:
    """Route an ``attn_backend`` name to one call site (``"forward"``,
    ``"decode"`` or ``"paged_decode"``).  One config field drives every
    site an engine has: a name of this site (or its alias) is taken, a
    name of another site leaves this site on ``"auto"``, an unknown name
    raises."""
    if name is None or name == AUTO:
        return AUTO
    name = _canonical(name)
    return name if _site_of(name) == site else AUTO


# auto under the reference's non-TPU rule (the plan-free forward choice
# depends on L)
_AUTO_XLA = {"decode": "torch_dense_decode",
             "paged_decode": "torch_paged_decode"}


def resolve_backend(name: Optional[str], device,
                    site: str = "forward", plan=None, *,
                    L: Optional[int] = None,
                    q_capacity: Optional[int] = None,
                    platform: Optional[str] = None) -> str:
    """Concrete backend of ``site`` for tensors on ``device`` (and, at the
    forward site, the block's ``plan``, length ``L`` and ``q_capacity``).
    ``platform`` (default: :func:`repro_torch.device.route_platform`)
    applies the reference's rule for that platform instead of choosing by
    device (module docstring).  A name of another site falls back to this
    site's auto choice with a ``RuntimeWarning`` (Python shows it once per
    name and site), as in the reference, so a mistyped override cannot
    silently run another backend."""
    routed = site_backend(name, site)
    if routed != AUTO:
        return routed
    if name not in (None, AUTO):
        warnings.warn(f"configured attention backend {name!r} is a "
                      f"{_site_of(_canonical(name))} backend but this is a "
                      f"{site} site; falling back to the auto choice for "
                      f"this site", RuntimeWarning, stacklevel=2)
    if site == "forward" and isinstance(plan, ChunkedPlan):
        return "torch_chunked"
    platform = platform or route_platform()
    if platform is None:
        on_card, on_cpu = _AUTO[site]
        return on_card if torch.device(device).type == "cuda" else on_cpu
    if platform in ("tpu", "cuda"):
        return _AUTO[site][0]
    if site != "forward":
        return _AUTO_XLA[site]
    if plan is not None:
        if q_capacity is not None and L is not None and q_capacity < L:
            return "torch_packed"
        return "torch_dense"
    if L is not None and L > CHUNK_THRESHOLD:
        return "torch_chunked"
    return "torch_dense"


def resolve_paged_backend(name: Optional[str], device) -> str:
    """Concrete paged-decode backend for tensors on ``device``; a name of
    another site resolves ``"auto"`` without a warning (the paged engine's
    one config field also names its forward backend)."""
    name = site_backend(name, "paged_decode")
    return resolve_backend(name, device, "paged_decode")


def get_backend(name: str) -> Callable:
    name = _canonical(name)
    return _SITES[_site_of(name)][name]
