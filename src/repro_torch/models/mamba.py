"""Mamba2 (SSD -- state-space duality) mixer: chunked scan and decode step.

Follows the minimal SSD formulation of Dao & Gu (arXiv:2405.21060), as
the reference does: the selective state-space recurrence is computed
chunk by chunk as (i) an intra-chunk "attention-like" quadratic term and
(ii) an inter-chunk recurrence over per-chunk final states (a Python loop
where the reference scans).  B / C are shared across heads (ngroups = 1).
The recurrent state stays float32 whatever the compute dtype; decode keeps
a constant-size state per sequence.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.logical import constrain

from .common import dense_init, rms_norm

__all__ = ["init_mamba", "mamba_forward", "mamba_decode", "MambaCache",
           "init_mamba_cache", "ssd_chunked"]


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, conv_channels, W)   rolling conv window
    ssd: torch.Tensor    # (B, H, P, N)            recurrent state, float32


def init_mamba_cache(cfg, batch, dtype, device) -> MambaCache:
    """Zeros; ``batch`` is an int or a tuple of leading dims (the model
    stacks one cache per period)."""
    lead = tuple(batch) if isinstance(batch, tuple) else (batch,)
    di, n = cfg.d_inner, cfg.ssm_state
    h, p = cfg.mamba_nheads, cfg.mamba_headdim
    return MambaCache(
        conv=torch.zeros(lead + (di + 2 * n, cfg.conv_width), dtype=dtype,
                         device=device),
        ssd=torch.zeros(lead + (h, p, n), dtype=torch.float32,
                        device=device))


def init_mamba(cfg, gen: torch.Generator, dtype, device) -> dict:
    D, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.mamba_nheads
    proj_out = 2 * di + 2 * n + h  # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, (D, proj_out), dtype, device, fan_in=D),
        "conv_w": dense_init(gen, (di + 2 * n, cfg.conv_width), dtype,
                             device, fan_in=cfg.conv_width),
        "conv_b": torch.zeros((di + 2 * n,), dtype=dtype, device=device),
        "A_log": torch.zeros((h,), **f32),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "gate_norm": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (di, D), dtype, device, fan_in=di),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    """-> z, xc = [x | B | C] (the conv channels), dt."""
    di, n = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j < t <= i}
    x[t], ``-inf`` above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x: (b,l,h,p); dt: (b,l,h); A: (h,); B,C: (b,l,n).

    Returns (y (b,l,h,p), final_state (b,h,p,n)).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    nc, cl = l // chunk, chunk

    xdt = x * dt[..., None]
    dA = (dt * A).reshape(b, nc, cl, h).permute(0, 3, 1, 2)  # (b,h,nc,cl)
    dA_cs = torch.cumsum(dA, dim=-1)

    xc = xdt.reshape(b, nc, cl, h, p)
    Bc = B.reshape(b, nc, cl, n)
    Cc = C.reshape(b, nc, cl, n)

    # (i) intra-chunk quadratic term: sum_t C_s.B_t L[s, t] x_t
    Lmat = torch.exp(_segsum(dA))                            # (b,h,nc,s,t)
    cb = torch.einsum("bcsn,bctn->bcst", Cc, Bc)
    y_diag = torch.einsum("bhcst,bcthp->bcshp", Lmat * cb[:, None], xc)

    # (ii) per-chunk final states + inter-chunk recurrence
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)        # (b,h,nc,cl)
    states = torch.einsum(
        "bctn,bcthp->bchpn", Bc,
        xc * decay_states.permute(0, 2, 3, 1)[..., None])
    chunk_decay = torch.exp(dA_cs[..., -1])                  # (b,h,nc)

    carry = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if init_state is None else init_state.to(x.dtype))
    prev = []                        # the state *before* each chunk
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,h,p,n)

    state_decay_out = torch.exp(dA_cs)                       # (b,h,nc,cl)
    y_off = torch.einsum("bcsn,bchpn->bcshp", Cc, prev_states) \
        * state_decay_out.permute(0, 2, 3, 1)[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, carry


def _conv1d_causal(xc: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + SiLU.  xc: (B, L, Ch); w: (Ch, W)."""
    W, L = w.shape[-1], xc.shape[1]
    x = F.pad(xc.transpose(-1, -2), (W - 1, 0))              # (B, Ch, L+W-1)
    out = sum(x[..., i:i + L] * w[:, i][None, :, None] for i in range(W))
    return F.silu(out + bias[None, :, None]).transpose(-1, -2)


def _gated_out(cfg, pr: dict, y: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    """The gated RMS norm and the output projection."""
    y = rms_norm(y.to(dtype) * F.silu(z), pr["gate_norm"], cfg.norm_eps)
    return y @ pr["out_proj"]


def mamba_forward(cfg, pr: dict, u: torch.Tensor, chunk: int = 256,
                  want_cache: bool = False):
    """Whole-sequence Mamba2 mixer.  u: (B, L, D) -> (B, L, D).

    With ``want_cache`` also returns the :class:`MambaCache` for decoding.
    A length that ``chunk`` does not divide runs at chunk 1 (the
    reference's fallback: the same numbers, one chunk a token).
    """
    B_, L, D = u.shape
    di, n, h, p = (cfg.d_inner, cfg.ssm_state, cfg.mamba_nheads,
                   cfg.mamba_headdim)
    chunk = min(chunk, L)
    if L % chunk:
        chunk = 1
    z, xc, dt = _split_proj(cfg, u @ pr["in_proj"])
    conv_tail = None
    if want_cache:
        W = cfg.conv_width
        tail = xc[:, -W:, :] if L >= W else F.pad(xc, (0, 0, W - L, 0))
        conv_tail = tail.transpose(1, 2).contiguous()
    xc = _conv1d_causal(xc, pr["conv_w"], pr["conv_b"])
    x, Bm, Cm = xc[..., :di], xc[..., di:di + n], xc[..., di + n:]
    x = constrain(x, ("batch", "seq", "inner"))

    # dt's heads laid out as x's, and y's (so its gradient's) as well, as
    # XLA carries x's constraint: each device runs the chunked SSD and its
    # backward on its own heads
    heads = ("batch", "seq", "inner")
    dt = constrain(F.softplus(dt.to(torch.float32) + pr["dt_bias"]), heads)
    A = -torch.exp(pr["A_log"])
    xh = x.reshape(B_, L, h, p).to(torch.float32)
    y, final = ssd_chunked(xh, dt, A, Bm.to(torch.float32),
                           Cm.to(torch.float32), chunk)
    y = constrain(y, heads + (None,))
    y = y + pr["D"][None, None, :, None] * xh
    out = constrain(_gated_out(cfg, pr, y.reshape(B_, L, di), z, u.dtype),
                    ("batch", "seq", "embed"))
    if want_cache:
        return out, MambaCache(conv=conv_tail, ssd=final)
    return out


def mamba_decode(cfg, pr: dict, u: torch.Tensor,
                 cache: MambaCache) -> Tuple[torch.Tensor, MambaCache]:
    """One-token recurrent step.  u: (B, 1, D).  Updates ``cache`` **in
    place** (the reference returns a new one) and returns ``(out (B, 1,
    D), cache)``."""
    B_ = u.shape[0]
    di, n, h, p = (cfg.d_inner, cfg.ssm_state, cfg.mamba_nheads,
                   cfg.mamba_headdim)
    z, xc, dt = _split_proj(cfg, (u @ pr["in_proj"])[:, 0])

    conv = torch.cat([cache.conv[..., 1:], xc[..., None].to(
        cache.conv.dtype)], dim=-1)
    xc = F.silu((conv * pr["conv_w"][None]).sum(-1) + pr["conv_b"])
    x, Bm, Cm = xc[..., :di], xc[..., di:di + n], xc[..., di + n:]

    dt = F.softplus(dt.to(torch.float32) + pr["dt_bias"])    # (B, h)
    A = -torch.exp(pr["A_log"])
    dA = torch.exp(dt * A)                                   # (B, h)
    xh = x.reshape(B_, h, p).to(torch.float32)
    dBx = (dt[..., None, None] * xh[..., None]
           * Bm.to(torch.float32)[:, None, None, :])         # (B,h,p,n)
    state = cache.ssd * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", state, Cm.to(torch.float32))
    y = y + pr["D"][None, :, None] * xh
    out = _gated_out(cfg, pr, y.reshape(B_, di), z, u.dtype)[:, None]
    cache.conv.copy_(conv)
    cache.ssd.copy_(state)
    return out, cache
