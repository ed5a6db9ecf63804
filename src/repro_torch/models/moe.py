"""FFN layers: dense (gated) MLP and capacity-based Mixture-of-Experts.

The MoE uses the reference's einsum dispatch/combine formulation (Shazeer
et al.): a dense ``(B, L, E, C)`` dispatch tensor places each token's top-k
choices in per-expert capacity slots, the experts run as batched matmuls
over ``(B, E, C, D)``, and the combine tensor weights their outputs back
onto the tokens.  Capacity is static per call (``cfg.moe_capacity(L)``);
tokens over capacity are dropped (their FFN contribution is zero and the
residual carries them).  The router's logits and softmax stay float32
whatever the compute dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.sharding.logical import constrain

from .common import Activations, dense_init

__all__ = ["init_mlp", "mlp_forward", "init_moe", "moe_forward",
           "moe_aux_loss", "init_ffn", "ffn_forward"]


# ---------------------------------------------------------------------------
# Dense (gated) MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg, gen: torch.Generator, dtype, device) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    p = {"w_up": dense_init(gen, (D, F), dtype, device, fan_in=D),
         "w_down": dense_init(gen, (F, D), dtype, device, fan_in=F)}
    if Activations.gated(cfg.ffn_activation):
        p["w_gate"] = dense_init(gen, (D, F), dtype, device, fan_in=D)
    return p


def mlp_forward(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = Activations.fn(cfg.ffn_activation)
    up = x @ p["w_up"]
    if "w_gate" in p:
        up = up * act(x @ p["w_gate"])
    else:
        up = act(up)
    lead = ("batch",) + (None,) * (up.ndim - 2)
    up = constrain(up, lead + ("ffn",))
    return constrain(up @ p["w_down"], lead + ("embed",))


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def init_moe(cfg, gen: torch.Generator, dtype, device) -> dict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    p = {"router": dense_init(gen, (D, E), torch.float32, device, fan_in=D),
         "w_up": dense_init(gen, (E, D, F), dtype, device, fan_in=D),
         "w_down": dense_init(gen, (E, F, D), dtype, device, fan_in=F)}
    if Activations.gated(cfg.ffn_activation):
        p["w_gate"] = dense_init(gen, (E, D, F), dtype, device, fan_in=D)
    return p


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    the lower index first on a tie (a stable descending sort;
    ``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_combine(probs: torch.Tensor, topk: int, capacity: int):
    """Top-k routing with per-expert capacity.

    probs: (B, L, E) router probabilities.  Returns
      dispatch: (B, L, E, C) 0/1 dispatch tensor
      combine:  (B, L, E, C) gate-weighted combine tensor
    in ``probs``' dtype.  Slot-major priority: slot k of token l is placed
    after every token's slots k' < k and after the tokens l' < l at slot
    k; a choice whose position reaches ``capacity`` is dropped.
    """
    B, L, E = probs.shape
    gate_vals, experts = _top_k(probs, topk)                 # (B, L, K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    onehot = torch.nn.functional.one_hot(experts, E).to(torch.int32)
    slot_major = onehot.transpose(1, 2).reshape(B, topk * L, E)
    pos = torch.cumsum(slot_major, dim=1) - slot_major       # before this
    pos = pos.reshape(B, topk, L, E).transpose(1, 2)         # (B, L, K, E)
    within = (pos < capacity) & (onehot == 1)
    pos_in_e = (pos * onehot).sum(-1)                        # (B, L, K)

    # jax.nn.one_hot: an index past the last class gives a zero row
    slots = torch.arange(capacity, device=probs.device)
    cap_oh = (pos_in_e[..., None] == slots).to(probs.dtype)  # (B,L,K,C)
    keep = within.to(probs.dtype)                            # (B,L,K,E)
    dispatch = torch.einsum("blke,blkc->blec", keep, cap_oh)
    combine = torch.einsum("blke,blkc->blec", keep,
                           gate_vals[..., None] * cap_oh)
    return dispatch, combine


def moe_forward(cfg, p: dict, x: torch.Tensor,
                capacity: Optional[int] = None) -> torch.Tensor:
    """x: (B, L, D) -> (B, L, D) through the top-k experts, at
    ``capacity`` slots per expert (default ``cfg.moe_capacity(L)``)."""
    B, L, D = x.shape
    C = capacity or cfg.moe_capacity(L)
    act = Activations.fn(cfg.ffn_activation)

    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine = _dispatch_combine(probs, cfg.moe_topk, C)
    # the reference's constraints; on DTensors the (token, expert) maps
    # are laid out by expert first, so each device dispatches to its own
    # experts (XLA moves the constraint on xin into the product)
    by_expert = ("batch", None, "experts", None)
    dispatch = constrain(dispatch.to(x.dtype), by_expert)
    combine = constrain(combine.to(x.dtype), by_expert)

    experts = ("batch", "experts", None, None)
    xin = constrain(torch.einsum("blec,bld->becd", dispatch, x), experts)
    up = torch.einsum("becd,edf->becf", xin, p["w_up"])
    if "w_gate" in p:
        up = up * act(torch.einsum("becd,edf->becf", xin, p["w_gate"]))
    else:
        up = act(up)
    yout = constrain(torch.einsum("becf,efd->becd", up, p["w_down"]),
                     experts)
    return constrain(torch.einsum("blec,becd->bld", combine, yout),
                     ("batch", "seq", "embed"))


def moe_aux_loss(probs: torch.Tensor, dispatch: torch.Tensor) -> torch.Tensor:
    """Load-balance auxiliary loss (Switch-style): the fraction of tokens
    dispatched to each expert against its mean router probability."""
    fe = dispatch.sum(-1).mean(dim=(0, 1))         # (E,)
    pe = probs.mean(dim=(0, 1))                    # (E,)
    return probs.shape[-1] * torch.sum(fe * pe)


# ---------------------------------------------------------------------------
# Unified FFN entry
# ---------------------------------------------------------------------------

def init_ffn(cfg, use_moe: bool, gen: torch.Generator, dtype,
             device) -> dict:
    return (init_moe if use_moe else init_mlp)(cfg, gen, dtype, device)


def ffn_forward(cfg, use_moe: bool, p: dict,
                x: torch.Tensor) -> torch.Tensor:
    return moe_forward(cfg, p, x) if use_moe else mlp_forward(cfg, p, x)
