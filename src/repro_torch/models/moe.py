"""FFN layers: the dense (gated) MLP.

Only the dense MLP is ported; the Mixture-of-Experts layer waits for a
later slice (ROADMAP.md, Queue A item 10).
"""

from __future__ import annotations

import torch

from .common import Activations, dense_init

__all__ = ["init_mlp", "mlp_forward", "init_ffn", "ffn_forward"]


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
    return up @ p["w_down"]


def _no_moe(use_moe: bool) -> None:
    if use_moe:
        raise NotImplementedError(
            "MoE FFN is not ported yet (ROADMAP.md, Queue A item 10)")


def init_ffn(cfg, use_moe: bool, gen: torch.Generator, dtype,
             device) -> dict:
    _no_moe(use_moe)
    return init_mlp(cfg, gen, dtype, device)


def ffn_forward(cfg, use_moe: bool, p: dict,
                x: torch.Tensor) -> torch.Tensor:
    _no_moe(use_moe)
    return mlp_forward(cfg, p, x)
