"""Shared model building blocks: norms, RoPE, initializers, dtype helpers.

Three details are copied exactly from the reference: ``rms_norm`` scales
by ``1 + scale``; RoPE rotates split halves; the GELU MLP uses the tanh
approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["dtype_of", "rms_norm", "layer_norm", "rope_freqs", "apply_rope",
           "dense_init", "softcap", "Activations"]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def rope_freqs(positions: torch.Tensor, head_dim: int,
               theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape positions.shape + (head_dim // 2,)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / torch.pow(theta, exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate split halves.  x: (..., L, Dh); sin/cos broadcastable to
    (..., L, Dh/2)."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               device, fan_in: Optional[int] = None) -> torch.Tensor:
    """Truncated normal in [-2, 2] scaled by 1/sqrt(fan_in).  Drawn in
    float32 on ``gen``'s device and moved to ``device``; on the ``meta``
    device only the shape and dtype are made."""
    fan_in = fan_in or shape[0]
    meta = torch.device(device).type == "meta"
    t = torch.empty(shape, dtype=torch.float32,
                    device="meta" if meta else gen.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (t * fan_in ** -0.5).to(device=device, dtype=dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class Activations:
    """Activation registry for the FFN (gated variants use 2 input mats)."""

    @staticmethod
    def gated(name: str) -> bool:
        return name in ("silu", "gelu")

    @staticmethod
    def fn(name: str):
        return {"silu": F.silu, "gelu": _gelu_tanh,
                "gelu_mlp": _gelu_tanh}[name]
