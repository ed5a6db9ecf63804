"""AdamW: global-norm clipping, decoupled weight decay on every leaf, and
moments in a configurable dtype -- the reference's ``repro.optim.adamw``.

The moment math runs in float32 whatever the parameter and moment dtypes,
with the bias corrections computed from the step count in float32, as in
the reference.  Where the reference returns new arrays, the port updates
the parameter and moment tensors **in place** under ``torch.no_grad()``
(a model's stacked period leaves are updated where they live; nothing is
copied).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: Optional[str] = None  # None -> match param dtype


class OptState(NamedTuple):
    count: torch.Tensor     # () int32, steps taken
    mu: Any
    nu: Any


def _moment_dtype(cfg: AdamWConfig, p: torch.Tensor) -> torch.dtype:
    if cfg.moment_dtype is None:
        return p.dtype
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[cfg.moment_dtype]


def adamw_init(cfg: AdamWConfig, params: Any) -> OptState:
    """Zero moments beside each parameter (its device; the moment dtype)
    and a zero count on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=_moment_dtype(cfg, p),
                                  device=p.device)
    dev = leaves(params)[0].device
    return OptState(count=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """``tree`` scaled by ``min(1, max_norm / (norm + 1e-9))`` (new
    tensors in each leaf's dtype) and the norm before clipping."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, state: OptState, params: Any,
                 lr) -> Tuple[Any, OptState, dict]:
    """One AdamW step at learning rate ``lr`` (a float or a 0-d tensor).

    Updates ``params`` and the moments in place and returns ``(params,
    OptState(count + 1, mu, nu), {"grad_norm", "lr"})``; ``grad_norm`` is
    the norm before clipping."""
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    count = state.count + 1
    cf = count.float()
    b1c = 1.0 - cfg.b1 ** cf
    b2c = 1.0 - cfg.b2 ** cf

    def upd(g, m, v, p):
        g32 = g.float()
        m32 = m.float() * cfg.b1 + g32 * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + torch.square(g32) * (1 - cfg.b2)
        step = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        m.copy_(m32)
        v.copy_(v32)

    for g, m, v, p in zip(leaves(grads), leaves(state.mu), leaves(state.nu),
                          leaves(params)):
        upd(g, m, v, p)
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32)}
    return params, OptState(count, state.mu, state.nu), metrics
