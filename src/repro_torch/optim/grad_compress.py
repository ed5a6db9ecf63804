"""Int8 block-quantized gradients with error feedback for the data-
parallel all-reduce -- the reference's ``repro.optim.grad_compress``
(blocks of 256, one float32 scale a block, ``max|x| / 127`` floored at
1e-12, round half to even).

:func:`compressed_mean` is the reference's ``lax.psum`` mean over a mesh
axis as a ``torch.distributed.all_reduce`` over a process group: each rank
quantizes its gradient (plus its residual), the dequantized codes are
summed over the group and divided by its size, and the rounding error
stays behind as the rank's new residual.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.tree import tree_map

__all__ = ["CompressionState", "compress_init", "compress", "decompress",
           "compressed_mean"]

_BLOCK = 256  # quantization block (per-block scale)


class CompressionState(NamedTuple):
    residual: Any  # error-feedback buffer, same structure as grads


def compress_init(grads_like: Any) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_like))


def _blockify(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % _BLOCK)).reshape(-1, _BLOCK)


def compress(g: torch.Tensor, residual: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float grad -> ``(int8 codes (nb, 256), float32 scales (nb, 1), new
    residual)``; the residual (what the codes lost) is added back into
    the next call's gradient."""
    g32 = g.float()
    if residual is not None:
        g32 = g32 + residual
    blocks = _blockify(g32)
    scale = blocks.abs().amax(-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)[:g.numel()].reshape(g.shape)
    return q, scale, g32 - deq


def decompress(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    size = 1
    for s in shape:
        size *= s
    return (q.float() * scale).reshape(-1)[:size].reshape(tuple(shape))


def compressed_mean(g: torch.Tensor, group=None,
                    residual: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean of ``g`` over ``group`` (default: the
    world; a mesh axis's group is ``mesh.get_group(axis)``).  Returns
    ``(mean float32 grad, new residual)``.  The codes are widened to
    float32 times their scales before the sum (int8 sums would overflow),
    as the reference's ``psum`` does; without a process group it raises."""
    q, scale, new_res = compress(g, residual)
    summed = q.float() * scale
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return (summed / n).reshape(-1)[:g.numel()].reshape(g.shape), new_res
