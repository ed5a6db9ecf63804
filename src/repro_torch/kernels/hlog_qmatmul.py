"""HLog-projected prediction matmul: the first-stage product of the SPLS
attention predictor.

``hlog_qmatmul(xq, wq)`` computes ``hlog(xq) @ hlog(wq)`` on the 8-bit
codes of the activations and a projection weight (CUDA source
``csrc/hlog_qmatmul.cu``; it replaces the Pallas TPU kernel
``repro/kernels/hlog_qmatmul.py::hlog_qmatmul``): a first pass writes the
operands' HLog levels once as bf16 into a workspace, and the product runs
on the bf16 tensor cores (wgmma), its float32 sums drained into int32
every 256 of K.  :func:`hlog_tiling` picks the product's output tile.  The
source says what bounds it on the card and what its design does about
that.

Contract, as the reference states it: ``xq (M, K)`` and ``wq (K, N)`` are
integer-valued float32 in ``[-127, 127]`` (``symmetric_quantize`` codes).
Every HLog level of that grid is an integer exact in bf16 and every
product at most 16384, so the kernel's sums are exact integers (the
float32 accumulators never pass 2^22 before they are drained; the int32
sums hold for K < 131072) and it rounds once at the store;
:func:`hlog_qmatmul_plain` takes the float64 product of the projected
operands and rounds once, so the two agree bit for bit.  For K <= 1024
both also equal the reference's float32 product, whose partial sums are
then exact.  The wrapper checks dtype, device, rank and shapes; it does
not scan values.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantizers import hlog_project

from .gathered_matmul import (H100_SMS, _check, _fn, _launch, _on_cpu,
                             _refuse_grad)

__all__ = ["hlog_qmatmul", "hlog_qmatmul_plain", "hlog_tiling"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P,) * 4 + (_I,) * 4 + (_P,)     # the C entry's argument types
# the CUDA kernel's tiles (csrc/hlog_qmatmul.cu)
HLOG_BM = 128                   # output rows per block: 2 warpgroups x 64
HLOG_BNS = (192, 128, 64)       # output tile widths it is built for
_MAX_ROWS = 65535 * HLOG_BM     # the kernel's grid.y limit x its row tile


def hlog_tiling(M: int, N: int) -> int:
    """The output tile width ``BN`` for an ``(M, N)`` product.

    Each block reads ``HLOG_BM + BN`` operand levels per unit of K, and one
    block runs per SM, so the busiest SM reads ``waves * (HLOG_BM + BN)``:
    the width with the least of that wins, ties to the wider tile.  At the
    predictor's (3072, 768): 192 (96 tiles, one wave) over 128 (144 tiles,
    two waves)."""
    best = None
    for bn in HLOG_BNS:
        tiles = -(-M // HLOG_BM) * -(-N // bn)
        cost = -(-tiles // H100_SMS) * (HLOG_BM + bn)
        if best is None or cost < best[0]:
            best = (cost, bn)
    return best[1]


def hlog_qmatmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain version: ``hlog_project`` of both operands (the port's level
    table), a float64 product, rounded once to float32."""
    return (hlog_project(xq).double() @ hlog_project(wq).double()).float()


def hlog_qmatmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``hlog(xq) @ hlog(wq)`` -> (M, N) float32.  CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream,
    without synchronising."""
    if torch.is_grad_enabled() and (xq.requires_grad or wq.requires_grad):
        _refuse_grad("hlog_qmatmul",
                     "hlog_qmatmul_plain")
    if not xq.is_cuda and _on_cpu(xq, "hlog_qmatmul"):
        return hlog_qmatmul_plain(xq, wq)
    dev = xq.get_device()
    _check(xq, "xq", torch.float32, 2, dev)
    _check(wq, "wq", torch.float32, 2, dev)
    M, K = xq.shape
    K2, N = wq.shape
    if K != K2:
        raise ValueError(f"shape mismatch: xq {tuple(xq.shape)} @ wq "
                         f"{tuple(wq.shape)}")
    if min(M, K, N) == 0 or M > _MAX_ROWS or K >= 1 << 17:
        raise ValueError(f"hlog_qmatmul needs non-empty operands, M <= "
                         f"{_MAX_ROWS} and K < 131072 (exact int32 sums), "
                         f"got ({M}, {K}) @ ({K2}, {N})")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    # the levels in bf16, x as (M, Kp) and w transposed as (N, Kp)
    ws = torch.empty((M + N) * (-(-K // 8) * 8), dtype=torch.bfloat16,
                     device=dev)
    fn = _fn("hlog_qmatmul", "hlog_qmatmul_f32", _ARGS)
    _launch(fn, dev, "hlog_qmatmul", xq.data_ptr(), wq.data_ptr(),
            ws.data_ptr(), out.data_ptr(), M, K, N, hlog_tiling(M, N))
    hlog_qmatmul.launches += 1
    return out


hlog_qmatmul.launches = 0
