"""HLog-projected prediction matmul: the first-stage product of the SPLS
attention predictor.

``hlog_qmatmul(xq, wq)`` computes ``hlog(xq) @ hlog(wq)`` on the 8-bit
codes of the activations and a projection weight (CUDA source
``csrc/hlog_qmatmul.cu``; it replaces the Pallas TPU kernel
``repro/kernels/hlog_qmatmul.py::hlog_qmatmul``).  The source says what
bounds it on the card and what its design does about that.

Contract, as the reference states it: ``xq (M, K)`` and ``wq (K, N)`` are
integer-valued float32 in ``[-127, 127]`` (``symmetric_quantize`` codes).
Every HLog level of that grid is an integer and every product at most
16384, so the kernel sums exactly in int32 (for K < 131072) and rounds
once at the store; :func:`hlog_qmatmul_plain` takes the float64 product
of the projected operands and rounds once, so the two agree bit for bit.
For K <= 1024 both also equal the reference's float32 product, whose
partial sums are then exact.  The wrapper checks dtype, device, rank and
shapes; it does not scan values.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantizers import hlog_project

from .gathered_matmul import _check, _fn, _launch

__all__ = ["hlog_qmatmul", "hlog_qmatmul_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_MAX_ROWS = 65535 * 64          # the kernel's grid.y limit x its row tile


def hlog_qmatmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain version: ``hlog_project`` of both operands (the port's level
    table), a float64 product, rounded once to float32."""
    return (hlog_project(xq).double() @ hlog_project(wq).double()).float()


def hlog_qmatmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``hlog(xq) @ hlog(wq)`` -> (M, N) float32.  CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream,
    without synchronising."""
    if xq.device.type == "cpu":
        return hlog_qmatmul_plain(xq, wq)
    if xq.device.type != "cuda":
        raise ValueError(f"hlog_qmatmul runs on CUDA or CPU tensors, got "
                         f"{xq.device}")
    dev = xq.device
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
    fn = _fn("hlog_qmatmul", "hlog_qmatmul_f32", (_P,) * 3 + (_I,) * 3 + (_P,))
    _launch(fn, dev, "hlog_qmatmul", xq.data_ptr(), wq.data_ptr(),
            out.data_ptr(), M, K, N)
    hlog_qmatmul.launches += 1
    return out


hlog_qmatmul.launches = 0
