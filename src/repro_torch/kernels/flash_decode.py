"""Flash decode: one query token per row over a contiguous KV cache.

``flash_decode`` runs the CUDA kernel ``csrc/flash_decode.cu``, which
replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py::
flash_decode``; the source says what bounds it on the card and what its
design does about that.

Layout: ``q (B, KV, G, Dh)`` one token per row; ``k / v (B, KV, S, Dh)``
the caches; ``pos (B,)`` int32 the current write index, attended
inclusively.

:func:`flash_decode_plain` is the plain PyTorch version (dense masked
softmax, as ``kernels/ref.py::flash_decode_ref``).  The wrapper takes it
only for CPU tensors; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .gathered_matmul import _check, _fn, _launch

__all__ = ["flash_decode", "flash_decode_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos: torch.Tensor, softcap: Optional[float] = None,
                       window: Optional[int] = None) -> torch.Tensor:
    """Dense masked softmax over slots ``j <= pos`` (and ``pos - j <
    window``); rows with nothing to attend give zeros."""
    S, Dh = k.shape[2], q.shape[-1]
    s = torch.einsum("bkgd,bkld->bkgl", q.float(), k.float()) * Dh ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    j = torch.arange(S, device=q.device)[None, :]
    p = pos.long()[:, None]
    m = j <= p
    if window is not None:
        m = m & (p - j < window)
    s = s.masked_fill(~m[:, None, None, :], float("-inf"))
    a = torch.softmax(s, dim=-1)
    a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
    return torch.einsum("bkgl,bkld->bkgd", a, v.float()).to(q.dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor, softcap: Optional[float] = None,
                 window: Optional[int] = None) -> torch.Tensor:
    """One-token GQA decode over the cache -> (B, KV, G, Dh).  CPU tensors
    take the plain version; CUDA tensors launch the kernel on the current
    stream, without synchronising."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, pos, softcap=softcap,
                                  window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    dev = q.device
    _check(q, "q", torch.float32, 4, dev)
    _check(k, "k", torch.float32, 4, dev)
    _check(v, "v", torch.float32, 4, dev)
    _check(pos, "pos", torch.int32, 1, dev)
    B, KV, G, Dh = q.shape
    S = k.shape[2]
    if (k.shape != (B, KV, S, Dh) or v.shape != k.shape
            or pos.shape != (B,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, pos "
                         f"{tuple(pos.shape)}")
    if min(B, KV, G, S, Dh) == 0:
        raise ValueError("flash_decode needs non-empty q and caches")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    out = torch.empty_like(q)
    fn = _fn("flash_decode", "flash_decode_f32",
             (_P,) * 5 + (_I,) * 5 + (_F, _F, _I, _P))
    _launch(fn, dev, "flash_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, KV, G, S, Dh, Dh ** -0.5,
            softcap or 0.0, window or 0)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
