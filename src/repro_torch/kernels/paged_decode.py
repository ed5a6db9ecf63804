"""Paged flash decode: one query token per sequence over the page pool.

``paged_flash_decode`` runs the CUDA kernel ``csrc/paged_decode.cu``,
which replaces the Pallas TPU kernel
``repro/kernels/paged_decode.py::paged_flash_decode``; the source says
what bounds it on the card and what its design does about that.

Layout: ``q (B, KV, G, Dh)``; ``k_pages / v_pages (KV, N, ps, Dh)`` -- the
shared pool, page 0 the reserved null page; ``pos_pages (N, ps)`` int32
original token ids; ``tables (B, P)`` int32 block tables; ``kv_len (B,)``
written slots; ``pos (B,)`` the query's original position (inclusive
upper end of the window).

:func:`paged_decode_plain` is the plain PyTorch version (gather the block
table into a contiguous view, then dense masked softmax).  The wrapper
takes it only for CPU tensors; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .gathered_matmul import _check, _lib, _raise_on

__all__ = ["paged_flash_decode", "paged_decode_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def paged_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, pos_pages: torch.Tensor,
                       tables: torch.Tensor, kv_len: torch.Tensor,
                       pos: torch.Tensor, softcap: Optional[float] = None,
                       window: Optional[int] = None) -> torch.Tensor:
    """Gather-then-dense version of the paged decode: rows with nothing to
    attend give zeros; page ids outside [0, N) clamp like the kernel's."""
    B, KV, G, Dh = q.shape
    N, ps = k_pages.shape[1], k_pages.shape[2]
    P = tables.shape[1]
    S = P * ps
    t = tables.long().clamp(0, N - 1)
    kg = k_pages[:, t].movedim(1, 0).reshape(B, KV, S, Dh)
    vg = v_pages[:, t].movedim(1, 0).reshape(B, KV, S, Dh)
    pg = pos_pages[t].reshape(B, S)
    s = torch.einsum("bkgd,bkld->bkgl", q.float(), kg.float()) * Dh ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    slot = torch.arange(S, device=q.device)[None, :]
    m = slot < kv_len[:, None]
    if window is not None:
        m = m & (pos[:, None] - pg < window)
    s = s.masked_fill(~m[:, None, None, :], float("-inf"))
    a = torch.softmax(s, dim=-1)
    a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
    return torch.einsum("bkgl,bkld->bkgd", a, vg.float()).to(q.dtype)


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, pos_pages: torch.Tensor,
                       tables: torch.Tensor, kv_len: torch.Tensor,
                       pos: torch.Tensor, softcap: Optional[float] = None,
                       window: Optional[int] = None) -> torch.Tensor:
    """One-token GQA decode over the page pool -> (B, KV, G, Dh).  CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream, without synchronising."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, pos_pages, tables,
                                  kv_len, pos, softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    dev = q.device
    _check(q, "q", torch.float32, 4, dev)
    _check(k_pages, "k_pages", torch.float32, 4, dev)
    _check(v_pages, "v_pages", torch.float32, 4, dev)
    _check(pos_pages, "pos_pages", torch.int32, 2, dev)
    _check(tables, "tables", torch.int32, 2, dev)
    _check(kv_len, "kv_len", torch.int32, 1, dev)
    _check(pos, "pos", torch.int32, 1, dev)
    B, KV, G, Dh = q.shape
    _, N, ps, _ = k_pages.shape
    P = tables.shape[1]
    if (k_pages.shape != (KV, N, ps, Dh) or v_pages.shape != k_pages.shape
            or pos_pages.shape != (N, ps) or tables.shape[0] != B
            or kv_len.shape != (B,) or pos.shape != (B,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k/v_pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, pos_pages "
            f"{tuple(pos_pages.shape)}, tables {tuple(tables.shape)}, "
            f"kv_len {tuple(kv_len.shape)}, pos {tuple(pos.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    out = torch.empty_like(q)
    fn = _lib("paged_decode", "paged_decode_f32",
              [_P] * 8 + [_I] * 7 + [_F, _F, _I, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     pos_pages.data_ptr(), tables.data_ptr(),
                     kv_len.data_ptr(), pos.data_ptr(), out.data_ptr(),
                     B, KV, G, Dh, N, ps, P, Dh ** -0.5,
                     softcap or 0.0, window or 0, stream),
                  "paged_flash_decode")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
