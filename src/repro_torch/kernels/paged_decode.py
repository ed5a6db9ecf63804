"""Paged flash decode: one query token per sequence over the page pool.

``paged_flash_decode`` runs the CUDA kernel ``csrc/paged_decode.cu``,
which replaces the Pallas TPU kernel
``repro/kernels/paged_decode.py::paged_flash_decode``; the source says
what bounds it on the card and what its design does about that.  The
kernel cuts each row's written pages into shares over the blocks of a
thread-block cluster and merges their partial softmax states in split
order: :func:`paged_split_count` picks the number of splits from the
shapes, and :func:`paged_split_ranges` is the kernel's own cut, written
out for the tests.

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
import functools
from typing import List, Optional, Tuple

import torch

from .flash_decode import (DECODE_DTYPES, DECODE_MAX_DH, DECODE_MAX_SPLITS,
                           DECODE_MIN_SPLIT_SLOTS)
from .gathered_matmul import (H100_SMS, _check, _fn, _launch, _on_cpu,
                             _refuse_grad)

__all__ = ["paged_flash_decode", "paged_decode_plain", "paged_split_count",
           "paged_split_ranges", "NULL_PAGE"]


def __getattr__(name: str):
    # NULL_PAGE is the page pool's (serving/pager.py), exported here as the
    # reference's kernel module exports it; read on first use, because the
    # serving package imports the kernels
    if name == "NULL_PAGE":
        from repro_torch.serving.pager import NULL_PAGE
        return NULL_PAGE
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the C entry's argument types (the stream last)
_ARGS = (_P,) * 8 + (_I,) * 8 + (_F, _F, _I, _I, _P)


@functools.lru_cache(maxsize=1024)
def paged_split_count(pairs: int, P: int, ps: int,
                      window: Optional[int] = None) -> int:
    """Splits of the written pages for ``pairs = B * KV`` (b, kv head)
    pairs over block tables of ``P`` pages of ``ps`` slots -- the policy of
    :func:`~repro_torch.kernels.flash_decode.decode_split_count`, from the
    shapes alone (``kv_len`` lies on the card): enough blocks for about 8
    per SM, at most 8, none that would get fewer than 16 of the most live
    slots a row can have (``min(P * ps, window)``), and no more than the
    ``P`` pages a row can hold."""
    live = P * ps if window is None else min(P * ps, window)
    by_card = -(-8 * H100_SMS // max(1, pairs))
    by_slots = -(-live // DECODE_MIN_SPLIT_SLOTS)
    return max(1, min(DECODE_MAX_SPLITS, by_card, by_slots, P))


def paged_split_ranges(kv_len: int, ps: int,
                       nsplit: int) -> List[Tuple[int, int]]:
    """The kernel's cut of one row's written slots ``[0, kv_len)`` (with
    ``kv_len`` already clamped into [0, P * ps]) into ``nsplit`` contiguous
    shares of whole pages, in split order: ``[(start, end), ...]`` with
    ``end`` exclusive (empty shares have ``start == end``)."""
    n = max(0, kv_len)
    pages = -(-n // ps)
    chunk = -(-pages // nsplit)                      # pages a share
    return [(min(n, r * chunk * ps), min(n, (r + 1) * chunk * ps))
            for r in range(nsplit)]


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
    """One-token GQA decode over the page pool -> (B, KV, G, Dh) in q's
    type (float32 or bf16; q and the pages alike; float32 arithmetic
    inside).  CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream, without synchronising."""
    if torch.is_grad_enabled() and (q.requires_grad or k_pages.requires_grad
                                    or v_pages.requires_grad):
        _refuse_grad("paged_flash_decode",
                     "paged decode backend 'torch_paged_decode'")
    if not q.is_cuda and _on_cpu(q, "paged_flash_decode"):
        return paged_decode_plain(q, k_pages, v_pages, pos_pages, tables,
                                  kv_len, pos, softcap=softcap, window=window)
    dev = q.get_device()
    code = DECODE_DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 "
                        f"or bfloat16")
    _check(q, "q", q.dtype, 4, dev)
    _check(k_pages, "k_pages", q.dtype, 4, dev)
    _check(v_pages, "v_pages", q.dtype, 4, dev)
    _check(pos_pages, "pos_pages", torch.int32, 2, dev)
    _check(tables, "tables", torch.int32, 2, dev)
    _check(kv_len, "kv_len", torch.int32, 1, dev)
    _check(pos, "pos", torch.int32, 1, dev)
    B, KV, G, Dh = q.shape
    KVp, N, ps, Dhp = k_pages.shape
    P = tables.shape[1]
    if (KVp != KV or Dhp != Dh or v_pages.shape != k_pages.shape
            or pos_pages.shape[0] != N or pos_pages.shape[1] != ps
            or tables.shape[0] != B or kv_len.shape[0] != B
            or pos.shape[0] != B):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k/v_pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, pos_pages "
            f"{tuple(pos_pages.shape)}, tables {tuple(tables.shape)}, "
            f"kv_len {tuple(kv_len.shape)}, pos {tuple(pos.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if Dh > DECODE_MAX_DH:
        raise ValueError(f"paged_flash_decode takes Dh <= {DECODE_MAX_DH}, "
                         f"got Dh {Dh}")
    out = torch.empty_like(q)
    _launch(_fn("paged_decode", "paged_decode", _ARGS), dev,
            "paged_flash_decode", q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), pos_pages.data_ptr(), tables.data_ptr(),
            kv_len.data_ptr(), pos.data_ptr(), out.data_ptr(), code, B, KV,
            G, Dh, N, ps, P, Dh ** -0.5, softcap or 0.0, window or 0,
            paged_split_count(B * KV, P, ps, window))
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
