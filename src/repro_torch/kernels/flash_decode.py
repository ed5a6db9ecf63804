"""Flash decode: one query token per row over a contiguous KV cache.

``flash_decode`` runs the CUDA kernel ``csrc/flash_decode.cu``, which
replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py::
flash_decode``; the source says what bounds it on the card and what its
design does about that.  The kernel splits each row's live cache range
across the blocks of a thread-block cluster and merges their partial
softmax states in split order: :func:`decode_split_count` picks the number
of splits from the shapes (never from ``pos``, which lies on the card), and
:func:`decode_split_ranges` is the kernel's own cut of a row's live slots,
written out for the tests.

Layout: ``q (B, KV, G, Dh)`` one token per row; ``k / v (B, KV, S, Dh)``
the caches; ``pos (B,)`` int32 the current write index, attended
inclusively.

:func:`flash_decode_plain` is the plain PyTorch version (dense masked
softmax, as ``kernels/ref.py::flash_decode_ref``).  The wrapper takes it
only for CPU tensors; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from .gathered_matmul import (H100_SMS, _check, _fn, _launch, _on_cpu,
                             _refuse_grad)

__all__ = ["flash_decode", "flash_decode_plain", "decode_split_count",
           "decode_split_ranges"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the C entry's argument types (the stream last)
_ARGS = (_P,) * 5 + (_I,) * 6 + (_F, _F, _I, _I, _P)
# the element types the decode kernels take (the C entries' dtype codes);
# they compute in float32 and store in q's type
DECODE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the CUDA kernel's limit and split policy (csrc/flash_decode.cu); any G
DECODE_MAX_DH = 256             # head width
DECODE_MAX_SPLITS = 8           # splits form one cluster (portable size)
DECODE_MIN_SPLIT_SLOTS = 16     # slots a split gets at the least


@functools.lru_cache(maxsize=1024)
def decode_split_count(pairs: int, S: int,
                       window: Optional[int] = None) -> int:
    """Splits of the cache axis for ``pairs = B * KV`` (b, kv head) pairs
    over a cache of ``S`` slots: enough blocks for about 8 per SM, at most
    8, and none that would get fewer than 16 of the most live slots a row
    can have (``min(S, window)``)."""
    live = S if window is None else min(S, window)
    by_card = -(-8 * H100_SMS // max(1, pairs))
    by_slots = -(-live // DECODE_MIN_SPLIT_SLOTS)
    return max(1, min(DECODE_MAX_SPLITS, by_card, by_slots))


def decode_split_ranges(pos: int, S: int, window: Optional[int],
                        nsplit: int) -> List[Tuple[int, int]]:
    """The kernel's cut of one row's live slots ``[max(0, pos - window +
    1), min(pos, S - 1)]`` into ``nsplit`` contiguous shares, in split
    order: ``[(start, end), ...]`` with ``end`` exclusive (empty shares
    have ``start == end``)."""
    lo = max(0, pos - window + 1) if window is not None else 0
    n = max(0, min(pos, S - 1) - lo + 1)
    chunk = -(-n // nsplit)
    return [(lo + min(n, r * chunk), lo + min(n, (r + 1) * chunk))
            for r in range(nsplit)]


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
    """One-token GQA decode over the cache -> (B, KV, G, Dh) in q's type
    (float32 or bf16; q, k and v alike; float32 arithmetic inside).  CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream, without synchronising."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _refuse_grad("flash_decode",
                     "decode backend 'torch_dense_decode'")
    if not q.is_cuda and _on_cpu(q, "flash_decode"):
        return flash_decode_plain(q, k, v, pos, softcap=softcap,
                                  window=window)
    dev = q.get_device()
    code = DECODE_DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 "
                        f"or bfloat16")
    _check(q, "q", q.dtype, 4, dev)
    _check(k, "k", q.dtype, 4, dev)
    _check(v, "v", q.dtype, 4, dev)
    _check(pos, "pos", torch.int32, 1, dev)
    B, KV, G, Dh = q.shape
    S = k.shape[2]
    if (k.shape[0] != B or k.shape[1] != KV or k.shape[3] != Dh
            or v.shape != k.shape or pos.shape[0] != B):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, pos "
                         f"{tuple(pos.shape)}")
    if B == 0 or KV == 0 or G == 0 or S == 0 or Dh == 0:
        raise ValueError("flash_decode needs non-empty q and caches")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if Dh > DECODE_MAX_DH:
        raise ValueError(f"flash_decode takes Dh <= {DECODE_MAX_DH}, got Dh "
                         f"{Dh}")
    out = torch.empty_like(q)
    _launch(_fn("flash_decode", "flash_decode", _ARGS), dev, "flash_decode",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), code, B, KV, G, S, Dh, Dh ** -0.5,
            softcap or 0.0, window or 0,
            decode_split_count(B * KV, S, window))
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
