"""Flash attention with the SPLS block skips: the whole-prompt kernel.

``flash_attention`` runs the CUDA kernel ``csrc/flash_attention.cu``
(both products on the FP64 tensor cores, accumulators in registers), which
replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``; the source says
what bounds it on the card and what its design does about that.

Layout: ``q (B, H, Lq, Dh)``; ``k / v (B, KV, Lk, Dh)`` with ``H % KV ==
0`` (head ``h`` reads group ``h // G``, never an H-wide copy);
``kv_keep (B, H, Lk)`` bool, the SPLS column-keep mask per query head;
``q_pos (B, H, Lq)`` int32, the original position of each (possibly
packed) query row, against which the causal and window masks are
evaluated.  Ragged Lq / Lk need no padding by the caller.

Both versions accumulate in float64 and round once to float32: the output
feeds the next layer's SPLS predictor, whose 8-bit quantization turns a
last-bit difference into another plan, so the kernel and its plain
version must agree to the last bit.  :func:`flash_attention_plain` is a
dense masked softmax with the same masks; the wrapper takes it only for
CPU tensors, and CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .gathered_matmul import (_check, _fn, _launch, _on_cpu,
                             _refuse_grad)

__all__ = ["flash_attention", "flash_attention_plain", "live_mask",
           "MAX_HEAD_DIM"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# the C entry's argument types (the stream last)
_ARGS = (_P,) * 6 + (_I,) * 6 + (_D, _I, _I, _D, _P)
MAX_HEAD_DIM = 128      # the kernel pads Dh to 16, 32, 64 or 128


def live_mask(Lq: int, Lk: int, causal: bool, window: Optional[int],
              kv_keep: Optional[torch.Tensor], q_pos: Optional[torch.Tensor],
              device) -> torch.Tensor:
    """The (B|1, H|1, Lq, Lk) bool mask of live (row, column) pairs."""
    qi = (q_pos.long()[..., None] if q_pos is not None
          else torch.arange(Lq, device=device)[:, None])
    kj = torch.arange(Lk, device=device)
    m = torch.ones(qi.shape[:-1] + (Lk,), dtype=torch.bool, device=device)
    if causal:
        m = m & (kj <= qi)
    if window is not None:
        m = m & (qi - kj < window)
        if not causal:                       # symmetric band
            m = m & (kj - qi < window)
    if kv_keep is not None:
        m = m & kv_keep.bool()[..., None, :]
    return m


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          kv_keep: Optional[torch.Tensor] = None,
                          q_pos: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Dense masked softmax in float64, rounded to float32; the masks of
    the kernel (causal or symmetric window on ``q_pos``, ``kv_keep``); a
    row with no live column gives zeros."""
    B, H, Lq, Dh = q.shape
    G = H // k.shape[1]
    kf = k.double().repeat_interleave(G, dim=1)
    vf = v.double().repeat_interleave(G, dim=1)
    s = torch.matmul(q.double(), kf.transpose(-1, -2)) * Dh ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    m = live_mask(Lq, k.shape[2], causal, window, kv_keep, q_pos, q.device)
    s = s.masked_fill(~m, float("-inf"))
    mx = s.amax(-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isfinite(mx), mx,
                                  torch.zeros_like(mx)))
    l = e.sum(-1, keepdim=True)
    o = torch.matmul(e, vf) / torch.where(l > 0, l, torch.ones_like(l))
    return o.float()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_keep: Optional[torch.Tensor] = None,
                    q_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block online-softmax attention -> (B, H, Lq, Dh) float32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream, without synchronising."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _refuse_grad("flash_attention",
                     "attention backend 'torch_dense' / 'torch_chunked'")
    if not q.is_cuda and _on_cpu(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, kv_keep=kv_keep,
                                     q_pos=q_pos)
    dev = q.get_device()
    _check(q, "q", torch.float32, 4, dev)
    _check(k, "k", torch.float32, 4, dev)
    _check(v, "v", torch.float32, 4, dev)
    B, H, Lq, Dh = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    if (k.shape != (B, KV, Lk, Dh) or v.shape != k.shape or KV == 0
            or H % KV):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (H must be "
                         f"a multiple of KV)")
    if min(B, H, Lq, Lk) == 0 or not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention needs non-empty q/k and 0 < Dh "
                         f"<= {MAX_HEAD_DIM}, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if kv_keep is not None:
        _check(kv_keep, "kv_keep", torch.bool, 3, dev)
        if kv_keep.shape != (B, H, Lk):
            raise ValueError(f"kv_keep must be {(B, H, Lk)}, got "
                             f"{tuple(kv_keep.shape)}")
    if q_pos is not None:
        _check(q_pos, "q_pos", torch.int32, 3, dev)
        if q_pos.shape != (B, H, Lq):
            raise ValueError(f"q_pos must be {(B, H, Lq)}, got "
                             f"{tuple(q_pos.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    out = torch.empty_like(q)
    fn = _fn("flash_attention", "flash_attention_f32", _ARGS)
    _launch(fn, dev, "flash_attention", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), None if kv_keep is None else kv_keep.data_ptr(),
            None if q_pos is None else q_pos.data_ptr(), out.data_ptr(), B,
            H, KV, Lq, Lk, Dh, Dh ** -0.5, int(causal), window or 0,
            softcap or 0.0)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
