"""Windowed pairwise L1 distances on the SPA: the similarity unit.

``local_similarity_dist(spa, w)`` computes, for every window of ``w``
consecutive rows of ``spa (B, H, L, Lk)``, the ``w x w`` matrix of L1
distances between its rows -- the numerator of
:func:`repro_torch.core.similarity.windowed_l1` (CUDA source
``csrc/local_similarity.cu``; it replaces the Pallas TPU kernel
``repro/kernels/local_similarity.py::local_similarity_dist``).  The source
says what bounds it on the card and what its design does about that.

The kernel sums each pair over the columns in another order than
:func:`local_similarity_plain` (float32 both), so the two agree to a
float32 order-of-summation tolerance; the result feeds only the similarity
threshold test.  ``L % w != 0`` raises, as the reference asserts; the
kernel takes ``1 <= w <= 16`` and any ``Lk``.
"""

from __future__ import annotations

import ctypes

import torch

from .gathered_matmul import (_check, _fn, _launch, _on_cpu,
                             _refuse_grad)

__all__ = ["local_similarity_dist", "local_similarity_plain", "MAX_WINDOW"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGS = (_P, _P, _LL, _I, _I, _P)      # the C entry's argument types
MAX_WINDOW = 16            # the kernel keeps w(w-1)/2 pair sums in registers
_SLAB_BYTES = 64 << 20     # the plain version's pairwise intermediate per slab


def _windows(spa: torch.Tensor, w: int):
    if spa.dim() != 4:
        raise ValueError(f"spa must be (B, H, L, Lk), got shape "
                         f"{tuple(spa.shape)}")
    B, H, L, Lk = spa.shape
    if w <= 0 or L % w:
        raise ValueError(f"L ({L}) must be a multiple of the window w ({w})")
    return B, H, L // w, Lk


def local_similarity_plain(spa: torch.Tensor, w: int) -> torch.Tensor:
    """Plain version (the reference's ``ref.local_similarity_ref``):
    reshape into windows, broadcast ``|a_i - a_j|`` and sum in float32,
    over slabs of windows so the pairwise intermediate stays small."""
    B, H, nw, Lk = _windows(spa, w)
    xf = spa.reshape(B * H * nw, w, Lk).to(torch.float32)
    step = max(1, _SLAB_BYTES // (w * w * Lk * 4))
    out = torch.empty((B * H * nw, w, w), dtype=torch.float32,
                      device=spa.device)
    for s in range(0, xf.shape[0], step):
        x = xf[s:s + step]
        out[s:s + step] = (x[:, :, None, :] - x[:, None, :, :]).abs_().sum(-1)
    return out.reshape(B, H, nw, w, w)


def local_similarity_dist(spa: torch.Tensor, w: int = 8) -> torch.Tensor:
    """spa (B, H, L, Lk) float32 -> (B, H, L // w, w, w) L1 distances.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, without synchronising."""
    if torch.is_grad_enabled() and (spa.requires_grad):
        _refuse_grad("local_similarity_dist",
                     "local_similarity_plain")
    if not spa.is_cuda and _on_cpu(spa, "local_similarity_dist"):
        return local_similarity_plain(spa, w)
    dev = spa.get_device()
    B, H, nw, Lk = _windows(spa, w)
    _check(spa, "spa", torch.float32, 4, dev)
    if not 1 <= w <= MAX_WINDOW or B * H * nw == 0 or Lk == 0:
        raise ValueError(f"local_similarity_dist needs 1 <= w <= "
                         f"{MAX_WINDOW} and a non-empty spa, got w {w}, spa "
                         f"{tuple(spa.shape)}")
    out = torch.empty((B, H, nw, w, w), dtype=torch.float32, device=dev)
    fn = _fn("local_similarity", "local_similarity_dist_f32", _ARGS)
    _launch(fn, dev, "local_similarity_dist", spa.data_ptr(),
            out.data_ptr(), B * H * nw, w, Lk)
    local_similarity_dist.launches += 1
    return out


local_similarity_dist.launches = 0
