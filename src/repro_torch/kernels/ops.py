"""Public entry points over the kernels, with the reference's signatures
(``repro.kernels.ops``).

* :func:`predict_matmul` -- fused HLog projection + matmul, the PAM
  prediction hot spot (kernel :func:`hlog_qmatmul`);
* :func:`attention` -- flash attention with window / softcap / SPLS column
  mask (kernel :func:`flash_attention`);
* :func:`window_distances` -- windowed pairwise L1 distances, the
  similarity-unit hot spot (kernel :func:`local_similarity_dist`).

``use_pallas`` keeps the reference's name and means "use the hand-written
kernel": CUDA tensors then always launch it, and CPU tensors take its
plain version (each wrapper decides by device).  The reference also falls
back to its oracle when a shape does not tile the TPU's 128-wide blocks;
the CUDA kernels take ragged shapes, so that test is a TPU constraint and
is not copied.  ``use_pallas=False`` takes the plain version on either
device, as the reference's ``ref.*`` fall-through does.  There is no other
fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_plain
from .hlog_qmatmul import hlog_qmatmul, hlog_qmatmul_plain
from .local_similarity import local_similarity_dist, local_similarity_plain

__all__ = ["predict_matmul", "attention", "window_distances",
           "flash_attention", "hlog_qmatmul", "local_similarity_dist"]


def predict_matmul(xq: torch.Tensor, wq: torch.Tensor,
                   use_pallas: bool = True) -> torch.Tensor:
    """``hlog(xq) @ hlog(wq)`` on integer-valued codes ``xq (M, K)``,
    ``wq (K, N)`` -> (M, N) float32."""
    return (hlog_qmatmul if use_pallas else hlog_qmatmul_plain)(xq, wq)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              kv_keep: Optional[torch.Tensor] = None,
              use_pallas: bool = True) -> torch.Tensor:
    """Attention of ``q (B, H, L, Dh)`` over ``k / v (B, KV, Lk, Dh)``
    with an optional window, softcap and SPLS column-keep mask ``kv_keep
    (B, H, Lk)``."""
    fn = flash_attention if use_pallas else flash_attention_plain
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              kv_keep=kv_keep)


def window_distances(spa: torch.Tensor, w: int = 8,
                     use_pallas: bool = True) -> torch.Tensor:
    """Windowed pairwise L1 distances: ``spa (B, H, L, Lk)`` -> ``(B, H,
    L // w, w, w)``."""
    fn = local_similarity_dist if use_pallas else local_similarity_plain
    return fn(spa, w)
