"""Attention prediction: the quantized Q/K predictor of Fig. 5a.

The activations X and the weights W_Q, W_K are HLog-quantized, the
predicted Q'/K' are formed, re-quantized to 8 bits and HLog-quantized
again, and multiplied into the Predicted Attention Matrix: whole by
:func:`predicted_attention` (the exact plan), one chunk at a time by the
serving planner (:mod:`repro_torch.core.spls_chunked`).  The CUDA kernel
:func:`repro_torch.kernels.hlog_qmatmul` computes the first-stage product
on the integer codes (:func:`repro_torch.kernels.ops.predict_matmul`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding.logical import is_dtensor

from .quantizers import quantize_dequantize

__all__ = ["predict_qk", "predict_qk_pre", "predicted_attention",
           "split_heads", "head_scores"]


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(..., L, D) -> (..., H, L, Dh)."""
    *lead, L, D = x.shape
    if D % n_heads:
        raise ValueError(f"D={D} not divisible by n_heads={n_heads}")
    return x.reshape(*lead, L, n_heads, D // n_heads).transpose(-2, -3)


def head_scores(qh: torch.Tensor, kh: torch.Tensor) -> torch.Tensor:
    """The PAM's unscaled scores of grouped heads: qh (B, KV, G, C, Dh)
    against kh (B, KV, S, Dh) -> (B, KV, G, C, S).  A ``DTensor`` takes
    ``einsum``: its ``matmul`` cannot broadcast kh over sharded heads."""
    if is_dtensor(qh):
        return torch.einsum("bkgqd,bkld->bkgql", qh, kh)
    return torch.matmul(qh, kh.unsqueeze(2).transpose(-1, -2))


def predict_qk(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
               method: str = "hlog", bits: int = 8,
               act_axis: Optional[int] = None):
    """Predict Q and K with log-domain quantized inputs and weights.

    x: (..., L, D); wq, wk: (D, D_qk).  ``act_axis=-1`` gives per-token
    activation scales (every row independent of every other -- what a
    streaming predictor needs); ``None`` the per-tensor scale.  Weights
    always use per-tensor scales.  Returns ``(q_pred, k_pred)`` of shape
    (..., L, D_qk), re-quantized to 8 bits and projected again.
    """
    q_pred, k_pre = predict_qk_pre(x, wq, wk, method, bits, act_axis)
    k_pred = quantize_dequantize(k_pre, method, bits, axis=act_axis)
    return q_pred, k_pred


def predict_qk_pre(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                   method: str = "hlog", bits: int = 8,
                   act_axis: Optional[int] = None):
    """Prediction up to (but excluding) K's second-stage re-quantization:
    ``(q_pred, k_pre)``.  The planner's int8 predictor-cache encoder
    quantizes ``k_pre`` into codes itself."""
    xq = quantize_dequantize(x, method, bits, axis=act_axis)
    q_pred = xq @ quantize_dequantize(wq, method, bits)
    k_pre = xq @ quantize_dequantize(wk, method, bits)
    q_pred = quantize_dequantize(q_pred, method, bits, axis=act_axis)
    return q_pred, k_pre


def predicted_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                        n_heads: int, method: str = "hlog", bits: int = 8,
                        causal: bool = False, scale: Optional[float] = None,
                        n_kv_heads: Optional[int] = None) -> torch.Tensor:
    """Full PAM: (..., H, L, L) predicted scores (pre-softmax), per-tensor
    scales.  ``causal=True`` fills the strict upper triangle with
    ``finfo.min / 2`` so top-k never selects a future position; with
    ``n_kv_heads < n_heads`` (GQA) each predicted K head is broadcast
    across its query group, giving a per-*query*-head PAM."""
    qp, kp = predict_qk(x, wq, wk, method, bits)
    qh = split_heads(qp, n_heads)
    n_kv = n_kv_heads or n_heads
    kh = split_heads(kp, n_kv)
    if n_kv != n_heads:
        kh = kh.repeat_interleave(n_heads // n_kv, dim=-3)
    dh = qh.shape[-1]
    s = scale if scale is not None else \
        1.0 / torch.sqrt(torch.tensor(dh, dtype=qh.dtype))
    pam = torch.matmul(qh, kh.transpose(-1, -2)) * s
    if causal:
        L = pam.shape[-1]
        tri = torch.ones((L, L), dtype=torch.bool, device=pam.device).tril()
        pam = pam.masked_fill(~tri, torch.finfo(pam.dtype).min / 2)
    return pam
