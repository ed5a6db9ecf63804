"""Attention prediction: the quantized Q/K predictor of Fig. 5a.

The activations X and the weights W_Q, W_K are HLog-quantized, the
predicted Q'/K' are formed, re-quantized to 8 bits and HLog-quantized
again; the serving planner multiplies them into the Predicted Attention
Matrix one chunk at a time (:mod:`repro_torch.core.spls_chunked`).
"""

from __future__ import annotations

from typing import Optional

import torch

from .quantizers import quantize_dequantize

__all__ = ["predict_qk", "predict_qk_pre"]


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
