"""The SPLS planner's streaming plan step.

:class:`PlanContext` owns the quantized predictor state -- the head
layout, the HLog prediction, and the int8 code encoding of the paged
predictor cache -- and emits one plan block per prefill chunk through
:func:`repro_torch.core.spls_chunked.plan_chunk`.  The serving chunk step
(:func:`repro_torch.serving.paged_model.paged_prefill_chunk_spls`) drives
it chunk by chunk; the column votes accumulate across chunks into the
page-prune vote.

Only the structured head layout and the streaming plan step are ported;
the exact, scan and progressive full-sequence plans and the
horizon-finalized vote (``vote_horizon``) wait for later work
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .predict import predict_qk_pre
from .quantizers import PROJECTORS, symmetric_quantize
from .spls import SPLSConfig
from .spls_chunked import ChunkPlanBlock, plan_chunk, votes_from_kv_any

__all__ = ["PlanContext", "votes_from_kv_any"]


@dataclasses.dataclass(frozen=True)
class PlanContext:
    """Static planning context: SPLS hyper-parameters + head layout."""

    scfg: SPLSConfig
    D: int
    KV: int
    G: int
    Dh: int
    causal: bool
    mode: str = "structured"

    @classmethod
    def for_config(cls, cfg, mode: Optional[str] = None) -> "PlanContext":
        mode = mode or "structured"
        if mode != "structured":
            raise NotImplementedError(
                f"head layout {mode!r}: the port runs on one card, where "
                f"the reference also picks 'structured'")
        scfg = cfg.spls
        if scfg.causal != cfg.causal:
            scfg = dataclasses.replace(scfg, causal=cfg.causal)
        return cls(scfg=scfg, D=cfg.d_model, KV=cfg.n_kv_heads,
                   G=cfg.n_heads // cfg.n_kv_heads,
                   Dh=cfg.resolved_head_dim, causal=cfg.causal, mode=mode)

    def _weights2d(self, p: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        wq = p["wq"].reshape(self.D, self.KV * self.G * self.Dh)
        wk = p["wk"].reshape(self.D, self.KV * self.Dh)
        return wq, wk

    def _layout(self, qp: torch.Tensor, kp: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L, H*Dh)/(B, L, KV*Dh) predictions -> ``qh (B, KV, G, L,
        Dh)`` / ``kh (B, KV, L, Dh)``."""
        KV, G, Dh = self.KV, self.G, self.Dh
        B, L = qp.shape[0], qp.shape[1]
        qh = qp.reshape(B, L, KV, G, Dh).permute(0, 2, 3, 1, 4)
        kh = kp.reshape(B, L, KV, Dh).permute(0, 2, 1, 3)
        return qh, kh

    def encode_pred_qk(self, p: dict, xn: torch.Tensor):
        """Streaming prediction with the K side emitted as int8 codes.

        xn: (1, C, D) normalized chunk input.  Returns ``(qh (1, KV, G, C,
        Dh), k_codes (KV, C, Dh) int8, k_scale (C,) float32)``;
        :meth:`decode_pred_k` turns codes + scale back into the predicted
        K exactly (the log-domain projection is deterministic on the
        integer codes).
        """
        scfg = self.scfg
        if scfg.quant_bits > 8:
            raise ValueError(
                f"int8 predictor-cache codes require quant_bits <= 8, got "
                f"{scfg.quant_bits}")
        _, C, _ = xn.shape
        wq, wk = self._weights2d(p)
        q_pred, k_pre = predict_qk_pre(xn, wq, wk, scfg.quant_method,
                                       scfg.quant_bits, act_axis=-1)
        kq, kscale = symmetric_quantize(k_pre, bits=scfg.quant_bits,
                                        axis=-1)         # (1, C, KV*Dh)
        qh, _ = self._layout(q_pred, k_pre)
        k_codes = kq.reshape(C, self.KV, self.Dh).permute(1, 0, 2) \
            .to(torch.int8)
        return qh, k_codes, kscale.reshape(C).to(torch.float32)

    def decode_pred_k(self, codes: torch.Tensor, scale: torch.Tensor,
                      dtype=None) -> torch.Tensor:
        """int8 codes (..., S, Dh) + per-token scale (..., S) -> the
        dequantized predicted K heads.  ``dtype`` is the compute dtype the
        codes were encoded from: both factors are cast to it *before* the
        multiply, which reproduces the compute-dtype product exactly."""
        proj = PROJECTORS[self.scfg.quant_method](
            codes.to(torch.float32), self.scfg.quant_bits)
        if dtype is not None:
            proj = proj.to(dtype)
            scale = scale.to(dtype)
        return proj * scale[..., None]

    def plan_block(self, qh_blk: torch.Tensor, kh: torch.Tensor, *, k, row0,
                   n_valid_rows, n_cols) -> ChunkPlanBlock:
        """One window-aligned plan block -- the streaming planning unit."""
        return plan_chunk(qh_blk, kh, k=k, row0=row0,
                          n_valid_rows=n_valid_rows, n_cols=n_cols,
                          s_threshold=self.scfg.s_threshold,
                          window=self.scfg.window,
                          f_threshold=self.scfg.f_threshold,
                          causal=self.causal)
