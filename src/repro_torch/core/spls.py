"""SPLS hyper-parameters (Sparsity Prediction with Local Similarity).

Pipeline (Fig. 5a of the paper):
  1. HLog-quantized attention prediction  -> PAM        (predict.py)
  2. row-wise top-k pruning               -> SPA + mask (spls_chunked.py)
  3. fixed-window local similarity        -> critical/similar Q rows
  4. zero-column detection                -> K/V keep mask
  5. MFI vote across heads                -> FFN token sparsity

The output is a :class:`SparsityPlan` consumed by the execution layer
(``sparse_exec.py``).  The port builds plans through the planner
(:mod:`repro_torch.core.planner`): the streaming step and the progressive
full-sequence plan; the exact one-shot ``build_plan`` is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = ["SPLSConfig", "SparsityPlan"]


@dataclasses.dataclass(frozen=True)
class SPLSConfig:
    """Hyper-parameters of the SPLS mechanism (Sec. V-B methodology).

    ``k_ratio`` smaller -> more attention sparsity; ``s_threshold`` larger ->
    more QKV sparsity; ``f_threshold`` smaller -> more FFN sparsity.
    """

    enabled: bool = True
    k_ratio: float = 0.12          # row-wise top-k ratio (paper MRPC setting)
    s_threshold: float = 0.6       # local-similarity threshold s
    f_threshold: int = 6           # MFI vote threshold f (heads >= f agree)
    window: int = 8                # fixed local window width w
    quant_method: str = "hlog"     # hlog | hlog_bitlevel | pot | apot | none
    quant_bits: int = 8
    causal: bool = True
    ffn_sparsity: bool = True      # allow disabling FFN stage (Fig. 16 runs)
    qkv_sparsity: bool = True
    # Capacity-mode execution (static shapes); ratios of L.
    q_capacity_ratio: float = 1.0
    kv_capacity_ratio: float = 1.0


class SparsityPlan(NamedTuple):
    """Everything the formal computation phase needs; leading dims ``(B,
    KV, G)`` (the structured head layout), ``L`` rows.

    attn_mask:    (B, KV, G, L, L) bool  intra-row SPA mask.
    q_critical:   (B, KV, G, L)    bool  rows whose attention row is computed.
    q_leader:     (B, KV, G, L)    int32 attention-row recovery map.
    kv_keep:      (B, KV, G, L)    bool  key/value positions that survive.
    ffn_critical: (B, L)           bool  tokens whose FFN is computed.
    ffn_leader:   (B, L)           int32 FFN output recovery map.
    """

    attn_mask: torch.Tensor
    q_critical: torch.Tensor
    q_leader: torch.Tensor
    kv_keep: torch.Tensor
    ffn_critical: torch.Tensor
    ffn_leader: torch.Tensor
