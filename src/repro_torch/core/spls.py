"""SPLS hyper-parameters (Sparsity Prediction with Local Similarity).

Pipeline (Fig. 5a of the paper):
  1. HLog-quantized attention prediction  -> PAM        (predict.py)
  2. row-wise top-k pruning               -> SPA + mask (spls_chunked.py)
  3. fixed-window local similarity        -> critical/similar Q rows
  4. zero-column detection                -> K/V keep mask
  5. MFI vote across heads                -> FFN token sparsity

Only the configuration lives here: the port builds plans through the
streaming planner (:mod:`repro_torch.core.planner`).
"""

from __future__ import annotations

import dataclasses

__all__ = ["SPLSConfig"]


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
