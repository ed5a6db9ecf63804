"""SPLS hyper-parameters (Sparsity Prediction with Local Similarity).

Pipeline (Fig. 5a of the paper):
  1. HLog-quantized attention prediction  -> PAM        (predict.py)
  2. row-wise top-k pruning               -> SPA + mask (spls_chunked.py)
  3. fixed-window local similarity        -> critical/similar Q rows
  4. zero-column detection                -> K/V keep mask
  5. MFI vote across heads                -> FFN token sparsity

The output is a :class:`SparsityPlan` consumed by the execution layer
(``sparse_exec.py``) and by the FLOPs accountant (``flops.py``).
:func:`build_plan` runs the pipeline as one shot on raw activations and
projection weights (the paper's reference API); the model's blocks plan
through :mod:`repro_torch.core.planner`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .mfi import mfi_ffn_sparsity
from .predict import predicted_attention
from .similarity import local_similarity
from .topk import kv_keep_from_mask, sparsify_pam

__all__ = ["SPLSConfig", "SparsityPlan", "build_plan", "plan_stats"]


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
    """Everything the formal computation phase needs; ``L`` rows, leading
    head dims ``(B, KV, G)`` from the planner (the structured head layout)
    or ``(B, H)`` from :func:`build_plan`.

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


def _dense_plan(B: int, H: int, L: int, causal: bool,
                device=None) -> SparsityPlan:
    ones = torch.ones((L, L), dtype=torch.bool, device=device)
    tri = ones.tril() if causal else ones
    ar = torch.arange(L, dtype=torch.int32, device=device)
    return SparsityPlan(
        attn_mask=tri.expand(B, H, L, L),
        q_critical=torch.ones((B, H, L), dtype=torch.bool, device=device),
        q_leader=ar.expand(B, H, L),
        kv_keep=torch.ones((B, H, L), dtype=torch.bool, device=device),
        ffn_critical=torch.ones((B, L), dtype=torch.bool, device=device),
        ffn_leader=ar.expand(B, L))


def build_plan(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
               n_heads: int, cfg: SPLSConfig,
               valid_len: Optional[int] = None) -> SparsityPlan:
    """Run the full SPLS prediction pipeline on activations ``x (B, L,
    D)`` with projection weights ``wq / wk (D, H * Dh)``: a plan with
    ``(B, H)`` leading dims.  ``valid_len`` marks the real rows of a
    right-padded sequence (padded rows are never critical)."""
    B, L, _ = x.shape
    dev = x.device
    if not cfg.enabled:
        return _dense_plan(B, n_heads, L, cfg.causal, dev)

    pam = predicted_attention(x, wq, wk, n_heads, cfg.quant_method,
                              cfg.quant_bits, causal=cfg.causal)
    spa, mask = sparsify_pam(pam, cfg.k_ratio)
    if cfg.causal:
        # early rows have fewer valid positions than k: top-k may have been
        # forced onto masked entries -- clear them
        tri = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
        mask = mask & tri
        spa = torch.where(mask, spa, torch.zeros_like(spa))

    ar = torch.arange(L, dtype=torch.int32, device=dev)
    if cfg.qkv_sparsity:
        sim = local_similarity(spa, cfg.window, cfg.s_threshold,
                               valid_len=valid_len)
        q_critical, q_leader = sim.is_critical, sim.leader
        kv_keep = kv_keep_from_mask(mask)
    else:
        q_critical = torch.ones((B, n_heads, L), dtype=torch.bool,
                                device=dev)
        q_leader = ar.expand(B, n_heads, L)
        kv_keep = torch.ones((B, n_heads, L), dtype=torch.bool, device=dev)

    if cfg.ffn_sparsity and cfg.qkv_sparsity:
        ffn = mfi_ffn_sparsity(q_leader, cfg.window, cfg.f_threshold)
        ffn_critical, ffn_leader = ffn.is_critical, ffn.leader
    else:
        ffn_critical = torch.ones((B, L), dtype=torch.bool, device=dev)
        ffn_leader = ar.expand(B, L)

    # a similar row's effective attention row is its leader's, whose mask
    # already encodes the intra-row sparsity; no row attends a pruned column
    return SparsityPlan(attn_mask=mask & kv_keep[..., None, :],
                        q_critical=q_critical, q_leader=q_leader,
                        kv_keep=kv_keep, ffn_critical=ffn_critical,
                        ffn_leader=ffn_leader)


def plan_stats(plan: SparsityPlan) -> dict:
    """Sparsity ratios (fraction *removed*) per component, as Python
    floats (float64 means of the boolean masks, read back to the host)."""
    mean = lambda m: float(m.double().mean())
    q_keep = mean(plan.q_critical)
    attn_keep = mean(plan.attn_mask)
    return {
        "q_sparsity": 1.0 - q_keep,
        "kv_sparsity": 1.0 - mean(plan.kv_keep),
        "attn_mask_keep": attn_keep,
        "attn_effective_keep": attn_keep * q_keep,
        "ffn_sparsity": 1.0 - mean(plan.ffn_critical),
    }
