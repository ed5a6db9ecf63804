"""FLOPs accounting for the SPLS mechanism (the paper's Fig. 15 breakdown).

Counts multiply-accumulates x 2 for the three components the paper
sparsifies -- QKV generation (with the output projection), attention
(QK^T and AV) and the FFN -- dense and under a :class:`~repro_torch.core.
spls.SparsityPlan`, plus the prediction overhead SPLS itself costs.  The
counts are expectations over the plan masks, as the paper's cycle
simulator scales stage latencies by measured sparsity ratios.

Every count is a Python float (float64) computed on the host from exact
integer mask sums, so the counts are exact for any realistic size; the
reference computes in float32 unless JAX's x64 mode is on, which agrees to
about 1e-7 relative.
"""

from __future__ import annotations

from typing import NamedTuple

from .spls import SparsityPlan

__all__ = ["ComponentFlops", "dense_flops", "spls_flops", "reduction_report"]


class ComponentFlops(NamedTuple):
    qkv: float        # Q, K, V projections (+ output projection)
    attention: float  # QK^T + AV
    ffn: float        # both FFN linears
    overhead: float   # SPLS prediction cost (0 for dense)

    @property
    def total(self) -> float:
        return self.qkv + self.attention + self.ffn + self.overhead


def dense_flops(B: int, L: int, D: int, H: int, d_ff: int,
                causal: bool = False) -> ComponentFlops:
    """Per-block dense FLOPs.  Attention counts the causal half if asked."""
    qkv = 4 * 2.0 * B * L * D * D        # Wq, Wk, Wv, Wo
    attn_pairs = (L * (L + 1) / 2) if causal else float(L * L)
    attn = 2 * 2.0 * B * H * attn_pairs * (D // H)
    ffn = 2 * 2.0 * B * L * D * d_ff
    return ComponentFlops(qkv, attn, ffn, 0.0)


def _heads(plan: SparsityPlan):
    """(B, number of heads, L) of a plan with (B, H) or (B, KV, G)
    leading dims."""
    *lead, L, _ = plan.attn_mask.shape
    H = 1
    for d in lead[1:]:
        H *= d
    return lead[0], H, L


def _count(mask) -> float:
    return float(mask.sum().item())


def spls_flops(plan: SparsityPlan, D: int, d_ff: int,
               include_overhead: bool = True) -> ComponentFlops:
    """FLOPs actually executed under ``plan``.

    QKV: Q rows only for per-head critical rows, K/V rows only for
    surviving columns, the output projection on critical rows (the paper's
    dynamic allocation computes only critical partial sums).  Attention:
    each computed row costs its surviving mask entries, for QK^T and again
    for AV.  FFN: both linears on critical tokens only.  Overhead: the
    prediction matmuls (X @ Wq', X @ Wk' and Q'K'^T per head) at 1 FLOP
    per MAC -- the bit-level unit removes the multiplies -- plus ``L^2``
    L1-similarity adds per head, a conservative bound.
    """
    B, H, L = _heads(plan)
    Dh = D // H
    q_rows = _count(plan.q_critical)
    kv_rows = _count(plan.kv_keep)
    qkv = 2.0 * (q_rows * D * Dh + 2.0 * kv_rows * D * Dh)
    qkv += 2.0 * q_rows * Dh * D
    pairs = _count(plan.attn_mask & plan.q_critical[..., None])
    attn = 2 * 2.0 * pairs * Dh
    ffn = 2 * 2.0 * _count(plan.ffn_critical) * D * d_ff
    overhead = 0.0
    if include_overhead:
        pred = (2.0 * B * L * D * D) + B * H * (L * (L + 1) / 2) * Dh
        overhead = pred + float(B * H * L * L)
    return ComponentFlops(qkv, attn, ffn, overhead)


def reduction_report(plan: SparsityPlan, D: int, d_ff: int,
                     causal: bool = True) -> dict:
    """Fractional computation reduction per component and overall, and the
    prediction overhead as a fraction of the dense total (Fig. 15)."""
    B, H, L = _heads(plan)
    dense = dense_flops(B, L, D, H, d_ff, causal=causal)
    sparse = spls_flops(plan, D, d_ff)
    red = lambda d, s: 1.0 - s / d
    return {
        "qkv_reduction": red(dense.qkv, sparse.qkv),
        "attention_reduction": red(dense.attention, sparse.attention),
        "ffn_reduction": red(dense.ffn, sparse.ffn),
        "overall_reduction": red(dense.total, sparse.total),
        "overhead_fraction": sparse.overhead / dense.total,
    }
