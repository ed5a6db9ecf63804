"""Analytic FLOPs for serving prefill chunks: dense vs executed.

Counts multiply-accumulates x2 (mul + add), the same convention as
the reference package's ``core/flops.py``, for the three components the paper sparsifies --
QKV generation, attention score/value math, and the FFN -- as one
serving prefill chunk executes them.  The engine feeds these into the
scheduler's lifetime-FLOPs accounting so ``flops_saved_pct`` is tracked
per component from real serving runs (Fig. 15's breakdown, measured on
the serving path instead of derived from plan masks).

Serving-specific honesty notes:

* the output projection stays **dense** on the prefill path (its input
  is a per-row head mixture); the K/V projections stay dense *unless*
  the horizon-finalized prune vote is active with ``vote_horizon == 1``
  (``kv_rows``): only then are a chunk's own pruned columns skipped
  before projection (:func:`~repro_torch.sparse_compute.packed.
  packed_project_kv`).  The ``kv`` component reports that share on its
  own so the saving is attributable.
* attention cost is the packed row count times *all columns seen so
  far* (cross-chunk causal attention), for dense and packed alike.
* padded chunk rows are charged like real rows: the engine executes
  them (static shapes), and the dense baseline pays the same padding.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from repro_torch.models.common import Activations

__all__ = ["chunk_flops", "saved_pct"]


def saved_pct(acc: Dict[str, Iterable[float]]) -> Dict[str, float]:
    """Percent of dense-equivalent FLOPs *not* executed, per component,
    from a ``{component: (dense_total, executed_total)}`` accumulator
    (the scheduler's lifetime shape; 0.0 for components never run).
    Shared by ``Scheduler.flops_saved_pct`` and the telemetry report so
    every surface derives the number one way."""
    out = {}
    for c, (dense, executed) in acc.items():
        out[c] = 100.0 * (1.0 - executed / dense) if dense > 0 else 0.0
    return out


def chunk_flops(cfg, rows: int, cols: int, q_rows: Optional[int] = None,
                ffn_rows: Optional[int] = None,
                kv_rows: Optional[int] = None
                ) -> Dict[str, Tuple[float, float]]:
    """Per-chunk (dense, executed) FLOPs for qkv / attn / ffn / kv.

    rows: chunk rows executed (the static chunk size); cols: KV columns
    attended (slots written so far, incl. this chunk); q_rows /
    ffn_rows / kv_rows: packed capacities actually computed (None =
    dense).  ``kv`` is the K/V-projection share reported standalone
    (it is also folded into ``qkv`` for the combined view).  Counts
    cover every attention block of the whole model (the paged engine is
    attention-only).
    """
    D, KV, Dh = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
    H = cfg.n_heads
    n_attn = len(cfg.period) * cfg.n_periods
    n_ffn = sum(1 for b in cfg.period if b.has_ffn) * cfg.n_periods
    mult = 3 if Activations.gated(cfg.ffn_activation) else 2

    q_rows = rows if q_rows is None else min(q_rows, rows)
    ffn_rows = rows if ffn_rows is None else min(ffn_rows, rows)
    kv_rows = rows if kv_rows is None else min(kv_rows, rows)

    def kv(nkv):
        return 2.0 * 2.0 * nkv * D * KV * Dh * n_attn    # K and V projections

    def qkv(nq, nkv):
        q = 2.0 * nq * D * H * Dh
        wo = 2.0 * rows * H * Dh * D              # out-proj stays dense
        return (q + wo) * n_attn + kv(nkv)

    def attn(nq):
        return 2.0 * 2.0 * H * nq * cols * Dh * n_attn   # QK^T + AV

    def ffn(nf):
        return mult * 2.0 * nf * D * cfg.d_ff * n_ffn

    return {"qkv": (qkv(rows, rows), qkv(q_rows, kv_rows)),
            "attn": (attn(rows), attn(q_rows)),
            "ffn": (ffn(rows), ffn(ffn_rows)),
            "kv": (kv(rows), kv(kv_rows))}
