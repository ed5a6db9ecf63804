"""Cycle-level performance model of the ESACT accelerator (Sec. V-C).

The paper builds a Verilator-calibrated cycle simulator; without RTL we
reproduce its *structure*: per-stage cycle counts for a weight-stationary
16x64 PE array at 500 MHz, scaled by the sparsity ratios the SPLS run
actually measured, with the progressive-generation overlap and the
dynamic-allocation utilization recovery applied as in Sec. IV-C/D.

The model reports the same speedup decomposition as Fig. 20:
  dense ASIC -> +SPLS sparsity -> +progressive generation -> +dynamic
  allocation, multiplying to the end-to-end speedup.

The port's own copy of the reference's model (pure Python, the same
arithmetic), with :func:`reductions_from_report`, which feeds it the
sparsity :func:`repro_torch.core.flops.reduction_report` measured.  Its
figures are the modelled accelerator's (16 x 64 PEs at 500 MHz), not a
time or an energy of the device the port runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["ESACTConfig", "stage_cycles", "speedup_breakdown",
           "reductions_from_report"]


@dataclasses.dataclass(frozen=True)
class ESACTConfig:
    pe_rows: int = 16
    pe_cols: int = 64
    freq_hz: float = 500e6
    # utilization of the PE array on irregular similarity-sparse work before
    # and after the dynamic allocation strategy (Sec. V-C reports 81.57% at
    # k=0.1; dynamic matching shortens the critical path)
    util_before_dynamic: float = 0.8157
    util_after_dynamic: float = 0.849   # calibrated: paper's 1.04x dynamic gain
    # fraction of prediction latency hidden by progressive generation
    progressive_overlap: float = 0.85

    @property
    def macs_per_cycle(self) -> int:
        return self.pe_rows * self.pe_cols


def _stage_macs(L: int, D: int, H: int, d_ff: int) -> Dict[str, float]:
    """Dense per-layer MAC counts for the three sparsifiable stages."""
    return {
        "qkv": 4.0 * L * D * D,                 # Wq, Wk, Wv, Wo
        "attention": 2.0 * L * L * D,           # QK^T + AV over all heads
        "ffn": 2.0 * L * D * d_ff,
    }


def _prediction_macs(L: int, D: int, H: int) -> float:
    """SPLS prediction work (HLog matmuls are additions on the ASIC; we
    charge them at 0.5 MAC-equivalents per the SJA's adder datapath)."""
    qk_pred = 2.0 * L * D * D
    attn_pred = L * L * D / max(H, 1)  # per-head Dh contraction
    similarity = L * L  # L1 adds on SPA
    return 0.5 * (qk_pred + attn_pred) + similarity


def stage_cycles(cfg: ESACTConfig, L: int, D: int, H: int, d_ff: int,
                 reductions: Dict[str, float] | None = None,
                 progressive: bool = False, dynamic: bool = False
                 ) -> Dict[str, float]:
    """Per-stage cycles for one transformer layer.

    ``reductions``: fractional computation removed per stage, e.g. the
    measured SPLS numbers {"qkv": .65, "attention": .94, "ffn": .50};
    None = dense.
    """
    macs = _stage_macs(L, D, H, d_ff)
    red = reductions or {"qkv": 0.0, "attention": 0.0, "ffn": 0.0}
    util = cfg.util_after_dynamic if dynamic else cfg.util_before_dynamic
    out: Dict[str, float] = {}
    for stage, m in macs.items():
        kept = m * (1.0 - red.get(stage, 0.0))
        u = util if red.get(stage, 0.0) > 0 else 1.0  # dense runs at 100%
        out[stage] = kept / (cfg.macs_per_cycle * u)
    if reductions is not None:
        pred = _prediction_macs(L, D, H) / cfg.macs_per_cycle
        if progressive:
            pred *= (1.0 - cfg.progressive_overlap)
        out["prediction"] = pred
    else:
        out["prediction"] = 0.0
    out["total"] = sum(out.values())
    return out


def speedup_breakdown(L: int, D: int, H: int, d_ff: int,
                      reductions: Dict[str, float],
                      cfg: ESACTConfig = ESACTConfig()) -> Dict[str, float]:
    """Fig. 20-style multiplicative decomposition over one layer."""
    dense = stage_cycles(cfg, L, D, H, d_ff, None)["total"]
    spls = stage_cycles(cfg, L, D, H, d_ff, reductions)["total"]
    prog = stage_cycles(cfg, L, D, H, d_ff, reductions,
                        progressive=True)["total"]
    dyn = stage_cycles(cfg, L, D, H, d_ff, reductions, progressive=True,
                       dynamic=True)["total"]
    return {
        "spls_speedup": dense / spls,
        "progressive_speedup": spls / prog,
        "dynamic_speedup": prog / dyn,
        "end_to_end_speedup": dense / dyn,
        "dense_cycles": dense,
        "final_cycles": dyn,
        "tokens_per_s": L * cfg.freq_hz / dyn,
    }


def reductions_from_report(report: Dict[str, float]) -> Dict[str, float]:
    """``reduction_report``'s per-component keys -> the ``reductions`` of
    :func:`stage_cycles` (``qkv`` / ``attention`` / ``ffn``)."""
    return {"qkv": float(report["qkv_reduction"]),
            "attention": float(report["attention_reduction"]),
            "ffn": float(report["ffn_reduction"])}
