"""Energy/area model of ESACT (Tables II-IV).

Component area/power are the paper's synthesis numbers (TSMC 28 nm,
500 MHz).  Effective throughput counts dense-equivalent ops (the accelerator
convention: skipped work counts as delivered), so energy efficiency rises
with the measured sparsity -- reproducing the 3.27 TOPS/W end-to-end figure
and the SpAtten/Sanger comparison of Table IV.  The port's own copy of the
reference's model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from .cycles import ESACTConfig, stage_cycles

__all__ = ["ESACT_AREA_POWER", "BASELINES", "energy_efficiency",
           "attention_level_comparison", "total_power_w", "total_area_mm2"]

# Table II (total 5.09 mm^2, 792.12 mW)
ESACT_AREA_POWER: Dict[str, Dict[str, float]] = {
    "pe_array": {"area_mm2": 1.85, "power_mw": 324.14},
    "sparsity_prediction": {"area_mm2": 0.23, "power_mw": 57.43},
    "sram": {"area_mm2": 1.60, "power_mw": 317.84},
    "functional": {"area_mm2": 1.41, "power_mw": 92.71},
}

# Table IV, normalized to 28 nm by the paper
BASELINES: Dict[str, Dict[str, float]] = {
    "spatten": {"energy_eff_gops_w": 2261.0, "area_eff_gops_mm2": 677.0,
                "accuracy_loss": 0.007},
    "sanger": {"energy_eff_gops_w": 2958.0, "area_eff_gops_mm2": 1025.0,
               "accuracy_loss": 0.001},
}


def total_power_w() -> float:
    return sum(c["power_mw"] for c in ESACT_AREA_POWER.values()) / 1e3


def total_area_mm2() -> float:
    return sum(c["area_mm2"] for c in ESACT_AREA_POWER.values())


def energy_efficiency(L: int, D: int, H: int, d_ff: int,
                      reductions: Dict[str, float],
                      cfg: ESACTConfig = ESACTConfig()) -> Dict[str, float]:
    """End-to-end TOPS/W at the measured sparsity.

    Dense-equivalent ops per layer = 2 * total dense MACs; time from the
    cycle model with all three hardware features on.
    """
    dense_macs = (4.0 * L * D * D + 2.0 * L * L * D + 2.0 * L * D * d_ff)
    cyc = stage_cycles(cfg, L, D, H, d_ff, reductions, progressive=True,
                       dynamic=True)["total"]
    t = cyc / cfg.freq_hz
    ops = 2.0 * dense_macs
    tops = ops / t / 1e12
    return {
        "effective_tops": tops,
        "power_w": total_power_w(),
        "tops_per_w": tops / total_power_w(),
        "area_mm2": total_area_mm2(),
        "gops_per_mm2": ops / t / 1e9 / total_area_mm2(),
    }


def attention_level_comparison(L: int, D: int, H: int,
                               attn_reduction: float,
                               cfg: ESACTConfig = ESACTConfig()
                               ) -> Dict[str, float]:
    """Table IV: attention-only energy efficiency vs SpAtten / Sanger.

    Attention power = PE array + prediction + a proportional share of SRAM
    and functional logic (the paper attributes the full chip to the
    attention measurement).
    """
    dense_macs = 2.0 * L * L * D
    cyc = stage_cycles(cfg, L, D, H, 1, {"attention": attn_reduction,
                                         "qkv": 0.0, "ffn": 0.0},
                       progressive=True, dynamic=True)["attention"] + \
        stage_cycles(cfg, L, D, H, 1, {"attention": attn_reduction,
                                       "qkv": 0.0, "ffn": 0.0},
                     progressive=True, dynamic=True)["prediction"]
    t = cyc / cfg.freq_hz
    gops = 2.0 * dense_macs / t / 1e9
    eff = gops / total_power_w()
    return {
        "attention_gops": gops,
        "energy_eff_gops_w": eff,
        "vs_spatten": eff / BASELINES["spatten"]["energy_eff_gops_w"],
        "vs_sanger": eff / BASELINES["sanger"]["energy_eff_gops_w"],
        "area_eff_gops_mm2": gops / total_area_mm2(),
    }
