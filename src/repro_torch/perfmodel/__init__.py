"""Analytic performance and energy models of the ESACT accelerator: the
port's copy of the reference's ``perfmodel`` (no torch; it imports nothing
of either package).  Its cycles, speedups and TOPS/W are the modelled
accelerator's, not measurements of the device the port runs on."""

from .cycles import (ESACTConfig, reductions_from_report, speedup_breakdown,
                     stage_cycles)
from .energy import (BASELINES, ESACT_AREA_POWER, attention_level_comparison,
                     energy_efficiency, total_area_mm2, total_power_w)

__all__ = ["ESACTConfig", "stage_cycles", "speedup_breakdown",
           "reductions_from_report", "BASELINES", "ESACT_AREA_POWER",
           "energy_efficiency", "attention_level_comparison",
           "total_power_w", "total_area_mm2"]
