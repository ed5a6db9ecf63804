"""Config registry: ``--arch <id>`` resolution for the launchers and tests
(a copy of the reference package's ``configs/registry.py``; the same ids,
modules and cells)."""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ArchConfig, LM_SHAPES, ShapeCfg

__all__ = ["ARCH_IDS", "get_config", "get_shape", "all_cells"]

# assignment id -> module name
_MODULES: Dict[str, str] = {
    "gemma2-27b": "gemma2_27b",
    "h2o-danube3-4b": "h2o_danube3_4b",
    "qwen3-0.6b": "qwen3_0_6b",
    "llama3-405b": "llama3_405b",
    "dbrx-132b": "dbrx_132b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-370m": "mamba2_370m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "pixtral-12b": "pixtral_12b",
    # the paper's own workload (not part of the 40-cell assignment)
    "bert-base-esact": "bert_base_esact",
}

ARCH_IDS: List[str] = [k for k in _MODULES if k != "bert-base-esact"]


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeCfg:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


def all_cells(include_skipped: bool = False):
    """Yield every (arch, shape) cell of the assignment (40 total).

    Cells whose shape the arch does not support (long_500k on pure
    full-attention archs) are skipped unless ``include_skipped``.
    """
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in LM_SHAPES:
            if shape.name in cfg.supported_shapes or include_skipped:
                yield arch_id, shape.name
