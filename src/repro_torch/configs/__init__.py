"""Architecture configurations of the PyTorch port.  Use
``repro_torch.configs.registry.get_config(name)``."""

from .base import ArchConfig, BlockCfg, LM_SHAPES, ShapeCfg

__all__ = ["ArchConfig", "BlockCfg", "LM_SHAPES", "ShapeCfg"]
