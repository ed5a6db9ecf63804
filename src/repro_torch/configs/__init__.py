"""Architecture configurations of the PyTorch port."""

from .base import ArchConfig, BlockCfg

__all__ = ["ArchConfig", "BlockCfg"]
