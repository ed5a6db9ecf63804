"""Atomic checkpointing (manifest + COMMITTED marker), in the reference's
layout."""

from .ckpt import cleanup_old, latest_step, restore_checkpoint, save_checkpoint

__all__ = ["cleanup_old", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
