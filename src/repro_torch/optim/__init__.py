"""Optimizer, schedules and gradient compression of the port (the
reference's ``repro.optim``, on tensors updated in place)."""

from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm)
from .schedules import constant, warmup_cosine
from .grad_compress import (CompressionState, compress, compress_init,
                            compressed_mean, decompress)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "constant",
           "warmup_cosine", "CompressionState", "compress", "compress_init",
           "compressed_mean", "decompress"]
