"""Hand-written CUDA kernels of the PyTorch port, with their plain
versions and launch counters.

Sources live in ``repro_torch/csrc/`` and build with ``nvcc`` at first use
(:mod:`._build`).  Each wrapper takes its plain PyTorch version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.  No kernel
has a backward (nor has the reference's): on either device a wrapper
raises when grad mode is on and an input requires grad, and the
``*_plain`` functions stay differentiable.
:mod:`.ops` holds the reference's public entry points over them
(``predict_matmul``, ``attention``, ``window_distances``).
"""

from .gathered_matmul import (gather_rows, gather_rows_plain,
                              gathered_matmul, gathered_matmul_plain)
from .paged_decode import paged_decode_plain, paged_flash_decode
from .flash_attention import flash_attention, flash_attention_plain
from .flash_decode import flash_decode, flash_decode_plain
from .hlog_qmatmul import hlog_qmatmul, hlog_qmatmul_plain
from .local_similarity import local_similarity_dist, local_similarity_plain
from .spls_plan import spls_mfi, spls_plan_block
from . import ops

KERNELS = (gathered_matmul, gather_rows, paged_flash_decode,
           flash_attention, flash_decode, hlog_qmatmul,
           local_similarity_dist, spls_plan_block, spls_mfi)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches since the last reset}``."""
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = ["gathered_matmul", "gather_rows", "paged_flash_decode",
           "flash_attention", "flash_decode", "hlog_qmatmul",
           "local_similarity_dist", "gathered_matmul_plain",
           "gather_rows_plain", "paged_decode_plain",
           "flash_attention_plain", "flash_decode_plain",
           "hlog_qmatmul_plain", "local_similarity_plain", "spls_plan_block",
           "spls_mfi", "ops", "KERNELS",
           "reset_launch_counts", "launch_counts"]
