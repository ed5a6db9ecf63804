"""End-to-end sparse compute: token-compacted Q, K/V projections + FFN.

* :mod:`backend` -- the compute-backend registry (``dense`` |
  ``packed_torch`` | ``packed_cuda``; the reference names are aliases);
* :mod:`packed` -- packed Q projection on the critical-row union, packed
  K/V projection on the columns a ``vote_horizon == 1`` vote keeps, and
  the dense (gated) MLP on FFN-critical tokens, with leader broadcast;
* :mod:`capacity` -- the capacity controller (observed critical-row counts
  -> a small set of bucketed static capacities);
* :mod:`accounting` -- analytic FLOPs (dense vs executed) per serving
  prefill chunk.
"""

from .accounting import chunk_flops, saved_pct
from .backend import (AUTO, DENSE, available_compute_backends,
                      get_compute_backend, is_packed,
                      register_compute_backend, resolve_compute_backend)
from .capacity import CapacityController
from .packed import packed_mlp, packed_project_kv, packed_project_q

__all__ = [
    "AUTO", "DENSE", "available_compute_backends", "get_compute_backend",
    "is_packed", "register_compute_backend", "resolve_compute_backend",
    "CapacityController", "packed_mlp", "packed_project_kv",
    "packed_project_q", "chunk_flops", "saved_pct",
]
