"""Compute-backend registry: how token-compacted linear ops execute.

Every backend provides the same two primitives::

    gathered_matmul(x, w, perm, src_slot=None)  ->  (C, F) or (M, F)
    gather_rows(rows, idx)                      ->  rows[idx]

with ``x: (L, D)`` source rows, ``perm: (C,)`` int32 packed row indices
and ``src_slot: (M,)`` the packed slot each output row reads.

  * ``dense``        -- compute every row, gather afterwards (the
    simulation-mode semantics; zero compute saving).
  * ``packed_torch`` -- the kernels' plain PyTorch versions: gather the
    packed rows, matmul at the reduced size (accumulated in float64, as
    the kernel does, so the two give the same plans), gather the outputs.
  * ``packed_cuda``  -- the CUDA kernels
    (:func:`repro_torch.kernels.gathered_matmul` with the gather fused into
    the tile loads, :func:`repro_torch.kernels.gather_rows`).

The reference package's names are aliases (``packed_xla`` ->
``packed_torch``, ``packed_pallas`` -> ``packed_cuda``), so one
``ServeConfig`` drives both packages.  ``"auto"`` without a sparsity plan
is ``dense``; with one it resolves by device: the kernels on the card,
plain PyTorch on the CPU -- or, given a ``platform`` (the reference's
argument, or :func:`repro_torch.device.route_as`, which training sets to
``"cpu"``), by the reference's rule for it: ``packed_cuda`` on ``"tpu"`` /
``"cuda"``, ``packed_torch`` elsewhere, on any device.  The kernels have no
backward: their wrappers refuse inputs that need a gradient, and
``packed_torch`` is the differentiable route.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import route_platform
from repro_torch.kernels import (gather_rows, gather_rows_plain,
                                 gathered_matmul, gathered_matmul_plain)

__all__ = ["AUTO", "DENSE", "register_compute_backend", "get_compute_backend",
           "available_compute_backends", "resolve_compute_backend",
           "is_packed"]

AUTO = "auto"
DENSE = "dense"
_ALIASES = {"packed_xla": "packed_torch", "packed_pallas": "packed_cuda"}


class _ComputeBackend(NamedTuple):
    gathered_matmul: Callable
    gather_rows: Callable
    doc: str


def _torch_gather_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return rows.index_select(0, idx.long())


def _dense_gathered_matmul(x, w, perm, src_slot=None):
    out = (x @ w).index_select(0, perm.long())
    return out if src_slot is None else _torch_gather_rows(out, src_slot)


def _cuda_gathered_matmul(x, w, perm, src_slot=None):
    # the kernel takes float32: a bf16 model casts on the way in, as the
    # reference's wrapper does, and gets float32 back, as from the reference
    return gathered_matmul(x.float(), w.float(), perm, src_slot)


_REGISTRY: Dict[str, _ComputeBackend] = {
    DENSE: _ComputeBackend(
        _dense_gathered_matmul, _torch_gather_rows,
        "compute every row, gather afterwards (simulation-mode semantics)"),
    "packed_torch": _ComputeBackend(
        gathered_matmul_plain, gather_rows_plain,
        "the kernels' plain versions: gather -> reduced matmul -> gather"),
    "packed_cuda": _ComputeBackend(
        _cuda_gathered_matmul, gather_rows,
        "CUDA gathered matmul (gather fused into tile loads) + row gather"),
}


def register_compute_backend(name: str, gathered_matmul: Callable,
                             gather_rows: Callable, doc: str = "") -> None:
    """Register the two primitives (module docstring) under ``name``; it
    then resolves through :func:`resolve_compute_backend` as a non-packed
    backend, as in the reference."""
    _REGISTRY[name] = _ComputeBackend(gathered_matmul, gather_rows, doc)


def available_compute_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get_compute_backend(name: str) -> _ComputeBackend:
    try:
        return _REGISTRY[_canonical(name)]
    except KeyError:
        raise ValueError(
            f"unknown compute backend {name!r}; "
            f"registered: {available_compute_backends()}") from None


def is_packed(name: Optional[str]) -> bool:
    """True for backends that actually shrink the computed row count."""
    return name is not None and _canonical(name) in ("packed_torch",
                                                     "packed_cuda")


def resolve_compute_backend(name: Optional[str], *, sparse: bool,
                            device: torch.device,
                            platform: Optional[str] = None) -> str:
    """Map a configured name (possibly ``"auto"``/None or a reference
    alias) to a registry key; ``platform`` as in the module docstring
    (default: :func:`repro_torch.device.route_platform`).  Packed backends
    without SPLS raise: there is no critical-row structure to pack by."""
    name = name or AUTO
    if name == AUTO:
        if not sparse:
            return DENSE
        platform = platform or route_platform()
        if platform is None:
            on_card = torch.device(device).type == "cuda"
        else:
            on_card = platform in ("tpu", "cuda")
        return "packed_cuda" if on_card else "packed_torch"
    canon = _canonical(name)
    if canon not in _REGISTRY:
        raise ValueError(
            f"unknown compute backend {name!r}; "
            f"registered: {available_compute_backends()}")
    if is_packed(canon) and not sparse:
        raise ValueError(
            f"compute backend {name!r} packs SPLS critical rows, but SPLS "
            f"is disabled (spls.enabled=False): there is no sparsity plan "
            f"to pack by -- use 'dense' or enable SPLS")
    return canon
