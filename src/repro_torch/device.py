"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and without a CUDA device that raises
instead of silently running on the CPU.  Every comparison in this
repository is float32, so TF32 is switched off for matrix products and
convolutions on the way in.

:func:`route_as` makes the backend registries resolve ``"auto"`` as the
reference does on a given platform, whatever device the tensors are on:
training runs under ``route_as("cpu")`` (see
:mod:`repro_torch.launch.steps`).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional, Union

import torch

__all__ = ["resolve_device", "route_as", "route_platform"]

_ROUTE = contextvars.ContextVar("repro_torch_route_platform", default=None)


def route_platform() -> Optional[str]:
    """The platform set by the innermost :func:`route_as`, or None (resolve
    by the tensors' device)."""
    return _ROUTE.get()


@contextlib.contextmanager
def route_as(platform: Optional[str]) -> Iterator[None]:
    """Inside the block, ``"auto"`` attention and compute backends resolve
    by the reference's rule for ``platform`` (the ``platform`` argument of
    its ``resolve_backend``): ``"cpu"`` picks its XLA choices (the port's
    ``torch_dense`` / ``torch_chunked`` / ``packed_torch``), ``"tpu"`` or
    ``"cuda"`` the kernels; None restores the choice by device."""
    token = _ROUTE.set(platform)
    try:
        yield
    finally:
        _ROUTE.reset(token)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default -- pass device='cpu' to run on the CPU")
    return dev
