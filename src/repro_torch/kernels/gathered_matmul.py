"""Gathered matmul and row gather: the packed linear ops' kernels.

``gathered_matmul(x, w, perm)`` computes ``x[perm] @ w`` with the row
gather fused into the tile loads (CUDA source ``csrc/gathered_matmul.cu``;
it replaces the Pallas TPU kernel ``repro/kernels/gathered_matmul.py::
gathered_matmul``).  ``gather_rows(src, idx)`` computes ``src[idx]``, the
leader scatter of packed outputs back to every row (``csrc/gather_rows.cu``;
replaces ``gathered_matmul.py::gather_rows_kernel``).  Each source file
says what bounds its kernel on the card and what the design does about it.

Beside each kernel sits its plain PyTorch version.  The wrapper takes it
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises -- there is no fallback.  Each wrapper counts its launches in a
plain ``launches`` integer, so a run can show that the main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["gathered_matmul", "gather_rows", "gathered_matmul_plain",
           "gather_rows_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(name: str, fn: str, argtypes):
    f = getattr(_build.library(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}; the kernel takes "
                        f"{dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch "
                           f"(cudaError_t {rc})")


def gathered_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                          perm: torch.Tensor,
                          src_slot: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version: gather, then a float64 matrix product rounded to
    float32 (then gather the output rows); out-of-range indices clamp like
    the kernel's.  Like the kernel it accumulates in float64, so the two
    round to the same float32 values whatever their summation orders."""
    rows = perm.long().clamp(0, x.shape[0] - 1)
    out = (x.index_select(0, rows).double() @ w.double()).float()
    return out if src_slot is None else gather_rows_plain(out, src_slot)


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``src[idx]`` with indices clamped into range."""
    return src.index_select(0, idx.long().clamp(0, src.shape[0] - 1))


def gathered_matmul(x: torch.Tensor, w: torch.Tensor, perm: torch.Tensor,
                    src_slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[perm] @ w`` -> (C, F) float32, accumulated in float64 and
    rounded once (so it matches the plain version bit for bit); with
    ``src_slot`` (M,), the
    leader-scattered (M, F) ``out[r] = (x[perm] @ w)[src_slot[r]]``
    (:func:`gather_rows` as the epilogue).

    x: (L, D) float32; w: (D, F) float32; perm: (C,) int32 (repeats
    allowed).  CPU tensors take the plain version; CUDA tensors launch
    the kernel on the current stream, without synchronising.
    """
    if x.device.type == "cpu":
        return gathered_matmul_plain(x, w, perm, src_slot)
    if x.device.type != "cuda":
        raise ValueError(f"gathered_matmul runs on CUDA or CPU tensors, "
                         f"got {x.device}")
    dev = x.device
    _check(x, "x", torch.float32, 2, dev)
    _check(w, "w", torch.float32, 2, dev)
    _check(perm, "perm", torch.int32, 1, dev)
    (L, D), (D2, F), C = x.shape, w.shape, perm.shape[0]
    if D != D2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if L == 0 or C == 0 or F == 0:
        raise ValueError("gathered_matmul needs non-empty x, perm and w")
    out = torch.empty((C, F), dtype=torch.float32, device=dev)
    fn = _lib("gathered_matmul", "gathered_matmul_f32",
              [_P, _P, _P, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(fn(x.data_ptr(), w.data_ptr(), perm.data_ptr(),
                     out.data_ptr(), L, D, F, C, stream), "gathered_matmul")
    gathered_matmul.launches += 1
    return out if src_slot is None else gather_rows(out, src_slot)


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]``: src (C, F) float32, idx (M,) int32 ->
    (M, F).  CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream, without synchronising."""
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"gather_rows runs on CUDA or CPU tensors, got "
                         f"{src.device}")
    dev = src.device
    _check(src, "src", torch.float32, 2, dev)
    _check(idx, "idx", torch.int32, 1, dev)
    (C, F), M = src.shape, idx.shape[0]
    if C == 0 or F == 0 or M == 0:
        raise ValueError("gather_rows needs non-empty src and idx")
    out = torch.empty((M, F), dtype=torch.float32, device=dev)
    fn = _lib("gather_rows", "gather_rows_f32",
              [_P, _P, _P, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), C, F, M,
                     stream), "gather_rows")
    gather_rows.launches += 1
    return out


gathered_matmul.launches = 0
gather_rows.launches = 0
