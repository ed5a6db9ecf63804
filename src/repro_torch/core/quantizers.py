"""Quantizers used by the SPLS sparsity-prediction pipeline.

The paper (ESACT, Sec. III-A) predicts the attention matrix *before* the
formal QKV generation, using aggressively quantized inputs/weights.  Three
log-domain quantizers are compared:

* **PoT**  -- power-of-two levels ``{2^m}``.
* **APoT** -- additive powers-of-two (a=2), levels ``{2^i + 2^j, i > j}``.
* **HLog** -- the paper's hybrid: powers of two plus their *intermediate
  averages*, eq. (1), i.e. ``{2^m} U {1.5 * 2^m}``.  Ties project to the
  *higher* level.

All quantizers operate on **integer magnitudes** obtained from an 8-bit
symmetric pre-quantization and return *dequantized* values on the original
scale.  The numerics follow the reference package exactly: ``round`` is
half-to-even, a tie between two levels goes up (``searchsorted`` with
``right=True``), and the bit-level encoder takes the exponent from the
leading one bit, not from a float ``log2``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.sharding.logical import map_local

__all__ = [
    "symmetric_quantize", "hlog_levels", "pot_levels", "apot_levels",
    "project_to_levels", "hlog_project", "pot_project", "apot_project",
    "hlog_bitlevel_encode", "hlog_bitlevel_decode", "hlog_bitlevel_project",
    "quantize_dequantize", "PROJECTORS",
]


def symmetric_quantize(x: torch.Tensor, bits: int = 8, axis=None,
                       eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor (or per-``axis``) quantization.

    Returns ``(q, scale)`` with ``q`` integer-valued (kept in ``x``'s float
    dtype) in ``[-(2^{bits-1}-1), 2^{bits-1}-1]`` and ``x ~= q * scale``.
    """
    qmax = float(2 ** (bits - 1) - 1)
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=eps) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q, scale


@functools.lru_cache(maxsize=None)
def hlog_levels(bits: int = 8) -> np.ndarray:
    """HLog magnitude levels ``{2^m} U {1.5 * 2^m}``, sorted ascending."""
    singles = [2.0 ** m for m in range(bits)]
    sums = [2.0 ** (m - 1) + 2.0 ** m for m in range(1, bits - 1)]
    return np.array(sorted(singles + sums), dtype=np.float64)


@functools.lru_cache(maxsize=None)
def pot_levels(bits: int = 8) -> np.ndarray:
    """Power-of-two magnitude levels ``{2^m : m = 0..bits-1}``."""
    return np.array([2.0 ** m for m in range(bits)], dtype=np.float64)


@functools.lru_cache(maxsize=None)
def apot_levels(bits: int = 8) -> np.ndarray:
    """Additive-PoT (a=2) magnitude levels ``{2^i} U {2^i + 2^j, i > j}``."""
    lv = set()
    for i in range(bits):
        lv.add(2.0 ** i)
        for j in range(i):
            lv.add(2.0 ** i + 2.0 ** j)
    return np.array(sorted(lv), dtype=np.float64)


@functools.lru_cache(maxsize=64)
def _level_tensors(levels: tuple, dtype: torch.dtype, device: torch.device):
    """(levels, midpoints) on ``device``, made once: a host-to-device copy
    per call would stall the stream."""
    lv = torch.tensor(levels, dtype=dtype).to(device)
    # midpoints between consecutive levels; value >= midpoint -> upper level
    return lv, (lv[:-1] + lv[1:]) / 2.0


def project_to_levels(mag: torch.Tensor, levels: np.ndarray) -> torch.Tensor:
    """Project non-negative magnitudes onto ``levels`` (nearest; tie -> up).
    Zero stays zero."""
    lv, mids = _level_tensors(tuple(np.asarray(levels).tolist()), mag.dtype,
                              mag.device)

    def project(m):
        proj = lv[torch.searchsorted(mids, m.contiguous(), right=True)]
        return torch.where(m == 0, torch.zeros_like(proj), proj)

    return map_local(project, mag)


def _signed_project(x: torch.Tensor, levels: np.ndarray) -> torch.Tensor:
    return torch.sign(x) * project_to_levels(x.abs(), levels)


def hlog_project(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Signed HLog projection of integer-valued ``x``."""
    return _signed_project(x, hlog_levels(bits))


def pot_project(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    return _signed_project(x, pot_levels(bits))


def apot_project(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    return _signed_project(x, apot_levels(bits))


def _leading_one(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) of positive int32 ``v`` from its bits (31 - clz)."""
    m = torch.zeros_like(v)
    for shift in (16, 8, 4, 2, 1):
        hi = (v >> shift) > 0
        m = m + torch.where(hi, shift, 0).to(v.dtype)
        v = torch.where(hi, v >> shift, v)
    return m


def hlog_bitlevel_encode(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Bit-level Shift-Detector encoding of integer-valued ``x`` (Fig. 12):
    the leading one ``m`` of the magnitude and the next two bits ``b1 b0``
    give ``form = b1 XOR b0`` and ``exp = m + (b1 AND b0)``, packed as
    ``sign << 4 | exp << 1 | form``; zero carries the flag bit 5."""
    mag = x.abs().to(torch.int32)
    sign = (x < 0).to(torch.int32)
    is_zero = mag == 0
    safe = torch.clamp(mag, min=1)
    m = _leading_one(safe)
    b1 = (safe >> torch.clamp(m - 1, min=0)) & 1
    b1 = torch.where(m >= 1, b1, 0)
    b0 = (safe >> torch.clamp(m - 2, min=0)) & 1
    b0 = torch.where(m >= 2, b0, 0)
    form = b1 ^ b0
    exp = m + (b1 & b0)
    code = (sign << 4) | (exp << 1) | form
    return torch.where(is_zero, torch.full_like(code, 1 << 5), code)


def hlog_bitlevel_decode(code: torch.Tensor) -> torch.Tensor:
    """Decode SD codes back to signed dequantized values (float32)."""
    is_zero = (code >> 5) & 1
    sign = (code >> 4) & 1
    exp = (code >> 1) & 7
    form = code & 1
    val = torch.exp2(exp.to(torch.float32)) * (1.0 + 0.5 * form.to(torch.float32))
    val = torch.where(sign == 1, -val, val)
    return torch.where(is_zero == 1, torch.zeros_like(val), val)


def hlog_bitlevel_project(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Encode+decode; bit-exact equal to :func:`hlog_project` on integers."""
    return hlog_bitlevel_decode(hlog_bitlevel_encode(x, bits))


PROJECTORS = {
    "hlog": hlog_project,
    "hlog_bitlevel": hlog_bitlevel_project,
    "pot": pot_project,
    "apot": apot_project,
    "none": lambda q, bits=8: q,
}


def quantize_dequantize(x: torch.Tensor, method: str = "hlog", bits: int = 8,
                        axis=None) -> torch.Tensor:
    """Full prediction-path quantization: int8 symmetric then log projection.
    Returns float values on the original scale of ``x``."""
    if method not in PROJECTORS:
        raise ValueError(f"unknown quantization method {method!r}; "
                         f"expected one of {sorted(PROJECTORS)}")
    q, scale = symmetric_quantize(x, bits=bits, axis=axis)
    return PROJECTORS[method](q, bits) * scale
