"""The per-head SPLS plan block and its MFI vote: one launch each a layer.

``spls_plan_block(scores, ...)`` turns a row block's raw PAM scores
``(B, KV, G, C, S)`` (the output of :func:`repro_torch.core.predict.
head_scores`) into the block's intra-row top-k mask, its per-window
critical rows and leaders and its per-head column OR -- what
:func:`repro_torch.core.spls_chunked.plan_chunk` computes for each head.
``spls_mfi(leader, w, f)`` is the block's MFI vote over heads (CUDA source
``csrc/spls_plan.cu`` for both).  Neither replaces a TPU kernel: the
reference computes this block with XLA ops; on the card the same chain was
~290 small PyTorch ops a layer, whose enqueueing set the pace of a serving
chunk step.  The source says what bounds the kernels and how their design
answers it.

:func:`repro_torch.core.spls_chunked.spls_plan_block_plain` (the chain
of the PAM rounded to bf16 and filled, the bisection top-k, the SPA, the
local similarity and the column OR) and
:func:`repro_torch.core.mfi.mfi_ffn_sparsity` are the plain versions.
The wrappers take them only for CPU tensors; CUDA tensors launch the
kernel or raise.  The mask, the column OR and the MFI outputs equal the
plain versions bit for bit; the kernel sums the distances in float64 and
rounds once, so ``is_critical`` and ``leader`` may differ from the plain
float32 chain only where a pair's normalized distance lies within float32
rounding of ``s_threshold``.  ``C % w != 0`` and ``w > 16`` raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .gathered_matmul import _check, _fn, _launch, _on_cpu, _refuse_grad

__all__ = ["MAX_WINDOW", "spls_plan_block", "spls_mfi"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the C entries' argument types (the stream last)
_PLAN_ARGS = (_P,) * 5 + (ctypes.c_longlong, _I, _I, _I, _F, _F) \
    + (_I,) * 5 + (_F, _I, _P)
_MFI_ARGS = (_P,) * 4 + (_I,) * 5 + (_P,)
MAX_WINDOW = 16            # the leader scan keeps a window's rows in a block

PlanBlock = Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                  Optional[torch.Tensor], torch.Tensor]


@functools.lru_cache(maxsize=1)
def _fill32() -> float:
    """The PAM's fill as the plain chain holds it: rounded to bf16,
    widened."""
    from repro_torch.core.spls_chunked import CAUSAL_FILL

    return float(torch.tensor(CAUSAL_FILL, dtype=torch.bfloat16).float())


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _validate(scores: torch.Tensor, w: Optional[int],
              s_threshold: Optional[float], votes_only: bool) -> None:
    """The wrapper's contract, on either device: float32 scores (bf16 ones,
    a bf16 model's, too), 5-D and non-empty; unless ``votes_only``, a
    window of 1 to 16 rows that divides C, and a threshold."""
    if scores.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scores has dtype {scores.dtype}; spls_plan_block "
                        f"takes float32 (or bfloat16) scores")
    if scores.dim() != 5 or scores.numel() == 0:
        raise ValueError(f"scores must be non-empty (B, KV, G, C, S), got "
                         f"shape {tuple(scores.shape)}")
    C = scores.shape[-2]
    if not votes_only and (w is None or s_threshold is None
                           or not 1 <= w <= MAX_WINDOW or C % w):
        raise ValueError(f"spls_plan_block needs 1 <= w <= {MAX_WINDOW} with "
                         f"C a multiple of w, and an s_threshold; got w {w}, "
                         f"s_threshold {s_threshold}, C {C}")


def spls_plan_block(scores: torch.Tensor, *, scale: float, k, row0,
                    n_valid_rows, n_cols, causal: bool,
                    w: Optional[int] = None,
                    s_threshold: Optional[float] = None,
                    votes_only: bool = False) -> PlanBlock:
    """scores (B, KV, G, C, S) float32 -> the plan block of
    :func:`repro_torch.core.spls_chunked.spls_plan_block_plain`.  CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream (after zeroing ``kv_any`` there), without
    synchronising.  bf16 scores are widened
    first on the card (exact: the plain chain multiplies them in float32
    and rounds to bf16 as well)."""
    if torch.is_grad_enabled() and scores.requires_grad:
        _refuse_grad("spls_plan_block", "spls_plan_block_plain")
    _validate(scores, w, s_threshold, votes_only)
    if not scores.is_cuda and _on_cpu(scores, "spls_plan_block"):
        from repro_torch.core.spls_chunked import spls_plan_block_plain

        return spls_plan_block_plain(
            scores, scale=scale, k=k, row0=row0, n_valid_rows=n_valid_rows,
            n_cols=n_cols, causal=causal, w=w, s_threshold=s_threshold,
            votes_only=votes_only)
    dev = scores.get_device()
    scores = scores.to(torch.float32)
    _check(scores, "scores", torch.float32, 5, dev)
    B, KV, G, C, S = scores.shape
    kv_any = torch.empty((B, KV, G, S), dtype=torch.bool, device=dev)
    mask = crit = lead = None
    if not votes_only:
        mask = torch.empty(scores.shape, dtype=torch.bool, device=dev)
        crit = torch.empty((B, KV, G, C), dtype=torch.bool, device=dev)
        lead = torch.empty((B, KV, G, C), dtype=torch.int32, device=dev)
    fn = _fn("spls_plan", "spls_plan_block_f32", _PLAN_ARGS)
    _launch(fn, dev, "spls_plan_block", scores.data_ptr(), _ptr(mask),
            _ptr(crit), _ptr(lead), kv_any.data_ptr(), B * KV * G, C, S,
            w or 0, scale, _fill32(), int(k), int(row0), int(n_valid_rows),
            int(n_cols), int(causal), s_threshold or 0.0, int(votes_only))
    spls_plan_block.launches += 1
    return mask, crit, lead, kv_any


spls_plan_block.launches = 0


def spls_mfi(leader: torch.Tensor, w: int, f_threshold: int):
    """leader (B, H, L) int32 per-head leaders -> an
    :class:`~repro_torch.core.mfi.FFNSparsity` over (B, L), as
    :func:`~repro_torch.core.mfi.mfi_ffn_sparsity` (3 pointer jumps).  CPU
    tensors take it; CUDA tensors launch the kernel on the current
    stream."""
    from repro_torch.core.mfi import FFNSparsity, mfi_ffn_sparsity

    if leader.dtype != torch.int32:
        raise TypeError(f"leader has dtype {leader.dtype}; spls_mfi takes "
                        f"int32")
    if (leader.dim() != 3 or leader.numel() == 0
            or not 1 <= w <= MAX_WINDOW or leader.shape[0] > 65535):
        raise ValueError(f"spls_mfi needs non-empty (B, H, L) leaders, B <= "
                         f"65535, and 1 <= w <= {MAX_WINDOW}; got w {w}, "
                         f"leader {tuple(leader.shape)}")
    if not leader.is_cuda and _on_cpu(leader, "spls_mfi"):
        return mfi_ffn_sparsity(leader, w, f_threshold)
    dev = leader.get_device()
    _check(leader, "leader", torch.int32, 3, dev)
    B, H, L = leader.shape
    crit = torch.empty((B, L), dtype=torch.bool, device=dev)
    out = torch.empty((B, L), dtype=torch.int32, device=dev)
    votes = torch.empty((B, L), dtype=torch.int32, device=dev)
    fn = _fn("spls_plan", "spls_mfi_i32", _MFI_ARGS)
    _launch(fn, dev, "spls_mfi", leader.data_ptr(), crit.data_ptr(),
            out.data_ptr(), votes.data_ptr(), B, H, L, w, int(f_threshold))
    spls_mfi.launches += 1
    return FFNSparsity(is_critical=crit, leader=out, votes=votes)


spls_mfi.launches = 0
