"""Most-Frequent-Index (MFI) token similarity for FFN sparsification.

Sec. III-D: each token is represented by the critical-row index it maps
to in every head; the *mode* across heads (the MFI) wins if at least ``f``
heads agree, and then the token copies the MFI token's FFN output.
Leaders are window-local, so the vote is a one-hot histogram over offsets
in ``[0, w)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["FFNSparsity", "mfi_ffn_sparsity"]


class FFNSparsity(NamedTuple):
    is_critical: torch.Tensor  # (..., L) bool: FFN actually computed
    leader: torch.Tensor       # (..., L) int32: token whose output is reused
    votes: torch.Tensor        # (..., L) int32: MFI vote count


def mfi_ffn_sparsity(leader: torch.Tensor, w: int, f_threshold: int,
                     n_pointer_jumps: int = 3) -> FFNSparsity:
    """leader: (..., H, L) int32 per-head leaders -> per-token FFN sparsity
    over (..., L).  Leader chains are flattened by pointer jumping so every
    similar token ends on an FFN-critical token."""
    *lead, H, L = leader.shape
    off = leader % w
    # one-hot histogram (F.one_hot would sync the device to range-check)
    bins = torch.arange(w, dtype=off.dtype, device=off.device)
    counts = (off[..., None] == bins).to(torch.int32).sum(dim=-3)  # (..., L, w)
    mfi_votes, _ = counts.max(dim=-1)
    mfi_off = counts.argmax(dim=-1).to(torch.int32)          # first maximum

    tok = torch.arange(L, dtype=torch.int32, device=leader.device)
    tok = tok.expand(*lead, L)
    window_base = (tok // w) * w
    mfi_global = torch.clamp(window_base + mfi_off, max=L - 1)

    # ``~ ==``, not ``!=``: torch 2.11's DTensor has no rule for ``ne``
    similar = (mfi_votes >= f_threshold) & ~(mfi_global == tok)
    ffn_leader = torch.where(similar, mfi_global, tok)
    for _ in range(n_pointer_jumps):
        ffn_leader = torch.gather(ffn_leader, -1, ffn_leader.long())
    is_crit = ffn_leader == tok
    return FFNSparsity(is_critical=is_crit, leader=ffn_leader,
                       votes=mfi_votes.to(torch.int32))
