"""Packed execution of the SPLS-sparsified linear ops.

Both operations dispatch through the compute-backend registry
(:mod:`repro_torch.sparse_compute.backend`):

* :func:`packed_project_q` -- Q projection of a packed row subset in the
  structured GQA layout, RoPE'd at the rows' *original* positions.  The
  serving prefill packs Q to the **cross-head union** of critical rows, so
  per-head leader recovery reads slots that were actually computed and a
  single ``(C, D) @ (D, H*Dh)`` product stays dense.
* :func:`packed_project_kv` -- K/V projection of a packed column subset
  (the ``vote_horizon == 1`` keep decision), K RoPE'd at the columns'
  original positions: pruned columns are never projected.
* :func:`packed_mlp` -- the dense (gated) MLP on FFN-critical token rows
  with leader broadcast.  The down-projection runs on rows that are
  already packed, so it is a plain ``torch.matmul``.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparse_exec import Compaction
from repro_torch.models.common import (Activations, apply_rope, rms_norm,
                                       rope_freqs)

from .backend import get_compute_backend

__all__ = ["packed_project_q", "packed_project_kv", "packed_mlp"]


def packed_project_q(cfg, p: dict, xn: torch.Tensor, positions: torch.Tensor,
                     perm: torch.Tensor, backend: str) -> torch.Tensor:
    """Project Q for a packed row subset (B = 1, structured layout).

    xn: (1, L, D) normalized block input; positions: (L,) original row
    ids; perm: (C,) int32 packed source rows.  Returns ``(1, KV, G, C,
    Dh)`` whose slot ``c`` is row ``perm[c]`` of
    :func:`repro_torch.models.attention.project_qkv`'s q output.
    """
    D, KV, Dh = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // KV
    C = perm.shape[0]
    wq2 = p["wq"].reshape(D, KV * G * Dh)
    be = get_compute_backend(backend)
    qg = be.gathered_matmul(xn[0].contiguous(), wq2.contiguous(),
                            perm.contiguous())           # (C, KV*G*Dh)
    q = qg.reshape(1, C, KV, G, Dh).permute(0, 2, 3, 1, 4).to(xn.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    pos_p = positions.index_select(0, perm.long())[None, :]   # (1, C)
    sin, cos = rope_freqs(pos_p, Dh, cfg.rope_theta)
    return apply_rope(q, sin[:, None, None], cos[:, None, None])


def packed_project_kv(cfg, p: dict, xn: torch.Tensor,
                      positions: torch.Tensor, perm: torch.Tensor,
                      backend: str):
    """Project K/V for a packed column subset (B = 1, structured layout).

    xn: (1, L, D) normalized block input; positions: (L,) original slot
    ids; perm: (C,) int32 packed source rows.  Returns ``(k, v)`` of shape
    ``(1, KV, C, Dh)`` whose slot ``c`` is row ``perm[c]`` of
    :func:`repro_torch.models.attention.project_kv`'s output (k-norm and
    RoPE are row-wise).  The packed backends sum the products in float64
    and round once, so ``packed_torch`` and ``packed_cuda`` give the same
    bits; ``dense`` takes rows of the full product.
    """
    D, KV, Dh = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
    C = perm.shape[0]
    be = get_compute_backend(backend)
    x2 = xn[0].contiguous()
    perm = perm.to(torch.int32).contiguous()
    kg = be.gathered_matmul(x2, p["wk"].reshape(D, KV * Dh).contiguous(),
                            perm)
    vg = be.gathered_matmul(x2, p["wv"].reshape(D, KV * Dh).contiguous(),
                            perm)
    k = kg.reshape(1, C, KV, Dh).permute(0, 2, 1, 3).to(xn.dtype)
    v = vg.reshape(1, C, KV, Dh).permute(0, 2, 1, 3).to(xn.dtype)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    pos_p = positions.index_select(0, perm.long())[None, :]   # (1, C)
    sin, cos = rope_freqs(pos_p, Dh, cfg.rope_theta)
    return apply_rope(k, sin[:, None], cos[:, None]), v


def packed_mlp(cfg, p: dict, x: torch.Tensor, comp: Compaction,
               backend: str) -> torch.Tensor:
    """Dense (gated) MLP on packed critical rows + leader broadcast.

    x: (B, L, D); comp: compaction over (B, L).  Returns (B, L, D):
    critical rows carry their own MLP output, similar rows their MFI
    leader's, overflow rows their window leader's.  Batch rows flatten
    into the gather indices so one kernel call serves the whole batch.
    """
    B, L, D = x.shape
    C = comp.perm.shape[-1]
    act = Activations.fn(cfg.ffn_activation)
    be = get_compute_backend(backend)
    ar = torch.arange(B, dtype=torch.int32, device=x.device)[:, None]
    perm = (comp.perm + ar * L).reshape(-1).to(torch.int32).contiguous()
    slot = (comp.src_slot + ar * C).reshape(-1).to(torch.int32).contiguous()
    x2 = x.reshape(B * L, D).contiguous()
    up = be.gathered_matmul(x2, p["w_up"].contiguous(), perm)    # (B*C, F)
    if "w_gate" in p:
        up = up * act(be.gathered_matmul(x2, p["w_gate"].contiguous(), perm))
    else:
        up = act(up)
    up = up.to(x.dtype)
    down = up @ p["w_down"]                      # rows already packed
    return be.gather_rows(down, slot).reshape(B, L, D)
