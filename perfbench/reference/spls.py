"""The SPLS planning math, frozen for the benchmark's reference.

A plain PyTorch copy of what the streamed serving planner computes for one
window-aligned prompt chunk (the paper's progressive generation scheme,
Sec. IV-C): the HLog-quantized Q/K prediction with per-token scales, the
bf16-rounded predicted attention block, the bisection top-k, the local
similarity of the sparsified rows, the MFI vote for FFN sparsity, and the
static-capacity row packing with its window-leader fallback.

Copied from ``repro_torch.core`` (``quantizers.py``, ``predict.py``,
``spls_chunked.py``, ``similarity.py``, ``mfi.py``, ``topk.py``,
``sparse_exec.py``) so that a later change to the program cannot move the
yardstick; nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

CAUSAL_FILL = -3e38
NEG = -1e30


def topk_count(L: int, k_ratio: float) -> int:
    """Kept entries per row, at least 1 (``core/topk.py``)."""
    return max(1, min(L, math.ceil(k_ratio * L)))


# -- HLog quantization (core/quantizers.py) ----------------------------------

def _hlog_levels(bits: int):
    singles = [2.0 ** m for m in range(bits)]
    sums = [2.0 ** (m - 1) + 2.0 ** m for m in range(1, bits - 1)]
    return sorted(singles + sums)


def symmetric_quantize(x, bits=8, axis=None, eps=1e-8):
    qmax = float(2 ** (bits - 1) - 1)
    amax = x.abs().amax() if axis is None else x.abs().amax(dim=axis,
                                                            keepdim=True)
    scale = torch.clamp(amax, min=eps) / qmax
    return torch.clamp(torch.round(x / scale), -qmax, qmax), scale


def hlog_project(q, bits=8):
    """Signed nearest HLog level of integer-valued ``q``; a tie goes to the
    upper level; zero stays zero."""
    lv = torch.tensor(_hlog_levels(bits), dtype=q.dtype, device=q.device)
    mids = (lv[:-1] + lv[1:]) / 2.0
    m = q.abs()
    proj = lv[torch.searchsorted(mids, m.contiguous(), right=True)]
    return torch.sign(q) * torch.where(m == 0, torch.zeros_like(proj), proj)


def quantize_dequantize(x, bits=8, axis=None):
    q, scale = symmetric_quantize(x, bits, axis)
    return hlog_project(q, bits) * scale


def predict_heads(xn, wq, wk, KV, G, Dh, bits=8):
    """xn (1, C, D), wq (D, KV*G*Dh), wk (D, KV*Dh) -> ``qh (1, KV, G, C,
    Dh)``, ``kh (1, KV, C, Dh)``: the streaming predictor (per-token
    activation scales, per-tensor weight scales, K re-quantized per token
    to the int8 codes the predictor cache stores)."""
    C = xn.shape[1]
    xq = quantize_dequantize(xn, bits, axis=-1)
    q_pred = quantize_dequantize(xq @ quantize_dequantize(wq, bits), bits,
                                 axis=-1)
    k_pre = xq @ quantize_dequantize(wk, bits)
    kq, kscale = symmetric_quantize(k_pre, bits, axis=-1)
    kh = hlog_project(kq, bits) * kscale
    qh = q_pred.reshape(1, C, KV, G, Dh).permute(0, 2, 3, 1, 4)
    return qh, kh.reshape(1, C, KV, Dh).permute(0, 2, 1, 3)


# -- one plan block (core/spls_chunked.py, similarity.py, mfi.py) ------------

def bisect_topk_mask(pam32, k, n_iters=12):
    hi = pam32.amax(-1, keepdim=True)
    lo = torch.where(pam32 < -1e29, hi, pam32).amin(-1, keepdim=True)
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        ok = (pam32 >= mid).sum(-1, keepdim=True) >= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return pam32 >= lo


def local_similarity(spa, w, s, valid_len):
    """Greedy leader clustering in windows of ``w`` rows: row 0 of a window
    is critical, a later row joins the first earlier critical row within
    normalized L1 distance ``s``.  Returns ``(critical, leader)``."""
    *lead, L, Lk = spa.shape
    nw = -(-L // w)
    if nw * w - L:
        spa = F.pad(spa, (0, 0, 0, nw * w - L))
    xp = spa.reshape(*lead, nw, w, Lk)
    diff = (xp[..., :, None, :] - xp[..., None, :, :]).abs_().sum(-1)
    norm = xp.abs().sum(-1)
    d = (diff / (norm[..., :, None] + norm[..., None, :] + 1e-6)).float()
    rows = torch.arange(nw * w, dtype=torch.int32,
                        device=spa.device).reshape(nw, w)
    valid = (rows < valid_len).expand(*lead, nw, w)
    crit = [valid[..., 0]]
    off = [torch.zeros(valid.shape[:-1], dtype=torch.int32,
                       device=spa.device)]
    for j in range(1, w):
        elig = torch.stack([crit[i] & (d[..., i, j] <= s) for i in range(j)],
                           dim=-1)
        found = elig.any(-1)
        first = elig.to(torch.int32).argmax(-1).to(torch.int32)
        crit.append(valid[..., j] & ~found)
        off.append(torch.where(valid[..., j] & found, first,
                               torch.full_like(first, j)))
    base = (torch.arange(nw, dtype=torch.int32, device=spa.device)
            * w)[:, None]
    leader = (torch.stack(off, -1) + base).reshape(*lead, nw * w)[..., :L]
    crit = torch.stack(crit, -1).reshape(*lead, nw * w)[..., :L]
    return crit, torch.clamp(leader, max=L - 1)


def mfi_ffn(leader, w, f_threshold, jumps=3):
    """leader (B, H, L) -> ``(critical (B, L), ffn_leader (B, L))``: a token
    copies the most frequent window offset's token when at least
    ``f_threshold`` heads point there; chains flattened by pointer jumps."""
    *lead, H, L = leader.shape
    off = leader % w
    bins = torch.arange(w, dtype=off.dtype, device=off.device)
    counts = (off[..., None] == bins).to(torch.int32).sum(dim=-3)
    votes, _ = counts.max(dim=-1)
    moff = counts.argmax(dim=-1).to(torch.int32)
    tok = torch.arange(L, dtype=torch.int32, device=leader.device)
    tok = tok.expand(*lead, L)
    mglob = torch.clamp((tok // w) * w + moff, max=L - 1)
    similar = (votes >= f_threshold) & (mglob != tok)
    fl = torch.where(similar, mglob, tok)
    for _ in range(jumps):
        fl = torch.gather(fl, -1, fl.long())
    return fl == tok, fl


class PlanBlock(NamedTuple):
    mask: torch.Tensor          # (1, KV, G, C, S) bool
    q_critical: torch.Tensor    # (1, KV, G, C) bool
    q_leader: torch.Tensor      # (1, KV, G, C) chunk-local rows
    kv_any: torch.Tensor        # (1, KV, G, S) bool
    ffn_critical: torch.Tensor  # (1, C) bool
    ffn_leader: torch.Tensor    # (1, C) chunk-local rows


def plan_block(qh, kh, *, k, row0, n_valid, n_cols, s_threshold, window,
               f_threshold):
    """The causal plan of rows ``row0 .. row0 + C`` against the ``S``
    columns of ``kh`` (``n_cols`` of them written)."""
    Dh, C, S = qh.shape[-1], qh.shape[-2], kh.shape[-2]
    pam = (torch.matmul(qh, kh.unsqueeze(2).transpose(-1, -2))
           * Dh ** -0.5).to(torch.bfloat16)
    qi = row0 + torch.arange(C, device=qh.device)
    kj = torch.arange(S, device=qh.device)
    cmask = (kj[None, :] < n_cols) & (kj[None, :] <= qi[:, None])
    pam32 = pam.masked_fill(~cmask, CAUSAL_FILL).float()
    rows_ok = torch.arange(C, device=qh.device) < n_valid
    mask = bisect_topk_mask(pam32, k) & cmask & rows_ok[:, None]
    spa = torch.where(mask, pam32, torch.zeros_like(pam32))
    crit, lead = local_similarity(spa, window, s_threshold, n_valid)
    B, KV, G = qh.shape[:3]
    fcrit, flead = mfi_ffn(lead.reshape(B, KV * G, C), window, f_threshold)
    return PlanBlock(mask, crit, lead, mask.any(dim=-2), fcrit, flead)


# -- static-capacity packing (core/sparse_exec.py) ---------------------------

def _take(x, idx):
    lead = torch.broadcast_shapes(x.shape[:-1], idx.shape[:-1])
    return torch.gather(x.expand(*lead, x.shape[-1]), -1,
                        idx.long().expand(*lead, idx.shape[-1]))


def _window_leader(crit, window):
    L = crit.shape[-1]
    ids = torch.arange(L, dtype=torch.int32, device=crit.device)
    cand = torch.where(crit, ids, torch.full_like(ids, L))
    pad = (-L) % window
    if pad:
        cand = F.pad(cand, (0, pad), value=L)
    wmin = cand.reshape(*cand.shape[:-1], -1, window).amin(-1)
    return wmin[..., (ids // window).long()]


def compact_rows(crit, capacity, leader, window):
    """Critical rows packed first (index order), cut to ``capacity``;
    returns ``(perm (..., C) packed source rows, src_slot (..., *extra, L)
    the packed slot each row reads)``: its leader's slot, or where that
    leader did not fit, its leader's window leader's, else the last
    slot."""
    L = crit.shape[-1]
    C = min(capacity, L)
    order = torch.argsort((~crit).to(torch.int8), dim=-1, stable=True)
    order_pos = torch.argsort(order, dim=-1, stable=True).to(torch.int32)
    extra = leader.dim() - crit.dim()
    op = order_pos.reshape(order_pos.shape[:-1] + (1,) * extra + (L,))
    op = op.expand(leader.shape[:-1] + (L,))
    wl = _window_leader(crit, window)
    wl = wl.reshape(wl.shape[:-1] + (1,) * extra + (L,)).expand(op.shape)
    wlt = _take(wl, leader)
    wls = torch.clamp(wlt, max=L - 1)
    overflow = _take(op, leader) >= C
    fb_ok = (wlt < L) & (_take(op, wls) < C)
    target = torch.where(overflow & fb_ok, wls, leader)
    return (order[..., :C].to(torch.int32),
            torch.clamp(_take(op, target), max=C - 1))


def masked_softmax(s, mask):
    s = s.masked_fill(~mask, NEG)
    e = torch.exp(s - s.amax(-1, keepdim=True)) * mask.to(s.dtype)
    return e / (e.sum(-1, keepdim=True) + 1e-9)
