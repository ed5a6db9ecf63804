#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over,
and nothing falls back to the CPU):

1. Device: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, and the build of every CUDA kernel from ``src/
   repro_torch/csrc`` (all ``nvcc`` processes started together).
2. Kernels: each of the seven kernels against its plain PyTorch version on
   the card, at the paths' shapes and in the edge cases, with stated
   tolerances; timed with CUDA events (warmed up, median of repeats,
   inputs rotated through more than the 50 MB L2 so every launch reads its
   operands from device memory) beside its plain version, one PyTorch
   library call computing the same function, and its bound
   (``gathered_matmul`` at the FFN and the Q projection's widths,
   ``flash_attention`` at batch 1 and at path (d)'s batch 8); ptxas's
   registers and spills of every kernel function.
3. Serve: full-width BERT-Base (12 x 768, vocab 30522, random weights from
   a seed), 8 requests of 384 tokens, 16 new tokens each, on three paths:
   (a) the causal form through ``PagedServingEngine`` with SPLS chunked
   prefill and packed compute (``gathered_matmul``, ``gather_rows``,
   ``paged_flash_decode``); (b) the published non-causal encoder through
   ``PagedServingEngine``: whole-prompt SPLS prefill (``flash_attention``)
   and paged decode (``paged_flash_decode``); (c) the same encoder through
   the dense ``ServingEngine`` (``flash_attention``, ``flash_decode``).
   Each path's launch counts are set to 0 just before its run and read
   just after; every kernel the path runs must have launched, and every
   request must finish.  The same requests then run through the plain
   backends on the card (no kernel launches); every request's first token
   must agree.
4. Exact forward, path (d): ``repro_torch.models.forward`` of the same
   encoder on the 8 prompts as one batch, with the default ``plan_mode``
   (the exact SPLS plan in every layer, ``flash_attention``), against the
   same forward through the plain backend; then, layer by layer on the
   inputs that forward sees, the ``kernels.ops`` entry points on the exact
   plan's own data: ``predict_matmul`` (``hlog_qmatmul``) on the
   predictor's codes and ``window_distances`` (``local_similarity_dist``)
   on the SPA, held against the predictor product and ``windowed_l1``;
   the plans' sparsity and FLOPs reduction; a warmed kernel forward, timed,
   and one more under ``torch.profiler`` (the card's busy time, its idle
   share of that call's wall, and the heaviest kernels); and
   one block at 8192 tokens, where "auto" plans row block by row block (no
   kernel on that route).

The last lines are the ``{"kernels": [...]}`` line, the card's
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
FP64_FLOPS = 67e12            # H100 SXM float64 peak (FP64 tensor cores)
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor cores
# int32 multiply-add on the CUDA cores: 64 lanes per SM per clock, half the
# float32 rate (Hopper white paper)
INT32_OPS = 33.5e12
L2_ROTATE_BYTES = 80 << 20    # > the 50 MB L2
SEED = 0


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def _time_ms(fn, sets, reps: int = 7, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` calls, each call
    on the next input set (rotating through more than the L2)."""
    for i in range(3):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    times = []
    k = 0
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn(*sets[k % len(sets)])
            k += 1
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _n_sets(bytes_per_set: int) -> int:
    return max(2, min(512, math.ceil(L2_ROTATE_BYTES / max(1, bytes_per_set))))


def _ptxas(log: str) -> list:
    """Each kernel function's registers and spill bytes from ``nvcc
    -Xptxas -v`` output (the function named by its mangled name)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = {"function": m.group(1)}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = None
    return out


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _time_gathered_matmul(K, gen, L, C, D, F) -> dict:
    """Kernel, plain and library times of ``x[perm] @ w`` at one shape,
    its tiling and its bound."""
    from repro_torch.kernels.gathered_matmul import gmm_tiling

    dev = "cuda"
    sets = []
    for _ in range(_n_sets((L * D + D * F + C) * 4)):
        x = torch.randn(L, D, device=dev, generator=gen)
        w = torch.randn(D, F, device=dev, generator=gen) * D ** -0.5
        perm = torch.randint(0, L, (C,), device=dev, generator=gen,
                             dtype=torch.int32)
        sets.append((x, w, perm))
    ms = _time_ms(K.gathered_matmul, sets)
    plain_ms = _time_ms(K.gathered_matmul_plain, sets)
    lib_ms = _time_ms(lambda x, w, p: x.index_select(0, p) @ w, sets)
    flop_s = 2.0 * C * D * F / FP64_FLOPS
    byte_s = (C * D + D * F + C * F) * 4 / HBM_BYTES_PER_S
    bm, splits = gmm_tiling(C, F, D)
    return {"shape": {"L": L, "C": C, "D": D, "F": F},
            "tiling": {"bm": bm, "bn": 64, "splits": splits},
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": 1e3 * max(flop_s, byte_s),
            "bound_by": "operations" if flop_s >= byte_s else "bytes"}


def check_gathered_matmul(K, gen) -> dict:
    dev = "cuda"
    L = 64
    cases = []
    # the path's buckets and widths, then ragged D / F (a D that is no
    # multiple of the K-slice; a D and F that are no multiple of 4)
    shapes = [(C, 768, F) for C in (16, 64) for F in (768, 3072)]
    shapes += [(40, 200, 100), (8, 77, 37)]
    for C, D, F in shapes:
        x = torch.randn(L, D, device=dev, generator=gen)
        w = torch.randn(D, F, device=dev, generator=gen) * D ** -0.5
        perm = torch.randint(0, L, (C,), device=dev, generator=gen,
                             dtype=torch.int32)
        perm[C // 2:] = perm[:C - C // 2]          # repeated entries
        src = torch.randint(0, C, (L,), device=dev, generator=gen,
                            dtype=torch.int32)
        for slot in (None, src):
            got = K.gathered_matmul(x, w, perm, slot)
            ref = K.gathered_matmul_plain(x, w, perm, slot)
            err = _max_err(got, ref)
            tol = 1e-6 * max(1.0, float(ref.abs().max()))
            cases.append({"C": C, "D": D, "F": F,
                          "src_slot": slot is not None,
                          "max_abs_err": err, "tolerance": tol})
            if not err <= tol:
                _fail(f"gathered_matmul C={C} D={D} F={F} "
                      f"src_slot={slot is not None}: max |err| {err} "
                      f"> {tol}")
    # timed at the FFN up-projection and the Q projection of a full
    # 64-row bucket
    row = _time_gathered_matmul(K, gen, L, 64, 768, 3072)
    q_shape = _time_gathered_matmul(K, gen, L, 64, 768, 768)
    return {"name": "gathered_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/gathered_matmul.cu",
            "replaces": "src/repro/kernels/gathered_matmul.py:138",
            "shape": row["shape"], "tiling": row["tiling"],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": "1e-6 * max(1, max|plain|)",
            "ms": row["ms"], "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
            "library": "x.index_select(0, perm) @ w",
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_peak": "the card's float64 peak, 67 TFLOP/s through the "
                          "FP64 tensor cores, which the kernel's DMMA "
                          "products use",
            "at_q_shape": q_shape,
            "cases": cases}


def check_gather_rows(K, gen) -> dict:
    dev = "cuda"
    C, F, M = 48, 768, 64
    src = torch.randn(C, F, device=dev, generator=gen)
    idx = torch.randint(0, C, (M,), device=dev, generator=gen,
                        dtype=torch.int32)
    err = _max_err(K.gather_rows(src, idx), K.gather_rows_plain(src, idx))
    if err != 0.0:
        _fail(f"gather_rows: max |err| {err} != 0 (a copy is exact)")
    sets = []
    for _ in range(_n_sets((C * F + M) * 4 + M * F * 4)):
        sets.append((torch.randn(C, F, device=dev, generator=gen),
                     torch.randint(0, C, (M,), device=dev, generator=gen,
                                   dtype=torch.int32)))
    ms = _time_ms(K.gather_rows, sets)
    plain_ms = _time_ms(K.gather_rows_plain, sets)
    lib_ms = _time_ms(lambda s, i: s.index_select(0, i), sets)
    return {"name": "gather_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/gather_rows.cu",
            "replaces": "src/repro/kernels/gathered_matmul.py:198",
            "shape": {"C": C, "F": F, "M": M},
            "max_abs_err": err, "tolerance": 0.0,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library": "src.index_select(0, idx)",
            "bound_ms": 1e3 * 2 * M * F * 4 / HBM_BYTES_PER_S,
            "bound_by": "bytes"}


def _decode_inputs(gen, B, KV, G, Dh, N, ps, P, kv_lens, compact: bool):
    """Random pool + block tables for rows with the given kv_len; with
    ``compact`` the pos ids skip (an SPLS-compacted layout: id != slot)."""
    dev = "cuda"
    q = torch.randn(B, KV, G, Dh, device=dev, generator=gen)
    kp = torch.randn(KV, N, ps, Dh, device=dev, generator=gen)
    vp = torch.randn(KV, N, ps, Dh, device=dev, generator=gen)
    # null page 0 holds garbage that must never be read live
    kp[:, 0] = 1e4
    vp[:, 0] = 1e4
    pos_pages = torch.full((N, ps), 1 << 30, dtype=torch.int32)
    tables = torch.zeros(B, P, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    order = torch.randperm(N - 1, generator=torch.Generator().manual_seed(
        int(torch.randint(0, 1 << 30, (1,), generator=gen, device=dev)))) + 1
    nxt = 0
    for b, n in enumerate(kv_lens):
        n_pages = -(-n // ps)
        pages = order[nxt:nxt + n_pages]
        nxt += n_pages
        tables[b, :n_pages] = pages.to(torch.int32)
        ids = (torch.arange(n) * (3 if compact else 1)).to(torch.int32)
        for s in range(n):
            pos_pages[pages[s // ps], s % ps] = ids[s]
        pos[b] = int(ids[-1]) + 1 if n else 0
    kv_len = torch.tensor(kv_lens, dtype=torch.int32)
    return (q, kp, vp, pos_pages.to(dev), tables.to(dev), kv_len.to(dev),
            pos.to(dev))


def check_paged_decode(K, gen) -> dict:
    B, KV, Dh, N, ps, P = 4, 12, 64, 129, 16, 32
    path_lens = [200, 180, 260, 150]
    cases = [("path", dict(G=1, lens=path_lens, compact=True)),
             ("compact_window", dict(G=1, lens=path_lens, compact=True,
                                     window=64)),
             ("softcap", dict(G=1, lens=path_lens, compact=False,
                              softcap=30.0)),
             ("kv_len_0", dict(G=1, lens=[0, 37, 512, 16], compact=False)),
             ("gqa_g4", dict(G=4, lens=path_lens, compact=True, window=100,
                             softcap=50.0))]
    results = []
    for name, c in cases:
        inp = _decode_inputs(gen, B, KV, c["G"], Dh, N, ps, P, c["lens"],
                             c["compact"])
        kw = dict(softcap=c.get("softcap"), window=c.get("window"))
        got = K.paged_flash_decode(*inp, **kw)
        ref = K.paged_decode_plain(*inp, **kw)
        err = _max_err(got, ref)
        tol = 1e-5
        if not torch.isfinite(got).all() or not err <= tol:
            _fail(f"paged_flash_decode case {name}: max |err| {err} > {tol}")
        results.append({"case": name, "max_abs_err": err, "tolerance": tol})
    # timed at the path shape: 4 rows, 12 heads, G = 1, compacted pages
    per_set = 2 * KV * N * ps * Dh * 4
    sets = [_decode_inputs(gen, B, KV, 1, Dh, N, ps, P, path_lens, True)
            for _ in range(_n_sets(per_set))]
    ms = _time_ms(K.paged_flash_decode, sets)
    plain_ms = _time_ms(K.paged_decode_plain, sets)

    def sdpa(q, kp, vp, pos_pages, tables, kv_len, pos):
        t = tables.long()
        Bq, KVq, Gq, Dq = q.shape
        S = t.shape[1] * kp.shape[2]
        kg = kp[:, t].movedim(1, 0).reshape(Bq, KVq, S, Dq)
        vg = vp[:, t].movedim(1, 0).reshape(Bq, KVq, S, Dq)
        m = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
        return torch.nn.functional.scaled_dot_product_attention(
            q, kg, vg, attn_mask=m[:, None, None, :])

    lib_ms = _time_ms(sdpa, sets)
    live = sum(path_lens)
    byte_s = (2 * live * KV * Dh * 4 + 2 * B * KV * Dh * 4) / HBM_BYTES_PER_S
    flop_s = 4.0 * B * KV * live * Dh / FP32_FLOPS
    return {"name": "paged_flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_decode.py:99",
            "shape": {"B": B, "KV": KV, "G": 1, "Dh": Dh, "N": N, "ps": ps,
                      "P": P, "kv_len": path_lens},
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "tolerance": 1e-5,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library": "block-table gather + scaled_dot_product_attention",
            "bound_ms": 1e3 * max(byte_s, flop_s),
            "bound_by": "bytes" if byte_s >= flop_s else "operations",
            "cases": results}


def _attn_case(gen, B, KV, G, L, Dh, keep_dead=None, packed=False,
               dead_head=False, q_scale=1.0, Lk=None):
    """q (B, H, L, Dh), k/v (B, KV, L, Dh), kv_keep (B, H, L) with about
    ``keep_dead`` of the columns dead, q_pos: each head's rows packed
    critical-first (a random ~60% critical set) as the flash backend packs
    them."""
    dev = "cuda"
    H = KV * G
    Lk = L if Lk is None else Lk
    q = torch.randn(B, H, L, Dh, device=dev, generator=gen) * q_scale
    k = torch.randn(B, KV, Lk, Dh, device=dev, generator=gen)
    v = torch.randn(B, KV, Lk, Dh, device=dev, generator=gen)
    keep = None
    if keep_dead is not None:
        keep = torch.rand(B, H, Lk, device=dev, generator=gen) >= keep_dead
        if dead_head:
            keep[0, H // 2] = False                  # an all-dead keep row
    q_pos = None
    if packed:
        crit = torch.rand(B, H, L, device=dev, generator=gen) < 0.6
        q_pos = torch.argsort((~crit).to(torch.int8), dim=-1,
                              stable=True).to(torch.int32)
    return q, k, v, keep, q_pos


def _time_flash_attention(K, gen, B, KV, L, Dh) -> dict:
    """Kernel, plain and library times of one non-causal call with ~30 %
    dead columns and packed rows at batch ``B``, and its bound."""
    from repro_torch.kernels.flash_attention import live_mask

    per_set = 4 * B * KV * L * Dh * 4
    sets, lib_sets = [], []
    live = None
    for _ in range(_n_sets(per_set)):
        q, k, v, keep, q_pos = _attn_case(gen, B, KV, 1, L, Dh,
                                          keep_dead=0.3, packed=True)
        sets.append((q, k, v, keep, q_pos))
        mask = live_mask(L, L, False, None, keep, q_pos, q.device)
        lib_sets.append((q, k, v, mask))
        if live is None:
            live = int(mask.sum())
    fa = lambda q, k, v, keep, qp: K.flash_attention(
        q, k, v, causal=False, kv_keep=keep, q_pos=qp)
    fp = lambda q, k, v, keep, qp: K.flash_attention_plain(
        q, k, v, causal=False, kv_keep=keep, q_pos=qp)
    ms = _time_ms(fa, sets)
    plain_ms = _time_ms(fp, sets)
    lib_ms = _time_ms(
        lambda q, k, v, m: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=m), lib_sets)
    H = KV
    byte_s = ((4 * B * H * L * Dh) * 4 + B * H * L * (1 + 4)) \
        / HBM_BYTES_PER_S
    flop_s = 4.0 * Dh * live / FP64_FLOPS
    return {"shape": {"B": B, "H": H, "L": L, "Dh": Dh, "causal": False,
                      "live_pairs": live, "all_pairs": B * H * L * L},
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": 1e3 * max(byte_s, flop_s),
            "bound_by": "operations" if flop_s >= byte_s else "bytes"}


def check_flash_attention(K, gen) -> dict:
    B, KV, L, Dh = 1, 12, 384, 64
    path = dict(G=1, L=L, keep_dead=0.3, packed=True)
    cases = [("path", path, dict(causal=False)),
             # path (d): the exact-plan forward's batch of 8 prompts
             ("path_d_B8", dict(B=8, G=1, L=L, keep_dead=0.3, packed=True),
              dict(causal=False)),
             ("causal", dict(G=1, L=L), dict(causal=True)),
             ("causal_window_64", dict(G=1, L=L, keep_dead=0.3,
                                       packed=True),
              dict(causal=True, window=64)),
             ("softcap_50", dict(G=1, L=L, keep_dead=0.3, q_scale=8.0),
              dict(causal=False, softcap=50.0)),
             ("gqa_g4", dict(G=4, L=L, keep_dead=0.3, packed=True),
              dict(causal=True)),
             ("ragged_L200", dict(G=1, L=200, keep_dead=0.3, packed=True),
              dict(causal=False, window=48)),
             ("all_dead_keep_row", dict(G=1, L=L, keep_dead=0.3,
                                        dead_head=True),
              dict(causal=False)),
             # around the 32-row q tile and the 64-column K tile; Dh 128
             ("ragged_Lq33_Lk97", dict(G=1, L=33, Lk=97, keep_dead=0.3),
              dict(causal=False)),
             ("dh_128", dict(G=1, L=L, keep_dead=0.3, packed=True,
                             Dh=128), dict(causal=False))]
    results = []
    for name, shape, kw in cases:
        Bc = shape.pop("B", B)
        G = shape.pop("G")
        Lc = shape.pop("L")
        Dc = shape.pop("Dh", Dh)
        q, k, v, keep, q_pos = _attn_case(gen, Bc, KV // G, G, Lc, Dc,
                                          **shape)
        got = K.flash_attention(q, k, v, kv_keep=keep, q_pos=q_pos, **kw)
        ref = K.flash_attention_plain(q, k, v, kv_keep=keep, q_pos=q_pos,
                                      **kw)
        err = _max_err(got, ref)
        tol = 1e-6 * max(1.0, float(ref.abs().max()))
        if not torch.isfinite(got).all() or not err <= tol:
            _fail(f"flash_attention case {name}: max |err| {err} > {tol}")
        if name == "all_dead_keep_row" and got[0, KV // 2].abs().max() != 0:
            _fail("flash_attention: an all-dead keep row must give zeros")
        results.append({"case": name, "B": Bc, "Dh": Dc, "max_abs_err": err,
                        "tolerance": tol})
    # timed at the shape of paths (b) and (c), B 1, and of path (d), B 8
    row = _time_flash_attention(K, gen, B, KV, L, Dh)
    path_d = _time_flash_attention(K, gen, 8, KV, L, Dh)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:156",
            "shape": row["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "tolerance": "1e-6 * max(1, max|plain|)",
            "ms": row["ms"], "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
            "library": "scaled_dot_product_attention, boolean mask from "
                       "q_pos / kv_keep (float32)",
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_peak": "the card's float64 peak, 67 TFLOP/s through "
                          "the FP64 tensor cores, which the kernel's DMMA "
                          "products use (its float64 exp of every live pair "
                          "runs on the CUDA cores beside them)",
            "at_path_d_shape": path_d,
            "cases": results}


def check_flash_decode(K, gen) -> dict:
    dev = "cuda"
    B, KV, S, Dh = 4, 12, 512, 64

    def inputs(G, pos, q_scale=1.0, S=S):
        kv = KV // G
        q = torch.randn(B, kv, G, Dh, device=dev, generator=gen) * q_scale
        k = torch.randn(B, kv, S, Dh, device=dev, generator=gen)
        v = torch.randn(B, kv, S, Dh, device=dev, generator=gen)
        return q, k, v, torch.tensor(pos, dtype=torch.int32, device=dev)

    def path_pos():
        return torch.randint(384, 401, (B,), generator=torch.Generator()
                             .manual_seed(int(torch.randint(
                                 0, 1 << 30, (1,), device=dev,
                                 generator=gen)))).tolist()

    cases = [("path", dict(G=1, pos=path_pos()), {}),
             ("window_64", dict(G=1, pos=path_pos()), dict(window=64)),
             ("softcap_30", dict(G=1, pos=path_pos(), q_scale=8.0),
              dict(softcap=30.0)),
             ("gqa_g4", dict(G=4, pos=path_pos()), dict(window=100)),
             ("pos_0", dict(G=1, pos=[0, 511, 5, 64]), {}),
             # a cache that is no multiple of the kernel's K tile
             ("ragged_S_300", dict(G=1, pos=[299, 150, 0, 257], S=300),
              dict(window=100))]
    results = []
    for name, c, kw in cases:
        inp = inputs(**c)
        got = K.flash_decode(*inp, **kw)
        ref = K.flash_decode_plain(*inp, **kw)
        err = _max_err(got, ref)
        tol = 1e-5
        if not torch.isfinite(got).all() or not err <= tol:
            _fail(f"flash_decode case {name}: max |err| {err} > {tol}")
        results.append({"case": name, "max_abs_err": err, "tolerance": tol})
    pos = path_pos()
    per_set = 2 * B * KV * S * Dh * 4
    sets, lib_sets = [], []
    for _ in range(_n_sets(per_set)):
        q, k, v, p = inputs(1, pos)
        sets.append((q, k, v, p))
        m = torch.arange(S, device=dev)[None, :] <= p[:, None].long()
        lib_sets.append((q, k, v, m[:, None, None, :]))
    ms = _time_ms(K.flash_decode, sets)
    plain_ms = _time_ms(K.flash_decode_plain, sets)
    lib_ms = _time_ms(
        lambda q, k, v, m: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=m), lib_sets)
    live = sum(x + 1 for x in pos)
    byte_s = (2 * live * KV * Dh * 4 + 2 * B * KV * Dh * 4 + B * 4) \
        / HBM_BYTES_PER_S
    flop_s = 4.0 * KV * live * Dh / FP32_FLOPS
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:82",
            "shape": {"B": B, "KV": KV, "G": 1, "S": S, "Dh": Dh,
                      "pos": pos},
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "tolerance": 1e-5,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library": "scaled_dot_product_attention, boolean mask j <= "
                       "pos",
            "bound_ms": 1e3 * max(byte_s, flop_s),
            "bound_by": "bytes" if byte_s >= flop_s else "operations",
            "cases": results}


def _codes(shape, gen) -> torch.Tensor:
    """``symmetric_quantize`` codes of Gaussian values: integer-valued
    float32 in [-127, 127], as the predictor feeds ``hlog_qmatmul``."""
    from repro_torch.core.quantizers import symmetric_quantize
    return symmetric_quantize(torch.randn(*shape, device="cuda",
                                          generator=gen))[0]


def check_hlog_qmatmul(K, gen) -> dict:
    from repro_torch.core.quantizers import hlog_project

    dev = "cuda"
    # the predictor product of path (d): 8 prompts x 384 rows, 768 x 768
    M, Kd, N = 3072, 768, 768
    cases = []
    for name, (m, k, n) in (("path", (M, Kd, N)), ("ragged", (200, 768, 300)),
                            ("K_4096", (256, 4096, 256))):
        xq, wq = _codes((m, k), gen), _codes((k, n), gen)
        err = _max_err(K.hlog_qmatmul(xq, wq), K.hlog_qmatmul_plain(xq, wq))
        if err != 0.0:
            _fail(f"hlog_qmatmul case {name}: max |err| {err} != 0 (both "
                  f"round one exact integer sum)")
        cases.append({"case": name, "M": m, "K": k, "N": n,
                      "max_abs_err": err, "tolerance": 0.0})
    v = torch.arange(-127, 128, dtype=torch.float32, device=dev)[:, None]
    one = torch.ones(1, 1, device=dev)
    err = max(_max_err(K.hlog_qmatmul(v, one), hlog_project(v)),
              _max_err(K.hlog_qmatmul_plain(v, one), hlog_project(v)))
    if err != 0.0:
        _fail(f"hlog_qmatmul: the 255 int8 values project differently from "
              f"hlog_project (max |err| {err})")
    cases.append({"case": "int8_sweep", "max_abs_err": err,
                  "tolerance": 0.0})
    sets = [(_codes((M, Kd), gen), _codes((Kd, N), gen))
            for _ in range(_n_sets((M * Kd + Kd * N) * 4))]
    ms = _time_ms(K.hlog_qmatmul, sets)
    plain_ms = _time_ms(K.hlog_qmatmul_plain, sets)
    lib_ms = _time_ms(torch.matmul, [(hlog_project(x), hlog_project(w))
                                     for x, w in sets])
    ops = 2.0 * M * Kd * N
    peak = BF16_FLOPS if Kd <= 1024 else FP32_FLOPS
    flop_s = ops / peak
    byte_s = (M * Kd + Kd * N + M * N) * 4 / HBM_BYTES_PER_S
    # the simple kernel's own limit, worked out, not measured: apart from
    # the kernels line, which holds measured times and the bound
    print(json.dumps({"design_limit": {
        "kernel": "hlog_qmatmul", "shape": {"M": M, "K": Kd, "N": N},
        "ms": 1e3 * ops / INT32_OPS,
        "by": "int32 IMAD on the CUDA cores, 33.5 TOP/s"}}))
    return {"name": "hlog_qmatmul", "route": "cuda",
            "source": "src/repro_torch/csrc/hlog_qmatmul.cu",
            "replaces": "src/repro/kernels/hlog_qmatmul.py:57",
            "shape": {"M": M, "K": Kd, "N": N},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": 0.0,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library": "torch.matmul of the projected operands (float32, "
                       "TF32 off): a floor for a library route, which "
                       "would also have to project",
            "bound_ms": 1e3 * max(flop_s, byte_s),
            "bound_by": "operations" if flop_s >= byte_s else "bytes",
            "bound_peak": ("989 TFLOP/s dense bf16: HLog levels are exact "
                           "in bf16 and every partial sum is exact in the "
                           "tensor cores' float32 accumulators for K <= "
                           "1024") if Kd <= 1024 else
                          "67 TFLOP/s float32 (K > 1024)",
            "cases": cases}


def _spa_like(shape, gen, k_ratio=0.12) -> torch.Tensor:
    """Gaussian values with exactly ceil(k_ratio * Lk) non-zero entries per
    row at random columns, as a top-k SPA has."""
    k = math.ceil(k_ratio * shape[-1])
    vals = torch.randn(*shape, device="cuda", generator=gen)
    idx = torch.rand(*shape, device="cuda", generator=gen).topk(k).indices
    keep = torch.zeros(shape, dtype=torch.bool, device="cuda")
    return vals * keep.scatter_(-1, idx, True)


def check_local_similarity(K, gen) -> dict:
    B, H, L, Lk, w = 8, 12, 384, 384, 8          # path (d)'s SPA
    cases = []
    for name, shape, cw in (("path", (B, H, L, Lk), w),
                            ("ragged_Lk_300", (2, H, L, 300), w),
                            ("w_4", (2, H, L, Lk), 4),
                            ("all_zero_window", (1, H, L, Lk), w)):
        spa = _spa_like(shape, gen)
        if name == "all_zero_window":
            spa[0, 3, 8 * cw:9 * cw] = 0.0
        got = K.local_similarity_dist(spa, cw)
        ref = K.local_similarity_plain(spa, cw)
        err = _max_err(got, ref)
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        if not torch.isfinite(got).all() or not err <= tol:
            _fail(f"local_similarity_dist case {name}: max |err| {err} > "
                  f"{tol}")
        if not torch.equal(got, got.transpose(-1, -2)):
            _fail(f"local_similarity_dist case {name}: not symmetric")
        if name == "all_zero_window" and got[0, 3, 8].abs().max() != 0:
            _fail("local_similarity_dist: an all-zero window must give 0")
        cases.append({"case": name, "shape": list(shape), "w": cw,
                      "max_abs_err": err, "tolerance": tol})
    in_bytes = B * H * L * Lk * 4
    sets = [(_spa_like((B, H, L, Lk), gen),)
            for _ in range(_n_sets(in_bytes))]
    ms = _time_ms(lambda x: K.local_similarity_dist(x, w), sets)
    plain_ms = _time_ms(lambda x: K.local_similarity_plain(x, w), sets)
    nwin = B * H * L // w
    lib_ms = _time_ms(lambda x: torch.cdist(x, x, p=1),
                      [(x.view(nwin, w, Lk),) for (x,) in sets])
    byte_s = (in_bytes + nwin * w * w * 4) / HBM_BYTES_PER_S
    flop_s = 3.0 * w * w * Lk * nwin / FP32_FLOPS
    return {"name": "local_similarity_dist", "route": "cuda",
            "source": "src/repro_torch/csrc/local_similarity.cu",
            "replaces": "src/repro/kernels/local_similarity.py:36",
            "shape": {"B": B, "H": H, "L": L, "Lk": Lk, "w": w,
                      "nonzero_per_row": math.ceil(0.12 * Lk)},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": "1e-5 * max(1, max|plain|)",
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library": "torch.cdist(x, x, p=1) on the (B*H*L/w, w, Lk) view",
            "bound_ms": 1e3 * max(flop_s, byte_s),
            "bound_by": "operations" if flop_s >= byte_s else "bytes",
            "cases": cases}


# ---------------------------------------------------------------------------
# phase 3: serve full-width BERT-Base on each path
# ---------------------------------------------------------------------------

def _prompts(vocab: int) -> list:
    """The 8 prompts of 384 tokens every path serves."""
    rng = np.random.default_rng(SEED)
    prompts = []
    for i in range(8):
        if i % 2:
            # runs of 16 repeated tokens (serve_batch --prompt-repeat 16):
            # adjacent rows are locally similar, so the small buckets serve
            toks = np.repeat(rng.integers(0, vocab, size=384 // 16 + 1),
                             16)[:384]
        else:
            toks = rng.integers(0, vocab, size=384)
        prompts.append(toks.astype(np.int32))
    return prompts


def _requests(Request, vocab: int):
    return [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(_prompts(vocab))]


def _serve_run(K, Engine, cfg, params, scfg):
    """A warm-up engine (library handles, first launches), then a fresh
    engine on the warm process serves the 8 requests; the launch counts
    are set to 0 just before the run and read just after it."""
    from repro_torch.serving import Request

    warm = Engine(cfg, params, scfg)
    warm.submit(Request(rid=-1, prompt=np.arange(128, dtype=np.int32),
                        max_new_tokens=2))
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, scfg)
    reqs = _requests(Request, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run_until_drained(max_ticks=5000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    if not all(r.done for r in reqs):
        _fail(f"requests not done: {[r.rid for r in reqs if not r.done]}")
    return eng, reqs, wall, launches, torch.cuda.max_memory_allocated()


def serve_path(K, path: str, Engine, params, cfg, scfg, plain_cfg,
               plain_scfg, must_launch, extra=None) -> dict:
    """Serve the requests through the kernels, check that every kernel of
    this path was launched, then serve them again through the plain
    backends on the card (which launch no kernel): every request's first
    token must agree.  Returns this path's launch counts."""
    eng, reqs, wall, launches, peak = _serve_run(K, Engine, cfg, params,
                                                 scfg)
    zero = [k for k in must_launch if launches[k] == 0]
    if zero:
        _fail(f"kernels never launched on the {path} path: {zero}")
    st = eng.stats
    n_tok = sum(len(r.output) for r in reqs)
    report = {"serve": path, "requests": len(reqs), "prompt_tokens": 384,
              "new_tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
              "peak_pages": st.get("peak_pages"),
              "preemptions": st.get("preemptions"),
              "flops_saved_pct": st["flops_saved_pct"],
              "peak_device_bytes": peak, "launches": launches}
    report.update(extra(eng, launches) if extra else {})
    print(json.dumps(report, default=str))

    _, reqs_p, wall_p, launches_p, _ = _serve_run(K, Engine, plain_cfg,
                                                  params, plain_scfg)
    if any(launches_p.values()):
        _fail(f"the plain backends of the {path} path launched kernels: "
              f"{launches_p}")
    first_bad = [r.rid for r, p in zip(reqs, reqs_p)
                 if r.output[:1] != p.output[:1]]
    same = sum(a == b for r, p in zip(reqs, reqs_p)
               for a, b in zip(r.output, p.output))
    print(json.dumps({
        "serve": path,
        "plain_backends": [plain_cfg.attn_backend, plain_scfg.attn_backend],
        "plain_compute": plain_scfg.compute_backend, "wall_s": wall_p,
        "first_token_mismatch": first_bad,
        "token_agreement": f"{same}/{n_tok}",
        "note": "SPLS thresholds can turn a float32 last-bit difference "
                "into another plan, so tokens after the first may differ"},
        default=str))
    if first_bad:
        _fail(f"{path}: first tokens differ from the plain backends for "
              f"requests {first_bad}")
    return launches


def serve(K) -> dict:
    """Each serving path at full width (BERT-Base: 12 x 768, vocab 30522,
    random weights from a seed): ``{path: its launch counts}``."""
    from repro_torch.configs.bert_base_esact import CONFIG
    from repro_torch.models import init_params
    from repro_torch.serving import (PagedServingEngine, ServeConfig,
                                     ServingEngine)

    paths = {}
    base = dict(n_slots=4, page_size=16, prefill_chunk=64, max_len=512,
                vote_horizon=None, spls_prune_vote=0.5)

    # 1. causal form, SPLS chunked prefill with packed compute
    causal = dataclasses.replace(
        CONFIG, causal=True, remat=False,
        spls=dataclasses.replace(CONFIG.spls, causal=True))
    params = init_params(causal, seed=SEED)

    def chunk_stats(eng, launches):
        st = eng.stats
        chunks = st["prefill_chunks"]
        return {"prefill_chunks": chunks,
                "capacity_q": st["capacity_q"],
                "capacity_ffn": st["capacity_ffn"],
                "gathered_matmul_per_chunk":
                    launches["gathered_matmul"] / chunks,
                "gather_rows_per_chunk": launches["gather_rows"] / chunks,
                "paged_flash_decode_ticks":
                    launches["paged_flash_decode"] / causal.n_layers}

    paths["causal_paged_chunked"] = serve_path(
        K, "causal_paged_chunked: bert-base-esact causal, SPLS, "
           "packed_cuda + cuda_paged_decode", PagedServingEngine, params,
        causal,
        ServeConfig(compute_backend="packed_cuda",
                    attn_backend="cuda_paged_decode", **base),
        causal,
        ServeConfig(compute_backend="packed_torch",
                    attn_backend="torch_paged_decode", **base),
        ("gathered_matmul", "gather_rows", "paged_flash_decode"),
        chunk_stats)
    del params

    # 2. the published non-causal encoder: whole-prompt prefill.  The
    # ServeConfig names one site's backend, the model config the other's
    params = init_params(CONFIG, seed=SEED)
    on = lambda name: dataclasses.replace(CONFIG, attn_backend=name)
    per_layer = lambda name: (lambda eng, launches: {
        f"{name}_per_layer": launches[name] / CONFIG.n_layers})
    paths["noncausal_paged_full_prefill"] = serve_path(
        K, "noncausal_paged_full_prefill: bert-base-esact (non-causal), "
           "SPLS, cuda_flash + cuda_paged_decode (auto)",
        PagedServingEngine, params, CONFIG,
        ServeConfig(compute_backend="packed_cuda", attn_backend="cuda_flash",
                    **base),
        on("torch_flash"),
        ServeConfig(compute_backend="packed_torch",
                    attn_backend="torch_paged_decode", **base),
        ("flash_attention", "paged_flash_decode"),
        per_layer("flash_attention"))

    # 3. the same model through the dense fixed-slot engine
    dense = dict(n_slots=4, max_len=512)
    paths["noncausal_dense_engine"] = serve_path(
        K, "noncausal_dense_engine: bert-base-esact (non-causal), SPLS, "
           "cuda_flash + cuda_flash_decode", ServingEngine, params,
        on("cuda_flash"), ServeConfig(attn_backend="cuda_flash_decode",
                                      **dense),
        on("torch_flash"), ServeConfig(attn_backend="torch_flash_decode",
                                       **dense),
        ("flash_attention", "flash_decode"), per_layer("flash_decode"))
    return paths


# ---------------------------------------------------------------------------
# phase 4: the exact-plan forward, path (d)
# ---------------------------------------------------------------------------

def _forward_run(K, cfg, params, toks):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    from repro_torch.models import forward
    logits = forward(cfg, params, toks)
    torch.cuda.synchronize()
    return (logits, time.perf_counter() - t0, K.launch_counts(),
            torch.cuda.max_memory_allocated())


def _device_profile(fn, kernel: str) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and read the card's kernel
    intervals: busy time (their union), the span from the first kernel's
    start to the last one's end, the call's own wall time and the card's
    idle share of it, the device time of the heaviest kernels by name, and
    the share of busy time spent in kernels whose name contains ``kernel``.
    The profiler's own host overhead lengthens that wall, so its idle share
    is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    if not spans:
        _fail("the profiler saw no kernel on the card")
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    mine = sum(us for n, us in by_name.items() if kernel in n)
    return {"device_busy_ms": busy / 1e3,
            "profiled_span_ms": (spans[-1][1] - spans[0][0]) / 1e3,
            "profiled_wall_ms": wall * 1e3,
            "idle_share_of_profiled_wall": 1.0 - busy / 1e3 / (wall * 1e3),
            "kernels": len(spans), f"{kernel}_share_of_busy": mine / busy,
            "top_device_ms": {n[:60]: us / 1e3 for n, us in top}}


def _layer_checks(K, cfg, ctx, bp, xn) -> dict:
    """The ops entry points on one layer's own data: the predictor's codes
    (B6) and the exact plan's SPA (B7)."""
    from repro_torch.core import (quantize_dequantize, symmetric_quantize,
                                  windowed_l1)
    from repro_torch.kernels import ops

    D, w = cfg.d_model, cfg.spls.window
    x2 = xn.reshape(-1, D)
    qx, sx = symmetric_quantize(x2)
    out = {}
    for name, w2 in zip(("wq", "wk"), ctx._weights2d(bp["attn"])):
        qw, sw = symmetric_quantize(w2)
        prod = ops.predict_matmul(qx, qw)
        exact = _max_err(prod, K.hlog_qmatmul_plain(qx, qw))
        want = quantize_dequantize(x2) @ quantize_dequantize(w2)
        err = _max_err(prod * sx * sw, want)
        tol = 1e-5 * float(want.abs().max())
        if exact != 0.0 or not err <= tol:
            _fail(f"predict_matmul on {name}: {exact} vs the plain version "
                  f"(must be 0), {err} vs the predictor product (> {tol})")
        out[f"hlog_{name}_err"] = err
    spa, _ = ctx.exact_spa(bp["attn"], xn)
    B, L = xn.shape[0], xn.shape[1]
    spa4 = spa.reshape(B, -1, L, L)
    d = ops.window_distances(spa4, w)
    norm = spa4.abs().sum(-1).reshape(*d.shape[:-1])
    dn = d / (norm[..., :, None] + norm[..., None, :] + 1e-6)
    err_n = _max_err(dn, windowed_l1(spa4, w))
    plain = K.local_similarity_plain(spa4, w)
    err_d = _max_err(d, plain)
    tol_d = 1e-5 * max(1.0, float(plain.abs().max()))
    if not err_n <= 1e-5 or not err_d <= tol_d:
        _fail(f"window_distances on the exact SPA: normalized {err_n} vs "
              f"windowed_l1 (> 1e-5), raw {err_d} vs plain (> {tol_d})")
    out.update(windowed_l1_err=err_n, lsd_err=err_d)
    return out


def exact_forward(K) -> dict:
    """Path (d): ``forward`` of the published encoder with the default
    ``plan_mode`` at full width, kernel and plain; the B6 / B7 entry points
    on every layer's own data; one block at 8192 tokens.  Returns the
    path's launch counts."""
    from repro_torch.configs.bert_base_esact import CONFIG as cfg
    from repro_torch.core import (PlanContext, build_block_plan_chunked,
                                  plan_stats, reduction_report)
    from repro_torch.models import (block_forward, embed_inputs, head_logits,
                                    init_params, rms_norm)
    from repro_torch.models.common import dtype_of
    from repro_torch.models.model import period_params

    params = init_params(cfg, seed=SEED)
    toks = torch.from_numpy(np.stack(_prompts(cfg.vocab_size))).cuda()
    B, L = toks.shape
    logits, wall, launches, peak = _forward_run(K, cfg, params, toks)
    if launches["flash_attention"] != cfg.n_layers or \
            sum(launches.values()) != cfg.n_layers:
        _fail(f"exact forward: expected {cfg.n_layers} flash_attention "
              f"launches and no other, got {launches}")
    plain_cfg = dataclasses.replace(cfg, attn_backend="torch_flash")
    logits_p, wall_p, launches_p, peak_p = _forward_run(K, plain_cfg,
                                                        params, toks)
    if any(launches_p.values()):
        _fail(f"the plain exact forward launched kernels: {launches_p}")
    err = _max_err(logits, logits_p)
    tol = 1e-6 * max(1.0, float(logits_p.abs().max()))
    same_argmax = int((logits.argmax(-1) == logits_p.argmax(-1)).sum())
    if not torch.isfinite(logits).all() or not err <= tol \
            or same_argmax != B * L:
        _fail(f"exact forward vs plain: max |err| {err} (tol {tol}), argmax "
              f"equal at {same_argmax}/{B * L}")

    # warmed: the kernel forward once more, timed, then once profiled
    _, wall_warm, _, _ = _forward_run(K, cfg, params, toks)
    from repro_torch.models import forward
    prof = _device_profile(lambda: forward(cfg, params, toks),
                           "flash_attention_kernel")
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / 1e3 / wall_warm

    # layer by layer on the inputs the forward sees
    ctx = PlanContext.for_config(cfg)
    dtype = dtype_of(cfg.compute_dtype)
    x = embed_inputs(cfg, params, toks)
    layers = []
    K.reset_launch_counts()
    for pi in range(cfg.n_periods):
        for blk, bp in zip(cfg.period, period_params(params, pi, dtype)):
            xn = rms_norm(x, bp["ln1"], cfg.norm_eps)
            row = _layer_checks(K, cfg, ctx, bp, xn)
            plan = ctx.plan_exact(bp["attn"], xn)
            row.update(plan_stats(plan))
            row.update(reduction_report(plan, cfg.d_model, cfg.d_ff,
                                        causal=cfg.causal))
            layers.append(row)
            x = block_forward(cfg, blk, bp, x)
    torch.cuda.synchronize()
    ops_launches = K.launch_counts()
    if ops_launches["hlog_qmatmul"] != 2 * cfg.n_layers or \
            ops_launches["local_similarity_dist"] != cfg.n_layers:
        _fail(f"the ops entry points launched {ops_launches}, expected "
              f"{2 * cfg.n_layers} hlog_qmatmul and {cfg.n_layers} "
              f"local_similarity_dist")
    loop_err = _max_err(head_logits(cfg, params, x), logits)
    if not loop_err <= tol:
        _fail(f"the layer loop's logits differ from forward's: {loop_err}")
    keys = [k for k in layers[0] if not k.endswith("_err")]
    mean = {k: statistics.fmean(r[k] for r in layers) for k in keys}
    print(json.dumps({
        "path": "noncausal_exact_forward", "batch": B, "seq": L,
        "plan_mode": "auto (exact plan; L < 8192)",
        "wall_s": wall, "plain_wall_s": wall_p, "warm_wall_s": wall_warm,
        "peak_device_bytes": peak, "plain_peak_device_bytes": peak_p,
        "logits_max_abs_err": err, "logits_tolerance": tol,
        "argmax_equal": f"{same_argmax}/{B * L}",
        "layer_loop_logits_err": loop_err, "profile": prof,
        "profile_note": "the third kernel forward, under torch.profiler, "
                        "gives the device busy time; idle_share = 1 - that "
                        "busy time / warm_wall_s, the second kernel "
                        "forward, warmed and unprofiled, run just before; "
                        "idle_share_of_profiled_wall divides by the "
                        "profiled call's own wall, which the profiler's "
                        "host overhead lengthens (an upper bound)",
        "forward_launches": launches, "ops_launches": ops_launches,
        "plan_mean_over_layers": mean, "per_layer": layers,
        "note": "random weights and random tokens: these sparsities are "
                "not the paper's 52.03 % computation reduction"}))

    # one block at 8192 tokens: the row-block plan, no O(L^2) tensor
    L2 = 8192
    toks2 = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, L2)).astype(np.int32)).cuda()
    bp0 = period_params(params, 0, dtype)[0]
    x2 = embed_inputs(cfg, params, toks2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    y = block_forward(cfg, cfg.period[0], bp0, x2)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    peak2 = torch.cuda.max_memory_allocated() - base
    long_launches = K.launch_counts()
    if not torch.isfinite(y).all() or any(long_launches.values()):
        _fail(f"block at L={L2}: finite {bool(torch.isfinite(y).all())}, "
              f"launches {long_launches} (the row-block route has no "
              f"kernel)")
    xn2 = rms_norm(x2, bp0["ln1"], cfg.norm_eps)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plan = build_block_plan_chunked(cfg, bp0, xn2)
    torch.cuda.synchronize()
    plan_peak = torch.cuda.max_memory_allocated() - base
    kept = lambda m: float(m.double().mean())
    print(json.dumps({
        "path": "long_block_chunked_plan", "seq": L2, "layer": 0,
        "route": "plan_scan -> torch_chunked (no kernel)",
        "wall_s": wall2, "peak_device_bytes_above_inputs": peak2,
        "plan_only_peak_bytes_above_inputs": plan_peak,
        "one_float32_pam_bytes": cfg.n_heads * L2 * L2 * 4,
        "q_kept": kept(plan.q_critical), "kv_kept": kept(plan.kv_keep),
        "ffn_kept": kept(plan.ffn_critical),
        "checked": "finite outputs only: no reference at this length"}))
    return {"flash_attention": launches["flash_attention"],
            "hlog_qmatmul": ops_launches["hlog_qmatmul"],
            "local_similarity_dist": ops_launches["local_similarity_dist"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import kernels as K
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    resolve_device()                      # TF32 off, card present
    smi = _smi()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} | CUDA {torch.version.cuda}")
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s for {sorted(_build.SOURCES)}")
    ptxas = {name: _ptxas(_build.build_log(name)) for name in _build.SOURCES}
    for name, fns in ptxas.items():
        print(f"  {name}: " + " | ".join(
            f"{f['function']}: {f['registers']} registers, spill stores "
            f"{f['spill_stores']} B, loads {f['spill_loads']} B"
            for f in fns))

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [check_gathered_matmul(K, gen), check_gather_rows(K, gen),
            check_paged_decode(K, gen), check_flash_attention(K, gen),
            check_flash_decode(K, gen), check_hlog_qmatmul(K, gen),
            check_local_similarity(K, gen)]
    paths = serve(K)
    paths["noncausal_exact_forward"] = exact_forward(K)
    for row in rows:
        row["ptxas"] = ptxas[Path(row["source"]).stem]
    for row in rows:
        by_path = {p: n[row["name"]] for p, n in paths.items()
                   if n.get(row["name"])}
        if not by_path:
            _fail(f"{row['name']} was launched on no path")
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
