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
2. Kernels: each of the five kernels against its plain PyTorch version on
   the card, at the serving paths' shapes and in the edge cases, with
   stated tolerances; timed with CUDA events (warmed up, median of
   repeats, inputs rotated through more than the 50 MB L2 so every launch
   reads its operands from device memory) beside its plain version, one
   PyTorch library call computing the same function, and its bound.
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

The last lines are the ``{"kernels": [...]}`` line, the card's
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
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


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_gathered_matmul(K, gen) -> dict:
    dev = "cuda"
    L, D = 64, 768
    cases = []
    for C in (16, 64):
        for F in (768, 3072):
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
                cases.append({"C": C, "F": F, "src_slot": slot is not None,
                              "max_abs_err": err, "tolerance": tol})
                if not err <= tol:
                    _fail(f"gathered_matmul C={C} F={F} "
                          f"src_slot={slot is not None}: max |err| {err} "
                          f"> {tol}")
    # timed at the FFN up-projection of a full 64-row bucket
    C, F = 64, 3072
    per_set = (L * D + D * F + C) * 4
    sets = []
    for _ in range(_n_sets(per_set)):
        x = torch.randn(L, D, device=dev, generator=gen)
        w = torch.randn(D, F, device=dev, generator=gen) * D ** -0.5
        perm = torch.randint(0, L, (C,), device=dev, generator=gen,
                             dtype=torch.int32)
        sets.append((x, w, perm))
    ms = _time_ms(K.gathered_matmul, sets)
    plain_ms = _time_ms(K.gathered_matmul_plain, sets)
    lib_ms = _time_ms(lambda x, w, p: x.index_select(0, p) @ w, sets)
    flop_s = 2.0 * C * D * F / FP32_FLOPS
    byte_s = (C * D + D * F + C * F) * 4 / HBM_BYTES_PER_S
    return {"name": "gathered_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/gathered_matmul.cu",
            "replaces": "src/repro/kernels/gathered_matmul.py:138",
            "shape": {"L": L, "C": C, "D": D, "F": F},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": "1e-6 * max(1, max|plain|)",
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library": "x.index_select(0, perm) @ w",
            "bound_ms": 1e3 * max(flop_s, byte_s),
            "bound_by": "operations" if flop_s >= byte_s else "bytes",
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
               dead_head=False, q_scale=1.0):
    """q (B, H, L, Dh), k/v (B, KV, L, Dh), kv_keep (B, H, L) with about
    ``keep_dead`` of the columns dead, q_pos: each head's rows packed
    critical-first (a random ~60% critical set) as the flash backend packs
    them."""
    dev = "cuda"
    H = KV * G
    q = torch.randn(B, H, L, Dh, device=dev, generator=gen) * q_scale
    k = torch.randn(B, KV, L, Dh, device=dev, generator=gen)
    v = torch.randn(B, KV, L, Dh, device=dev, generator=gen)
    keep = None
    if keep_dead is not None:
        keep = torch.rand(B, H, L, device=dev, generator=gen) >= keep_dead
        if dead_head:
            keep[0, H // 2] = False                  # an all-dead keep row
    q_pos = None
    if packed:
        crit = torch.rand(B, H, L, device=dev, generator=gen) < 0.6
        q_pos = torch.argsort((~crit).to(torch.int8), dim=-1,
                              stable=True).to(torch.int32)
    return q, k, v, keep, q_pos


def check_flash_attention(K, gen) -> dict:
    from repro_torch.kernels.flash_attention import live_mask

    B, KV, L, Dh = 1, 12, 384, 64
    path = dict(G=1, L=L, keep_dead=0.3, packed=True)
    cases = [("path", path, dict(causal=False)),
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
              dict(causal=False))]
    results = []
    for name, shape, kw in cases:
        G = shape.pop("G")
        Lc = shape.pop("L")
        q, k, v, keep, q_pos = _attn_case(gen, B, KV // G, G, Lc, Dh,
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
        results.append({"case": name, "max_abs_err": err, "tolerance": tol})
    # timed at the path shape: non-causal, ~30% dead columns, packed rows
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
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:156",
            "shape": {"B": B, "H": H, "L": L, "Dh": Dh, "causal": False,
                      "live_pairs": live, "all_pairs": B * H * L * L},
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "tolerance": "1e-6 * max(1, max|plain|)",
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library": "scaled_dot_product_attention, boolean mask from "
                       "q_pos / kv_keep (float32)",
            "bound_ms": 1e3 * max(byte_s, flop_s),
            "bound_by": "operations" if flop_s >= byte_s else "bytes",
            "bound_peak": "the card's float64 peak, 67 TFLOP/s through "
                          "the FP64 tensor cores (the kernel uses no DMMA: "
                          "its own design limit is the 34 TFLOP/s of the "
                          "CUDA cores' FP64 FMA, twice this bound)",
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


# ---------------------------------------------------------------------------
# phase 3: serve full-width BERT-Base on each path
# ---------------------------------------------------------------------------

def _requests(Request, vocab: int):
    rng = np.random.default_rng(SEED)
    reqs = []
    for i in range(8):
        if i % 2:
            # runs of 16 repeated tokens (serve_batch --prompt-repeat 16):
            # adjacent rows are locally similar, so the small buckets serve
            toks = np.repeat(rng.integers(0, vocab, size=384 // 16 + 1),
                             16)[:384]
        else:
            toks = rng.integers(0, vocab, size=384)
        reqs.append(Request(rid=i, prompt=toks.astype(np.int32),
                            max_new_tokens=16))
    return reqs


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
    for name in _build.SOURCES:
        info = [ln.strip() for ln in _build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}: " + " | ".join(info))

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [check_gathered_matmul(K, gen), check_gather_rows(K, gen),
            check_paged_decode(K, gen), check_flash_attention(K, gen),
            check_flash_decode(K, gen)]
    paths = serve(K)
    for row in rows:
        by_path = {p: n[row["name"]] for p, n in paths.items()
                   if n[row["name"]]}
        if not by_path:
            _fail(f"{row['name']} was launched on no serving path")
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
