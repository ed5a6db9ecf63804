#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Device: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, and the build of every CUDA kernel from ``src/
   repro_torch/csrc`` (all ``nvcc`` processes started together).
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, with stated tolerances; timed with CUDA
   events (warmed up, median of repeats, inputs rotated through more than
   the 50 MB L2 so every launch reads its operands from device memory).
3. Serve: full-width causal BERT-Base (12 x 768, vocab 30522, random
   weights from a seed) with SPLS and packed compute through the CUDA
   kernels; 8 requests of 384 tokens, 16 new tokens each.  Every kernel's
   launch count from this run must be > 0 and every request must finish.
   The same requests then run through the plain backends on the card;
   every request's first token must agree.

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


# ---------------------------------------------------------------------------
# phase 3: serve full-width causal BERT-Base
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


def serve(K) -> dict:
    from repro_torch.configs.bert_base_esact import CONFIG
    from repro_torch.models import init_params
    from repro_torch.serving import PagedServingEngine, Request, ServeConfig

    cfg = dataclasses.replace(
        CONFIG, causal=True, remat=False,
        spls=dataclasses.replace(CONFIG.spls, causal=True))
    params = init_params(cfg, seed=SEED)
    torch.cuda.synchronize()

    def run(compute, attn):
        scfg = ServeConfig(n_slots=4, page_size=16, prefill_chunk=64,
                           max_len=512, compute_backend=compute,
                           attn_backend=attn, vote_horizon=None,
                           spls_prune_vote=0.5)
        # warm-up on a throwaway engine (library handles, first launches),
        # so the timed run starts from a fresh engine on a warm process
        warm = PagedServingEngine(cfg, params, scfg)
        warm.submit(Request(rid=-1, prompt=np.arange(128, dtype=np.int32),
                            max_new_tokens=2))
        warm.run_until_drained()
        del warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = PagedServingEngine(cfg, params, scfg)
        reqs = _requests(Request, cfg.vocab_size)
        for r in reqs:
            eng.submit(r)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run_until_drained(max_ticks=5000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        return eng, reqs, wall, launches, torch.cuda.max_memory_allocated()

    eng, reqs, wall, launches, peak = run("packed_cuda", "cuda_paged_decode")
    if not all(r.done for r in reqs):
        _fail(f"requests not done: {[r.rid for r in reqs if not r.done]}")
    zero = [k for k, n in launches.items() if n == 0]
    if zero:
        _fail(f"kernels never launched on the main path: {zero}")
    st = eng.stats
    n_tok = sum(len(r.output) for r in reqs)
    chunks = st["prefill_chunks"]
    print(json.dumps({
        "serve": "bert-base-esact causal, SPLS, packed_cuda + "
                 "cuda_paged_decode", "requests": len(reqs),
        "prompt_tokens": 384, "new_tokens": n_tok, "wall_s": wall,
        "tok_per_s": n_tok / wall, "peak_pages": st["peak_pages"],
        "preemptions": st["preemptions"], "prefill_chunks": chunks,
        "flops_saved_pct": st["flops_saved_pct"],
        "capacity_q": st["capacity_q"], "capacity_ffn": st["capacity_ffn"],
        "peak_device_bytes": peak, "launches": launches,
        "gathered_matmul_per_chunk": launches["gathered_matmul"] / chunks,
        "gather_rows_per_chunk": launches["gather_rows"] / chunks,
        "paged_flash_decode_ticks": launches["paged_flash_decode"]
        / cfg.n_layers}, default=str))

    _, reqs_p, wall_p, _, _ = run("packed_torch", "torch_paged_decode")
    first_bad = [r.rid for r, p in zip(reqs, reqs_p)
                 if r.output[:1] != p.output[:1]]
    same = sum(a == b for r, p in zip(reqs, reqs_p)
               for a, b in zip(r.output, p.output))
    total = sum(len(r.output) for r in reqs)
    print(json.dumps({
        "plain_backends": "packed_torch + torch_paged_decode",
        "wall_s": wall_p, "first_token_mismatch": first_bad,
        "token_agreement": f"{same}/{total}",
        "note": "SPLS thresholds can turn a float32 last-bit difference "
                "into another plan, so tokens after the first may differ"}))
    if first_bad:
        _fail(f"first tokens differ from the plain backends for requests "
              f"{first_bad}")
    return launches


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
            check_paged_decode(K, gen)]
    launches = serve(K)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
