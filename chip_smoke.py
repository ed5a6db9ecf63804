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
   tolerances, launching once a call; timed beside its plain version, one
   PyTorch library call computing the same function, and its bound
   (``gathered_matmul`` at the FFN and the Q projection's widths,
   ``flash_attention`` at batch 1 and at path (d)'s batch 8).  ``ms`` is
   a call's time by CUDA events (warmed up, median of repeats, inputs
   rotated through more than the 50 MB L2 so every launch reads its
   operands from device memory), the host's share included; ``kernel_ms``
   (``library_kernel_ms``) is the device time per call that
   ``torch.profiler`` records for the kernel itself (for all of the
   library call's device work).  ptxas's registers and spills of every
   kernel function.  The decode kernels also run G 16, Dh 120 and bf16
   cases (bf16 within one bf16 ulp of the plain output, or 1e-5);
   ``flash_attention`` also the model families' GQA shapes (G 2, Dh 128;
   G 4, Dh 120 with a window; G 16).  Then the host
   path of a ``gather_rows`` and a ``paged_flash_decode`` call, phase by
   phase (``time.perf_counter_ns`` over 10^4 calls).  The SPLS planner's
   two kernels, which replace no TPU kernel (``spls_plan_block``,
   ``spls_mfi``), against ``spls_plan_block_plain`` and
   ``mfi_ffn_sparsity`` on the same card tensors at cell A's middle and
   last chunk (1 x 8 x 2 x 256 x 2176, w 8), votes only, and at path
   (ac)'s 8192-slot row block: mask, ``kv_any`` and the MFI outputs
   bit-equal, ``is_critical`` / ``leader`` equal but at near-ties (an
   earlier critical row at a float64 distance within 1e-6 x max(1, s) of
   s); both timed at A's middle chunk beside their plain versions and
   their byte bounds.
3. Serve: full-width BERT-Base (12 x 768, vocab 30522, random weights from
   a seed), 8 requests of 384 tokens, 16 new tokens each, on three paths:
   (a) the causal form through ``PagedServingEngine`` with SPLS chunked
   prefill and packed compute (``gathered_matmul``, ``gather_rows``,
   ``paged_flash_decode``); (b) the published non-causal encoder through
   ``PagedServingEngine``: whole-prompt SPLS prefill (``flash_attention``)
   and paged decode (``paged_flash_decode``); (c) the same encoder through
   the dense ``ServingEngine`` (``flash_attention``, ``flash_decode``);
   then the causal form again on three more paths of
   ``PagedServingEngine``: (f) without SPLS (the non-SPLS chunk step,
   ``paged_flash_decode``), the baseline SPLS pruning is measured
   against; (g) SPLS as in (a) on simulation-mode ``dense`` compute
   (``paged_flash_decode``); (h) ``vote_horizon=1`` with packed compute at
   the reference's CI telemetry knobs (k 0.05, s 0.9, prune vote 1.0,
   capacity margin 1.0): ``gathered_matmul`` also for the packed K/V
   projection (four launches a layer and chunk), ``gather_rows``,
   ``paged_flash_decode``, and the ``BENCH_serving.json`` report written,
   read back and validated with nonzero FLOPs saved in all four
   components (its latency percentiles printed).
   Each path's launch counts are set to 0 just before its run and read
   just after; every kernel the path runs must have launched, and every
   request must finish.  The same requests then run through the plain
   backends on the card (no backend kernel launches: the SPLS planner's
   kernels follow the tensors' device, so both sides plan alike, and
   phase 2 holds the planner to its plain version); every request's first
   token must agree.
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
   backend kernel on that route; the plan kernels once a row block).
5. bf16: the smoke form of the same model with ``compute_dtype=
   "bfloat16"`` on the three engine paths of phase 3, through the kernels
   and through the plain backends; every kernel of a path must launch, and
   the greedy-token mismatches are reported.
6. Model families at full width (``repro_torch.configs.registry``; random
   weights from the seed, drawn on the card), each through the kernels and
   through the plain backends: (i) qwen3-0.6b (28 x 1024, float32) with
   the paper's SPLS knobs through ``PagedServingEngine`` and packed compute
   (``gathered_matmul``, ``gather_rows``, ``paged_flash_decode``), the
   traffic of phase 3; (j) the same model without SPLS through
   ``ServingEngine`` (``flash_attention``, ``flash_decode``), whose tokens
   must equal a paged run's without SPLS; (k) olmoe-1b-7b (16 x 2048, 64
   experts top 8, float32), paged, the MoE FFN in the chunk step and the
   decode tick; (l) gemma2-27b at its width, one local (window 4096) and
   one global block, bf16, 2 prompts of 4352 tokens through both engines,
   and its logits kernels against plain (prefill, a dense decode step, a
   paged decode tick); (m) mamba2-370m (48 x 1024)
   through ``ServingEngine`` against a plain ``prefill`` + ``decode_step``
   loop (no kernel); (n) jamba-v0.1-52b, one period of 8 layers (Mamba,
   MoE, attention), bf16, through ``ServingEngine``, and its logits;
   (o) ``repro_torch.launch.serve`` on every architecture of the registry,
   dense and ``--paged --spls`` (the reference's skips kept), and once as
   ``python -m`` (its launches are reported, not counted as a path's).
   Float32 paths must give every token equal to the plain backends'; bf16
   paths report the mismatches and hold the logits to 1 bf16 ulp of max
   |plain| after prefill and 4 ulps after a decode step, with a control
   (the windows dropped) reported beside each tolerance.
7. Training (no kernel has a backward, so training runs the reference's
   differentiable routes and no kernel may launch while it trains): (p)
   qwen3-0.6b at full width and depth (float32 params, bf16 compute,
   remat, as published) through ``Trainer`` on the synthetic ``lm`` task,
   4096 tokens, ``n_micro`` 8, global batch 8 (cut from 256): every
   gradient leaf finite and nonzero, step 0's loss within 0.5 of ln V,
   4 steps with a checkpoint at step 2, and a fresh ``Trainer`` restored
   from it held against the uninterrupted run; step time, tokens/s, model
   FLOPs per step and per second, peak memory; then the trained weights
   through ``make_prefill_step`` / ``make_serve_step`` on B4 / B5 against
   the plain backends (2 prompts of 512 from the pipeline, 8 decode
   steps; 1 / 4 bf16 ulps, an oldest-keys-dropped control beside each);
   (q) ``make_loss_grad`` on the smoke forms of qwen3-0.6b and olmoe, with
   and without SPLS, card against CPU, remat on against off, and the
   kernel wrappers' refusal of a gradient; (r) ``repro_torch.launch.train``
   on every architecture of the registry, with ``--spls``, and once as
   ``python -m``.
8. Capacity-mode SPLS, sampling, the ESACT model, the examples: (s)
   qwen3-0.6b at full width and depth (as (p)) trained under the
   reference's SPLS training configuration (k 0.12, s 0.6, f 6, window 8,
   q capacity 0.5, kv capacity 0.75 of L) through ``Trainer``, 4096
   tokens, ``n_micro`` 8, 2 steps: every forward attention call on
   ``torch_packed``, step 1's gradient of every layer's wq / wk / wv / wo
   finite and nonzero, losses finite, no launch; step time, tokens/s,
   peak memory beside (p)'s; then the float32 smoke form at q 0.5 card
   against CPU under the CPU's plans; (t) the weights (s) trained,
   served in float32 by temperature sampling (T 0.8) through the paged
   engine with SPLS (B1 / B2 / B3) and the dense engine (B4 / B5), each
   against the plain backends (tokens equal but at printed near-ties),
   seed 0 again, seed 1, and T 0 against greedy; (u) path (d)'s measured
   sparsity through the ESACT accelerator's model (its estimate, not the
   card's time or energy); (v) ``repro_torch.quickstart`` and
   ``repro_torch.spls_ablation`` (200 steps) on the card.
9. The mesh-bound layers: (q) also attributes the card's own SPLS plans
   against the CPU's (differing entries per layer and field; for layer 0
   max |xn_card - xn_cpu|, the CPU's plan on the card's xn, and the
   predicted-score gap at every differing split, which must be a near-tie;
   equal layer-0 inputs with differing plans fail); (w) qwen3-0.6b at
   full width through ``ServingEngine`` with SPLS under a 16-wide model
   axis (``fake`` group): flat heads, a flat plan, B4 at G 1 over 16 heads,
   tokens equal to the structured layout's and to the plain backends' but
   at near-ties; (x) musicgen-medium at full width, 24 heads padded to 32,
   ``forward`` on B4 against the structured forward (1e-4 x max); (y) in a
   subprocess, every architecture's parameter, AdamW and decode-cache
   shardings on 16 x 16 and 2 x 16 x 16, bytes per device and the largest
   replicated leaf; (z) in a subprocess with a one-rank NCCL group, (p)'s
   trained checkpoint restored onto a 1 x 1 CUDA mesh through
   ``shardings=`` (bit-equal to a plain restore) and a ``Trainer(mesh=)``
   step equal to the step without a mesh.  ``gather_rows`` is also checked
   and timed in bf16 (bit-equal, beside bf16 ``index_select``).
10. The dry run, path (aa) (``repro_torch.launch.dryrun``: a step on
   ``DTensor``s over fake local shards, counted by ``op_analysis``):
   (aa.1) ``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape
   decode_32k`` on 16 x 16, whose argument bytes per device must equal
   path (y)'s parameter and cache bytes plus the tokens' and positions';
   (aa.2) in a subprocess, qwen3-0.6b's prefill (B 2 x L 4096) and decode
   step (B 8 against a 4096-token cache) dry-run on a one-rank mesh and
   then run on the card under the dry run's routes: argument bytes and
   dot FLOPs (``FlopCounterMode``) equal exactly, the predicted peak
   within 25 % of the card's; then both steps through B4 / B5, timed
   beside the dry run's roofline, their logits held against B4's and B5's
   plain versions on the same inputs (the decode cache from a prefill);
   (aa.3) the dry run of path (p)'s step
   beside (p)'s peak and step time; (aa.1) also holds its alias bytes to
   the cache's.  (aa.1) and (aa.3) use the host only
   and start before path (p).
11. A second architecture's dry run against the card, path (ab):
   h2o-danube3-4b at full width and depth (24 x 3840, 32 heads, 8 KV
   heads, Dh 120, G 4, window 4096; bf16 as published) through (aa.2)'s
   steps and checks, B4 and B5 at Dh 120 and G 4; and (ab.1), ``python
   -m repro_torch.launch.dryrun --arch h2o-danube3-4b --shape
   decode_32k`` on 16 x 16 (started with (aa.1)), whose argument bytes
   must equal path (y)'s and whose alias bytes its cache's.
12. An SPLS step's dry run against the card, path (ac): h2o-danube3-4b
   as (ab), with the dry run's SPLS configuration, a prefill of B 1 x L
   8192 (the chunked plan's row-block loop and the chunked attention's KV
   chunks run); its one-rank dry run, loops counted by trip count,
   against the same step on the card under the dry run's routes (argument
   bytes and dot FLOPs equal, peak within 25 %); then the step with
   ``compute_backend="packed_cuda"`` (the packed FFN rows through B1 and
   B2), timed beside the roofline, its logits held against
   ``packed_torch`` on the same inputs (1 bf16 ulp of max |plain|; the
   control runs the FFN on every row); and (ac.1), ``python -m
   repro_torch.launch.dryrun --arch h2o-danube3-4b --shape prefill_32k
   --spls --multi-pod`` (started with (aa.1)), whose argument bytes must
   equal :data:`AC1_ARGUMENT_BYTES`.

The last lines are the ``{"kernels": [...]}`` line, the card's
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
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
# int32 operations on the CUDA cores: 64 lanes per SM per clock, half the
# float32 rate (Hopper white paper)
INT32_OPS = 33.5e12
L2_ROTATE_BYTES = 80 << 20    # > the 50 MB L2
SEED = 0


# the SPLS planner's kernels follow the tensors' device, not a backend's
# name: every SPLS plan step on the card launches them, under the plain
# backends too
PLANNER_KERNELS = ("spls_plan_block", "spls_mfi")


def _backend_launches(launches: dict) -> dict:
    """The launch counts of the kernels a backend name chooses."""
    return {k: v for k, v in launches.items() if k not in PLANNER_KERNELS}


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


def _device_ms(fn, sets, match=None, calls: int = 50, by_kernel=None,
               tries: int = 3):
    """Device time per call from ``torch.profiler`` over ``calls`` calls,
    each on the next input set.  With ``match`` (a kernel name, or a tuple
    of the names of a call's kernels): the sum over those kernels of each
    one's mean duration (each runs once a call; the launch counts check
    that).  Without: the summed duration of all the card's activity
    (kernels, copies, fills) over the calls the trace holds, counted as
    the most frequent kernel's launches (at most ``calls``: a library call
    may launch one kernel twice).  The profiler may drop an activity at the
    edge of its window, so neither simply divides by ``calls``; and its
    trace of the card has come back empty now and then, so a window that
    holds too few of the calls is profiled again, up to ``tries`` times,
    before the script fails.  A dict given as ``by_kernel`` receives each
    matched kernel's own ms."""
    from torch.profiler import ProfilerActivity, profile

    names = (match,) if isinstance(match, str) else match
    for i in range(3):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(*sets[i % len(sets)])
            torch.cuda.synchronize()
        us, seen = {}, {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            key = e.name if names is None else next(
                (m for m in names if m in e.name), None)
            if key is not None:
                us[key] = us.get(key, 0.0) + e.time_range.elapsed_us()
                seen[key] = seen.get(key, 0) + 1
        if names is not None:
            if all(calls // 2 <= seen.get(m, 0) <= calls for m in names):
                if by_kernel is not None:
                    by_kernel.update({m: us[m] / seen[m] / 1e3
                                      for m in names})
                return sum(us[m] / seen[m] for m in names) / 1e3
            continue
        n = min(calls, max(seen.values(), default=0))
        if n >= calls // 2:
            return sum(us.values()) / 1e3 / n
    _fail(f"the profiler saw {seen} launches of {names or 'any kernel'} in "
          f"{calls} calls, {tries} times")


def _timings(kernel, plain, library, sets, match, lib_sets=None) -> dict:
    """The kernel's, its plain version's and the library call's ``ms`` per
    call (CUDA events around many calls: the host's share of a call
    included), and the device time per call of the kernel (its own
    kernels, ``match``; split by kernel when a call runs several) and of
    the library call (all its device activity)."""
    lib_sets = sets if lib_sets is None else lib_sets
    by_kernel = {}
    t = {"ms": _time_ms(kernel, sets), "plain_ms": _time_ms(plain, sets),
         "library_ms": _time_ms(library, lib_sets),
         "kernel_ms": _device_ms(kernel, sets, match, by_kernel=by_kernel),
         "library_kernel_ms": _device_ms(library, lib_sets)}
    if len(by_kernel) > 1:
        t["kernel_ms_by_kernel"] = by_kernel
    return t


def _times(row: dict) -> dict:
    return {k: row[k] for k in ("ms", "kernel_ms", "plain_ms", "library_ms",
                                "library_kernel_ms")}


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
    t = _timings(K.gathered_matmul, K.gathered_matmul_plain,
                 lambda x, w, p: x.index_select(0, p) @ w, sets, "gmm_kernel")
    flop_s = 2.0 * C * D * F / FP64_FLOPS
    byte_s = (C * D + D * F + C * F) * 4 / HBM_BYTES_PER_S
    bm, splits = gmm_tiling(C, F, D)
    return {"shape": {"L": L, "C": C, "D": D, "F": F},
            "tiling": {"bm": bm, "bn": 64, "splits": splits}, **t,
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
            **_times(row), "library": "x.index_select(0, perm) @ w",
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_peak": "the card's float64 peak, 67 TFLOP/s through the "
                          "FP64 tensor cores, which the kernel's DMMA "
                          "products use",
            "at_q_shape": q_shape,
            "cases": cases}


def check_gather_rows(K, gen) -> dict:
    """B2 at the leader scatter's shape, float32 (the row) and bf16 (the
    copy by element size, timed beside bf16 ``index_select``, under
    ``bf16``); both bit-equal to the plain version."""
    dev = "cuda"
    C, F, M = 48, 768, 64
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        src = torch.randn(C, F, device=dev, generator=gen).to(dtype)
        idx = torch.randint(0, C, (M,), device=dev, generator=gen,
                            dtype=torch.int32)
        got = K.gather_rows(src, idx)
        err = _max_err(got.float(), K.gather_rows_plain(src, idx).float())
        if err != 0.0 or got.dtype != dtype:
            _fail(f"gather_rows {dtype}: max |err| {err}, dtype {got.dtype} "
                  f"(a copy is exact)")
        sets = []
        for _ in range(_n_sets(C * F * size + M * 4 + M * F * size)):
            sets.append((torch.randn(C, F, device=dev, generator=gen)
                         .to(dtype),
                         torch.randint(0, C, (M,), device=dev, generator=gen,
                                       dtype=torch.int32)))
        t = _timings(K.gather_rows, K.gather_rows_plain,
                     lambda s, i: s.index_select(0, i), sets,
                     "gather_rows_kernel")
        out[dtype] = {"max_abs_err": err, **t,
                      "bound_ms": 1e3 * 2 * M * F * size / HBM_BYTES_PER_S}
    f32 = out[torch.float32]
    return {"name": "gather_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/gather_rows.cu",
            "replaces": "src/repro/kernels/gathered_matmul.py:198",
            "shape": {"C": C, "F": F, "M": M, "dtype": "float32"},
            "tolerance": 0.0, **f32, "bound_by": "bytes",
            "library": "src.index_select(0, idx)",
            "bf16": out[torch.bfloat16]}


def _decode_inputs(gen, B, KV, G, Dh, N, ps, P, kv_lens, compact: bool,
                   dtype=torch.float32, q_scale=1.0):
    """Random pool + block tables for rows with the given kv_len; with
    ``compact`` the pos ids skip (an SPLS-compacted layout: id != slot).
    ``q_scale`` widens the scores, so that a softcap bites."""
    dev = "cuda"
    q = (torch.randn(B, KV, G, Dh, device=dev, generator=gen)
         * q_scale).to(dtype)
    kp = torch.randn(KV, N, ps, Dh, device=dev, generator=gen).to(dtype)
    vp = torch.randn(KV, N, ps, Dh, device=dev, generator=gen).to(dtype)
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


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of ``x`` (0 where x is 0)."""
    m, e = torch.frexp(x.float())
    return torch.where(m == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))


def _decode_err(got, ref, name: str, kernel: str) -> dict:
    """max |err| against the plain version: within 1e-5 in float32; in
    bf16 within one bf16 ulp of the plain output, or 1e-5 where that ulp is
    smaller (float32 sums in another order move an element by about 1e-6
    before its rounding)."""
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    if got.dtype == torch.bfloat16:
        tol = torch.clamp(_bf16_ulp(ref), min=1e-5)
        ok = bool((err <= tol).all())
        ulps = float((err / torch.clamp(_bf16_ulp(ref), min=1e-30)).max())
        out = {"max_abs_err": float(err.max()),
               "tolerance": "max(1 bf16 ulp of plain, 1e-5)",
               "max_err_in_ulps": ulps}
    else:
        ok = float(err.max()) <= 1e-5
        out = {"max_abs_err": float(err.max()), "tolerance": 1e-5}
    if not torch.isfinite(got.float()).all() or not ok:
        _fail(f"{kernel} case {name}: {out}")
    return out


def check_paged_decode(K, gen) -> dict:
    from repro_torch.kernels.paged_decode import paged_split_count

    B, KV, Dh, N, ps, P = 4, 12, 64, 129, 16, 32
    path_lens = [200, 180, 260, 150]
    bf16 = torch.bfloat16
    # at the path shape the written pages split 8 ways (2 pages, 32 slots
    # a share at kv_len 200); a window of 40 ends inside a share
    cases = [("path", dict(G=1, lens=path_lens, compact=True)),
             ("compact_window", dict(G=1, lens=path_lens, compact=True,
                                     window=64)),
             ("softcap", dict(G=1, lens=path_lens, compact=False,
                              softcap=30.0)),
             ("kv_len_0", dict(G=1, lens=[0, 37, 512, 16], compact=False)),
             ("gqa_g4", dict(G=4, lens=path_lens, compact=True, window=100,
                             softcap=50.0)),
             ("gqa_g16", dict(G=16, lens=path_lens, compact=True,
                              window=100, softcap=50.0)),
             ("bf16", dict(G=1, lens=path_lens, compact=True, dtype=bf16)),
             ("bf16_gqa_g16_window", dict(G=16, lens=path_lens,
                                          compact=True, window=100,
                                          dtype=bf16)),
             # gemma2's local block in bf16: G 2, Dh 128, window, softcap
             ("bf16_gqa_g2_window_softcap", dict(G=2, lens=path_lens,
                                                 compact=True, Dh=128,
                                                 window=100, softcap=50.0,
                                                 q_scale=8.0, dtype=bf16)),
             ("kv_len_0_and_full_table", dict(G=1, lens=[0, P * ps, 37, 1],
                                              compact=True)),
             ("window_ends_inside_a_split", dict(G=1, lens=path_lens,
                                                 compact=True, window=40)),
             ("last_page_partly_written", dict(G=2, lens=[201, 183, 17, 255],
                                               compact=False)),
             # one page a table: the written pages cannot split
             ("nsplit_1", dict(G=1, lens=[16, 5, 0, 9], compact=True, P=1)),
             ("dh_20_scalar", dict(G=2, lens=path_lens, compact=True,
                                   Dh=20, window=90)),
             ("bf16_dh_20_scalar", dict(G=1, lens=path_lens, compact=False,
                                        Dh=20, dtype=bf16)),
             # h2o-danube3's head width, GQA G 4 and its window
             ("dh_120_gqa_g4", dict(G=4, lens=path_lens, compact=True,
                                    Dh=120, window=64)),
             ("bf16_dh_120_gqa_g4", dict(G=4, lens=path_lens, compact=False,
                                         Dh=120, dtype=bf16)),
             # 8 scalar loads a lane: one slot at a time
             ("dh_250_scalar", dict(G=1, lens=path_lens, compact=True,
                                    Dh=250)),
             ("bf16_dh_250_scalar", dict(G=1, lens=path_lens, compact=True,
                                         Dh=250, dtype=bf16))]
    results = []
    for name, c in cases:
        Pc, Dc = c.get("P", P), c.get("Dh", Dh)
        inp = _decode_inputs(gen, B, KV, c["G"], Dc, N, ps, Pc, c["lens"],
                             c["compact"], c.get("dtype", torch.float32),
                             c.get("q_scale", 1.0))
        kw = dict(softcap=c.get("softcap"), window=c.get("window"))
        before = K.paged_flash_decode.launches
        got = K.paged_flash_decode(*inp, **kw)
        launched = K.paged_flash_decode.launches - before
        ref = K.paged_decode_plain(*inp, **kw)
        row = _decode_err(got, ref, name, "paged_flash_decode")
        if launched != 1 or got.dtype != inp[0].dtype:
            _fail(f"paged_flash_decode case {name}: {launched} launches, "
                  f"dtype {got.dtype}")
        results.append({"case": name, "G": c["G"], "Dh": Dc, "P": Pc,
                        "dtype": str(got.dtype).replace("torch.", ""),
                        "splits": paged_split_count(B * KV, Pc, ps,
                                                    kw["window"]), **row})
    if not {1, 8} <= {r["splits"] for r in results}:
        _fail(f"paged_flash_decode cases ran splits "
              f"{sorted({r['splits'] for r in results})}, not 1 and 8")
    # timed at the path shape: 4 rows, 12 heads, G = 1, compacted pages
    per_set = 2 * KV * N * ps * Dh * 4
    sets = [_decode_inputs(gen, B, KV, 1, Dh, N, ps, P, path_lens, True)
            for _ in range(_n_sets(per_set))]
    def sdpa(q, kp, vp, pos_pages, tables, kv_len, pos):
        t = tables.long()
        Bq, KVq, Gq, Dq = q.shape
        S = t.shape[1] * kp.shape[2]
        kg = kp[:, t].movedim(1, 0).reshape(Bq, KVq, S, Dq)
        vg = vp[:, t].movedim(1, 0).reshape(Bq, KVq, S, Dq)
        m = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
        return torch.nn.functional.scaled_dot_product_attention(
            q, kg, vg, attn_mask=m[:, None, None, :])

    t = _timings(K.paged_flash_decode, K.paged_decode_plain, sdpa, sets,
                 "paged_decode_kernel")
    live = sum(path_lens)
    byte_s = (2 * live * KV * Dh * 4 + 2 * B * KV * Dh * 4) / HBM_BYTES_PER_S
    flop_s = 4.0 * B * KV * live * Dh / FP32_FLOPS
    return {"name": "paged_flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_decode.py:99",
            "shape": {"B": B, "KV": KV, "G": 1, "Dh": Dh, "N": N, "ps": ps,
                      "P": P, "kv_len": path_lens},
            "splits": paged_split_count(B * KV, P, ps),
            "max_abs_err": max(r["max_abs_err"] for r in results
                               if r["dtype"] == "float32"),
            "tolerance": "1e-5 (float32); max(1 bf16 ulp of plain, 1e-5) "
                         "(bf16)",
            **t,
            "library": "block-table gather + scaled_dot_product_attention",
            "bound_ms": 1e3 * max(byte_s, flop_s),
            "bound_by": "bytes" if byte_s >= flop_s else "operations",
            "cases": results}


def _ns_per_call(fn, calls: int = 10_000, block: int = 500) -> float:
    """Host nanoseconds per call of ``fn()`` (``time.perf_counter_ns``):
    the median over blocks of ``block`` calls, the card synchronised
    between blocks (so no block waits on a full launch queue), ``calls``
    calls in all."""
    fn()
    times = []
    for _ in range(calls // block):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(block):
            fn()
        times.append((time.perf_counter_ns() - t0) / block)
    torch.cuda.synchronize()
    return statistics.median(times)


def host_path(K, gen) -> dict:
    """The host path of a ``gather_rows`` call (C 48, F 768, M 64) and a
    ``paged_flash_decode`` call (the path shape), phase by phase: each
    phase alone in a loop of 10^4 calls, after a sync, beside the whole
    wrapper."""
    import importlib

    from repro_torch.kernels.paged_decode import paged_split_count

    # the modules (the package's names of the same spelling are wrappers)
    GM = importlib.import_module("repro_torch.kernels.gathered_matmul")
    PD = importlib.import_module("repro_torch.kernels.paged_decode")

    C, F, M = 48, 768, 64
    src = torch.randn(C, F, device="cuda", generator=gen)
    idx = torch.randint(0, C, (M,), device="cuda", generator=gen,
                        dtype=torch.int32)
    out = torch.empty(M, F, device="cuda")
    dev = src.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    fn = GM._fn("gather_rows", "gather_rows_bytes", GM._GATHER_ARGS)
    ptrs = (src.data_ptr(), idx.data_ptr(), out.data_ptr())
    g = {"wrapper": lambda: K.gather_rows(src, idx),
         "device_test": lambda: src.is_cuda,
         "checks_x2": lambda: (GM._check(src, "src", src.dtype, 2, dev),
                               GM._check(idx, "idx", torch.int32, 1, dev)),
         "alloc": lambda: src.new_empty((M, F)),
         "bind_lookup": lambda: GM._fn("gather_rows", "gather_rows_bytes",
                                       GM._GATHER_ARGS),
         "device_and_stream": lambda: (
             torch._C._cuda_getDevice(),
             torch._C._cuda_getCurrentRawStream(dev)),
         "data_ptrs": lambda: (src.data_ptr(), idx.data_ptr(),
                               out.data_ptr()),
         "ctypes_call": lambda: fn(*ptrs, C, F * 4, M, stream)}

    B, KV, Dh, N, ps, P = 4, 12, 64, 129, 16, 32
    inp = _decode_inputs(gen, B, KV, 1, Dh, N, ps, P, [200, 180, 260, 150],
                         True)
    q, kp, vp, pp, tb, kl, pos = inp
    pout = torch.empty_like(q)
    pfn = GM._fn("paged_decode", "paged_decode", PD._ARGS)
    pptrs = tuple(t.data_ptr() for t in inp) + (pout.data_ptr(),)
    pargs = (0, B, KV, 1, Dh, N, ps, P, Dh ** -0.5, 0.0, 0,
             paged_split_count(B * KV, P, ps))

    def checks7():
        GM._check(q, "q", q.dtype, 4, dev)
        GM._check(kp, "k_pages", q.dtype, 4, dev)
        GM._check(vp, "v_pages", q.dtype, 4, dev)
        GM._check(pp, "pos_pages", torch.int32, 2, dev)
        GM._check(tb, "tables", torch.int32, 2, dev)
        GM._check(kl, "kv_len", torch.int32, 1, dev)
        GM._check(pos, "pos", torch.int32, 1, dev)

    pg = {"wrapper": lambda: K.paged_flash_decode(*inp),
          "device_test": lambda: q.is_cuda,
          "checks_x7": checks7,
          "split_count": lambda: paged_split_count(B * KV, P, ps, None),
          "alloc": lambda: torch.empty_like(q),
          "bind_lookup": lambda: GM._fn("paged_decode", "paged_decode",
                                        PD._ARGS),
          "device_and_stream": lambda: (
              torch._C._cuda_getDevice(),
              torch._C._cuda_getCurrentRawStream(dev)),
          "data_ptrs": lambda: (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                                pp.data_ptr(), tb.data_ptr(), kl.data_ptr(),
                                pos.data_ptr(), pout.data_ptr()),
          "ctypes_call": lambda: pfn(*pptrs, *pargs, stream)}
    res = {name: {k: _ns_per_call(f) for k, f in phases.items()}
           for name, phases in (("gather_rows", g),
                                ("paged_flash_decode", pg))}
    line = {"host_path": res,
            "note": "host ns per call (perf_counter_ns, median of 20 "
                    "blocks of 500 calls, the card synchronised between "
                    "blocks); each phase timed alone, so the phases do not "
                    "sum exactly to the wrapper; ctypes_call includes the "
                    "launch"}
    print(json.dumps(line))
    return res


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
    t = _timings(
        fa, fp,
        lambda q, k, v, m: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=m), sets, "flash_attention_kernel", lib_sets)
    H = KV
    byte_s = ((4 * B * H * L * Dh) * 4 + B * H * L * (1 + 4)) \
        / HBM_BYTES_PER_S
    flop_s = 4.0 * Dh * live / FP64_FLOPS
    return {"shape": {"B": B, "H": H, "L": L, "Dh": Dh, "causal": False,
                      "live_pairs": live, "all_pairs": B * H * L * L},
            **t,
            "bound_ms": 1e3 * max(byte_s, flop_s),
            "bound_by": "operations" if flop_s >= byte_s else "bytes"}


def _flat_plan_case(gen):
    """Path (w)'s call of B4: qwen3-0.6b's attention in the flat layout (H
    16 at G 1, Dh 128, L 384, causal), with ``kv_keep`` and the packed q
    rows of a flat plan that :class:`PlanContext` builds at (w)'s SPLS knobs
    from random weights and input, laid out as ``cuda_flash`` lays them
    (every row, critical first)."""
    from repro_torch.core.planner import PlanContext
    from repro_torch.core.sparse_exec import pack_by_mask
    from repro_torch.core.spls import SPLSConfig

    dev = "cuda"
    D, KV, G, Dh, L = 1024, 8, 2, 128, 384
    H = KV * G
    ctx = PlanContext(SPLSConfig(enabled=True, k_ratio=0.12, s_threshold=0.6,
                                 f_threshold=6, window=8, causal=True),
                      D, KV, G, Dh, True, mode="flat")
    p = {"wq": torch.randn(D, KV, G, Dh, device=dev, generator=gen) / D ** .5,
         "wk": torch.randn(D, KV, Dh, device=dev, generator=gen) / D ** .5}
    xn = torch.randn(1, L, D, device=dev, generator=gen)
    plan = ctx.plan_exact(p, xn)
    if tuple(plan.kv_keep.shape[:3]) != (1, H, 1):
        _fail(f"flash_attention: flat plan of shape "
              f"{tuple(plan.kv_keep.shape)}, expected (1, {H}, 1, {L})")
    q, k, v, _, _ = _attn_case(gen, 1, KV, G, L, Dh)
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    q_pos, _ = pack_by_mask(plan.q_critical.reshape(1, H, L), L)
    q_pos = q_pos.to(torch.int32).contiguous()
    qp = torch.gather(q, 2, q_pos.long()[..., None].expand(-1, -1, -1, Dh))
    return (qp.contiguous(), k.contiguous(), v.contiguous(),
            plan.kv_keep.reshape(1, H, L).contiguous(), q_pos)


def _padded_case(gen):
    """Path (x)'s call of B4: musicgen-medium's 24 heads padded to H' 32
    at G 1 (B 2, L 512, Dh 64, causal, no plan); the 8 padded heads' q, k
    and v are zero, as their zero ``wq`` and padded ``wk`` / ``wv`` give
    them."""
    q, k, v, _, _ = _attn_case(gen, 2, 32, 1, 512, 64)
    for t in (q, k, v):
        t[:, 24:] = 0
    return q, k, v, None, None


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
                             Dh=128), dict(causal=False)),
             # the model families' shapes: qwen3 (G 2, Dh 128), h2o-danube3
             # (G 4, Dh 120, a window), llama3 (G 16)
             ("qwen3", dict(G=2, H=16, L=L, Dh=128), dict(causal=True)),
             ("danube", dict(G=4, H=32, L=L, Dh=120),
              dict(causal=True, window=64)),
             ("llama3_g16", dict(G=16, H=16, L=L, Dh=128),
              dict(causal=True)),
             # path (ab)'s prefill: h2o-danube3's 32 heads over 4096 tokens,
             # its window 4096 (one row of the step's batch of 2)
             ("danube_ab_L_4096", dict(B=1, G=4, H=32, L=4096, Dh=120),
              dict(causal=True, window=4096)),
             # the head layouts of paths (w) and (x), G 1
             ("qwen3_flat_plan", _flat_plan_case, dict(causal=True)),
             ("musicgen_padded_h32", _padded_case, dict(causal=True))]
    results = []
    for name, shape, kw in cases:
        if callable(shape):
            q, k, v, keep, q_pos = shape(gen)
            Bc, Hc, _, Dc = q.shape
            G = Hc // k.shape[1]
        else:
            Bc = shape.pop("B", B)
            G = shape.pop("G")
            Lc = shape.pop("L")
            Dc = shape.pop("Dh", Dh)
            Hc = shape.pop("H", KV)
            q, k, v, keep, q_pos = _attn_case(gen, Bc, Hc // G, G, Lc, Dc,
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
        results.append({"case": name, "B": Bc, "H": Hc, "G": G, "Dh": Dc,
                        "max_abs_err": err, "tolerance": tol})
    # timed at the shape of paths (b) and (c), B 1, and of path (d), B 8
    row = _time_flash_attention(K, gen, B, KV, L, Dh)
    path_d = _time_flash_attention(K, gen, 8, KV, L, Dh)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:156",
            "shape": row["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "tolerance": "1e-6 * max(1, max|plain|)",
            **_times(row),
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
    from repro_torch.kernels.flash_decode import decode_split_count

    dev = "cuda"
    B, KV, S, Dh = 4, 12, 512, 64

    def inputs(G, pos, q_scale=1.0, S=S, Dh=Dh, KV=KV, dtype=torch.float32):
        kv, Bc = KV // G, len(pos)
        q = torch.randn(Bc, kv, G, Dh, device=dev, generator=gen) * q_scale
        k = torch.randn(Bc, kv, S, Dh, device=dev, generator=gen)
        v = torch.randn(Bc, kv, S, Dh, device=dev, generator=gen)
        return (q.to(dtype), k.to(dtype), v.to(dtype),
                torch.tensor(pos, dtype=torch.int32, device=dev))

    def path_pos(n=B):
        return torch.randint(384, 401, (n,), generator=torch.Generator()
                             .manual_seed(int(torch.randint(
                                 0, 1 << 30, (1,), device=dev,
                                 generator=gen)))).tolist()

    # without a window the path's rows split 8 ways, S / 8 = 64 slots a
    # split; the windows below are shorter than that, and exactly that
    cases = [("path", dict(G=1, pos=path_pos()), {}),
             ("window_64", dict(G=1, pos=path_pos()), dict(window=64)),
             ("softcap_30", dict(G=1, pos=path_pos(), q_scale=8.0),
              dict(softcap=30.0)),
             ("gqa_g4", dict(G=4, pos=path_pos()), dict(window=100)),
             ("pos_0", dict(G=1, pos=[0, 511, 5, 64]), {}),
             # a cache that is no multiple of the old kernel's K tile
             ("ragged_S_300", dict(G=1, pos=[299, 150, 0, 257], S=300),
              dict(window=100)),
             ("B_1", dict(G=1, pos=path_pos(1)), {}),
             ("B_64", dict(G=1, pos=path_pos(64)), {}),
             ("pos_S_minus_1", dict(G=1, pos=[S - 1] * B), {}),
             ("window_under_one_split", dict(G=1, pos=path_pos()),
              dict(window=40)),
             ("window_one_split", dict(G=1, pos=[S - 1, 200, 63, 64]),
              dict(window=64)),
             ("gqa_g8", dict(G=8, pos=path_pos(), KV=16), dict(window=100)),
             ("dh_128", dict(G=1, pos=path_pos(), Dh=128), {}),
             ("dh_256_softcap", dict(G=2, pos=path_pos(), Dh=256,
                                     q_scale=4.0), dict(softcap=30.0)),
             ("dh_20_scalar", dict(G=1, pos=path_pos(), Dh=20), {}),
             # h2o-danube3's head width, GQA G 4 and a window
             ("dh_120_gqa_g4", dict(G=4, pos=path_pos(), Dh=120),
              dict(window=64)),
             ("bf16_dh_120_gqa_g4", dict(G=4, pos=path_pos(), Dh=120,
                                         dtype=torch.bfloat16), {}),
             ("dh_20_gqa_g4", dict(G=4, pos=[299, 0, 17, 511], Dh=20),
              dict(window=70)),
             # two passes of 8 query rows over each share
             ("gqa_g16", dict(G=16, pos=path_pos(), KV=32),
              dict(window=100, softcap=30.0)),
             ("dh_256_gqa_g16", dict(G=16, pos=path_pos(), KV=16, Dh=256),
              {}),
             ("bf16", dict(G=1, pos=path_pos(), dtype=torch.bfloat16), {}),
             ("bf16_gqa_g16", dict(G=16, pos=path_pos(), KV=32,
                                   dtype=torch.bfloat16), dict(window=100)),
             # path (aa)'s decode step: qwen3-0.6b's heads over a full
             # 4096-slot cache, bf16
             ("bf16_qwen3_S_4096", dict(G=2, pos=[4095] * 8, KV=16, S=4096,
                                        Dh=128, dtype=torch.bfloat16), {}),
             # path (ab)'s: h2o-danube3-4b's (G 4, Dh 120, window 4096)
             ("bf16_danube_ab_S_4096", dict(G=4, pos=[4095] * 8, KV=32,
                                            S=4096, Dh=120,
                                            dtype=torch.bfloat16),
              dict(window=4096)),
             # gemma2's local block in bf16: G 2, Dh 128, window, softcap
             ("bf16_gqa_g2_window_softcap", dict(G=2, pos=path_pos(),
                                                 Dh=128, q_scale=4.0,
                                                 dtype=torch.bfloat16),
              dict(window=100, softcap=50.0)),
             ("bf16_dh_20_scalar", dict(G=2, pos=[299, 0, 17, 511], Dh=20,
                                        dtype=torch.bfloat16), {}),
             # 8 scalar loads a lane: one slot at a time
             ("dh_250_scalar", dict(G=1, pos=path_pos(), Dh=250), {}),
             ("bf16_dh_250_scalar", dict(G=1, pos=path_pos(), Dh=250,
                                         dtype=torch.bfloat16),
              dict(window=100))]
    results = []
    for name, c, kw in cases:
        inp = inputs(**c)
        before = K.flash_decode.launches
        got = K.flash_decode(*inp, **kw)
        launched = K.flash_decode.launches - before
        ref = K.flash_decode_plain(*inp, **kw)
        row = _decode_err(got, ref, name, "flash_decode")
        if launched != 1 or got.dtype != inp[0].dtype:
            _fail(f"flash_decode case {name}: {launched} launches, dtype "
                  f"{got.dtype}")
        q = inp[0]
        results.append({"case": name, "B": q.shape[0], "G": q.shape[2],
                        "Dh": q.shape[3], "S": inp[1].shape[2],
                        "dtype": str(q.dtype).replace("torch.", ""),
                        "splits": decode_split_count(
                            q.shape[0] * q.shape[1], inp[1].shape[2],
                            kw.get("window")), **row})
    pos = path_pos()
    per_set = 2 * B * KV * S * Dh * 4
    sets, lib_sets = [], []
    for _ in range(_n_sets(per_set)):
        q, k, v, p = inputs(1, pos)
        sets.append((q, k, v, p))
        m = torch.arange(S, device=dev)[None, :] <= p[:, None].long()
        lib_sets.append((q, k, v, m[:, None, None, :]))
    t = _timings(
        K.flash_decode, K.flash_decode_plain,
        lambda q, k, v, m: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=m), sets, "flash_decode_kernel", lib_sets)
    live = sum(x + 1 for x in pos)
    byte_s = (2 * live * KV * Dh * 4 + 2 * B * KV * Dh * 4 + B * 4) \
        / HBM_BYTES_PER_S
    flop_s = 4.0 * KV * live * Dh / FP32_FLOPS
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:82",
            "shape": {"B": B, "KV": KV, "G": 1, "S": S, "Dh": Dh,
                      "pos": pos},
            "splits": decode_split_count(B * KV, S),
            "max_abs_err": max(r["max_abs_err"] for r in results
                               if r["dtype"] == "float32"),
            "tolerance": "1e-5 (float32); max(1 bf16 ulp of plain, 1e-5) "
                         "(bf16)", **t,
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


def _hlog_worst(name: str, m: int, k: int, n: int):
    """Codes that drive the exact sums to their extremes: all 127 (every
    product 16384, every sum K * 16384: 2^22 at K 256, 2^24 at K 1024 and
    past it at 1025), or 127 with signs alternating by (row + column) and
    along K in runs of 300 (partial sums climb towards the bound, fall back
    and change sign across the drains)."""
    x = torch.full((m, k), 127.0, device="cuda")
    w = torch.full((k, n), 127.0, device="cuda")
    if name.startswith("alternating"):
        i = torch.arange(m, device="cuda")[:, None]
        j = torch.arange(k, device="cuda")[None, :]
        x = x * (1 - 2 * ((i + j // 300) % 2))
        w = w * (1 - 2 * (torch.arange(n, device="cuda")[None, :] % 2))
    return x.contiguous(), w.contiguous()


def check_hlog_qmatmul(K, gen) -> dict:
    from repro_torch.core.quantizers import hlog_project
    from repro_torch.kernels.hlog_qmatmul import HLOG_BM, hlog_tiling

    dev = "cuda"
    # the predictor product of path (d): 8 prompts x 384 rows, 768 x 768
    M, Kd, N = 3072, 768, 768
    cases = []
    shapes = [("path", (M, Kd, N)), ("ragged", (200, 768, 300)),
              ("K_4096", (256, 4096, 256)), ("K_8200", (130, 8200, 70)),
              # under one tile in every dimension; K no multiple of 4
              ("ragged_under_one_tile", (127, 31, 191)),
              ("ragged_tiny", (37, 19, 45)),
              ("all_127_K_256", (128, 256, 192)),
              ("all_127_K_1024", (128, 1024, 192)),
              ("all_127_K_1025", (130, 1025, 70)),
              ("alternating_K_1025", (256, 1025, 192)),
              ("alternating_K_4096", (128, 4096, 128))]
    for name, (m, k, n) in shapes:
        if name.startswith(("all_127", "alternating")):
            xq, wq = _hlog_worst(name, m, k, n)
        else:
            xq, wq = _codes((m, k), gen), _codes((k, n), gen)
        before = K.hlog_qmatmul.launches
        got = K.hlog_qmatmul(xq, wq)
        launched = K.hlog_qmatmul.launches - before
        err = _max_err(got, K.hlog_qmatmul_plain(xq, wq))
        if err != 0.0 or launched != 1:
            _fail(f"hlog_qmatmul case {name}: max |err| {err} != 0 (both "
                  f"round one exact integer sum) or {launched} launches")
        cases.append({"case": name, "M": m, "K": k, "N": n,
                      "bn": hlog_tiling(m, n), "max_abs_err": err,
                      "max_abs": float(got.abs().max()), "tolerance": 0.0})
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
    proj = [(hlog_project(x), hlog_project(w)) for x, w in sets]
    t = _timings(K.hlog_qmatmul, K.hlog_qmatmul_plain, torch.matmul, sets,
                 ("hlog_project_kernel", "hlog_qmatmul_kernel"), proj)
    bf16 = [(x.bfloat16(), w.bfloat16()) for x, w in proj]
    t["library_bf16_ms"] = _time_ms(torch.matmul, bf16)
    t["library_bf16_kernel_ms"] = _device_ms(torch.matmul, bf16)
    ops = 2.0 * M * Kd * N
    peak = BF16_FLOPS if Kd <= 1024 else FP32_FLOPS
    flop_s = ops / peak
    byte_s = (M * Kd + Kd * N + M * N) * 4 / HBM_BYTES_PER_S
    # the design's own limit, worked out, not measured (apart from the
    # kernels line, which holds measured times and the bound): its bf16
    # tensor-core products; its projection pass -- each code read once as
    # float32 and its level written once as bf16, over the card's memory
    # rate, and 3 integer operations (byte permute, add, and) per pair;
    # whichever takes longest
    bn = hlog_tiling(M, N)
    codes = M * Kd + Kd * N
    tc_s = ops / BF16_FLOPS
    proj_bytes_s = 6 * codes / HBM_BYTES_PER_S
    proj_int_s = 1.5 * codes / INT32_OPS
    print(json.dumps({"design_limit": {
        "kernel": "hlog_qmatmul", "shape": {"M": M, "K": Kd, "N": N},
        "tile": [HLOG_BM, bn],
        "ms": 1e3 * max(tc_s, proj_bytes_s, proj_int_s),
        "tensor_core_ms": 1e3 * tc_s,
        "projection_bytes_ms": 1e3 * proj_bytes_s,
        "projection_int_ms": 1e3 * proj_int_s,
        "operand_bytes_from_l2": 2 * (M * Kd * -(-N // bn)
                                      + Kd * N * -(-M // HLOG_BM)),
        "by": "the largest of the bf16 tensor-core products at 989 TFLOP/s, "
              "the projection pass's bytes (4 read + 2 written per code) "
              "at 3.35 TB/s and its integer work (1.5 operations a code) "
              "at 33.5 TOP/s; the product's operand reads from L2 are not "
              "in it"}}))
    return {"name": "hlog_qmatmul", "route": "cuda",
            "source": "src/repro_torch/csrc/hlog_qmatmul.cu",
            "replaces": "src/repro/kernels/hlog_qmatmul.py:57",
            "shape": {"M": M, "K": Kd, "N": N}, "tile": [HLOG_BM, bn],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": 0.0, **t,
            "library": "torch.matmul of the projected operands (float32, "
                       "TF32 off): a floor for a library route, which "
                       "would also have to project",
            "library_bf16": "torch.matmul of the projected operands in "
                            "bf16 (the same integers up to K 1024 inside; "
                            "its bf16 output rounds them): a second floor",
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
    nwin = B * H * L // w
    t = _timings(lambda x: K.local_similarity_dist(x, w),
                 lambda x: K.local_similarity_plain(x, w),
                 lambda x: torch.cdist(x, x, p=1), sets,
                 "local_similarity_kernel",
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
            **t,
            "library": "torch.cdist(x, x, p=1) on the (B*H*L/w, w, Lk) view",
            "bound_ms": 1e3 * max(flop_s, byte_s),
            "bound_by": "operations" if flop_s >= byte_s else "bytes",
            "cases": cases}


def _plan_scores(shape, w, gen) -> torch.Tensor:
    """PAM scores whose rows are a window's base row plus noise that grows
    down the window, so windows hold both critical and similar rows."""
    *lead, C, S = shape
    base = torch.randn((*lead, C // w, 1, S), device="cuda", generator=gen)
    noise = torch.randn((*lead, C // w, w, S), device="cuda", generator=gen)
    grow = torch.linspace(0.0, 1.5, w, device="cuda")[:, None]
    return ((base + grow * noise) * 8.0).reshape(shape).contiguous()


def _near_tie_rows(name, scores, scale, w, s, plain, got) -> int:
    """The rows where the kernel's ``is_critical`` / ``leader`` differ from
    the plain chain's; fails unless each window's first differing row has
    an earlier critical row at a float64 distance within 1e-6 x max(1, s)
    of ``s`` (later rows of that window are its consequence)."""
    mask, crit_p, lead_p, _ = plain
    _, crit_k, lead_k, _ = got
    C, S = scores.shape[-2:]
    diff = ((crit_p != crit_k) | (lead_p != lead_k)).reshape(-1, C // w, w)
    bad = diff.any(-1).nonzero().tolist()
    if not bad:
        return 0
    pam = (scores * scale).to(torch.bfloat16).to(torch.float64)
    spa = torch.where(mask, pam, 0.0).reshape(-1, C // w, w, S)
    crit = crit_p.reshape(-1, C // w, w)
    rows = 0
    for h, win in bad:
        x = spa[h, win]
        j = int(diff[h, win].nonzero()[0])
        norm = x.abs().sum(-1)
        d = [float((x[i] - x[j]).abs().sum() / (norm[i] + norm[j] + 1e-6))
             for i in range(j) if crit[h, win, i]]
        if not any(abs(v - s) <= 1e-6 * max(1.0, s) for v in d):
            _fail(f"spls_plan_block case {name}: head {h} window {win} row "
                  f"{j} differs from the plain chain, distances {d} to its "
                  f"earlier critical rows are no near-tie of {s}")
        rows += int(diff[h, win, j:].sum())
    return rows


def check_spls_plan(K, gen) -> list:
    """``spls_plan_block`` and ``spls_mfi`` against their plain versions
    on the same card tensors: cell A's middle and last chunk (1 x 8 x 2 x
    256 rows x 2176 slots, w 8, a 1964-token prompt), its votes-only block,
    and path (ac)'s 8192-slot row block (1 x 8 x 4 x 512, Dh 120).  Mask,
    ``kv_any`` and the MFI outputs bit-equal; ``is_critical`` / ``leader``
    equal but at near-ties.  Timed at A's middle chunk."""
    from repro_torch.core.mfi import mfi_ffn_sparsity
    from repro_torch.core.spls_chunked import spls_plan_block_plain
    from repro_torch.core.topk import topk_count

    s_thr, f_thr, k_a = 0.6, 6, topk_count(1964, 0.12)
    a_shape = (1, 8, 2, 256, 2176)
    # name: (shape, Dh, k, row0, n_valid_rows, n_cols)
    cases = {"cell_a_middle": (a_shape, 128, k_a, 1024, 256, 1280),
             "cell_a_last": (a_shape, 128, k_a, 1792, 172, 1964),
             "ac_block_8192": ((1, 8, 4, 512, 8192), 120,
                               topk_count(8192, 0.12), 4096, 512, 8192)}
    w, out = 8, []
    for name, (shape, Dh, k, row0, valid, n_cols) in cases.items():
        scores = _plan_scores(shape, w, gen)
        kw = dict(scale=Dh ** -0.5, k=k, row0=row0, n_valid_rows=valid,
                  n_cols=n_cols, causal=True, w=w, s_threshold=s_thr)
        got = K.spls_plan_block(scores, **kw)
        plain = spls_plan_block_plain(scores, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got[0], plain[0]) or \
                not torch.equal(got[3], plain[3]):
            _fail(f"spls_plan_block case {name}: mask equal "
                  f"{torch.equal(got[0], plain[0])}, kv_any equal "
                  f"{torch.equal(got[3], plain[3])}")
        ties = _near_tie_rows(name, scores, kw["scale"], w, s_thr, plain, got)
        votes = K.spls_plan_block(scores, votes_only=True, **kw)
        vplain = spls_plan_block_plain(scores, votes_only=True, **kw)
        if votes[:3] != (None, None, None) or \
                not torch.equal(votes[3], vplain[3]):
            _fail(f"spls_plan_block case {name}: the votes-only kv_any "
                  f"differs from the plain version's")
        lead = got[2].reshape(shape[0], -1, shape[3])
        ffn, ffn_p = K.spls_mfi(lead, w, f_thr), \
            mfi_ffn_sparsity(lead, w, f_thr)
        if not all(torch.equal(a, b) for a, b in zip(ffn, ffn_p)):
            _fail(f"spls_mfi case {name}: differs from mfi_ffn_sparsity on "
                  f"the same leaders")
        out.append({"case": name, "shape": list(shape), "w": w, "k": k,
                    "row0": row0, "n_valid_rows": valid, "n_cols": n_cols,
                    "near_tie_rows": ties, "rows": plain[1].numel(),
                    "critical": int(plain[1].sum())})
        del scores, got, plain, votes, vplain
    print(json.dumps({"spls_plan_cases": out}))

    # timed at A's middle chunk
    shape, Dh, k, row0, valid, n_cols = cases["cell_a_middle"]
    kw = dict(scale=Dh ** -0.5, k=k, row0=row0, n_valid_rows=valid,
              n_cols=n_cols, causal=True, w=w, s_threshold=s_thr)
    n_heads, C, S = shape[1] * shape[2], shape[3], shape[4]
    in_bytes = 4 * n_heads * C * S
    sets = [(_plan_scores(shape, w, gen),) for _ in range(_n_sets(in_bytes))]
    plan = lambda x: K.spls_plan_block(x, **kw)
    t = {"ms": _time_ms(plan, sets),
         "plain_ms": _time_ms(lambda x: spls_plan_block_plain(x, **kw),
                              sets, reps=3, inner=5),
         "kernel_ms": _device_ms(plan, sets, "spls_plan_kernel")}
    # scores read, mask and kv_any written
    byte_s = (in_bytes + n_heads * C * S + n_heads * S) / HBM_BYTES_PER_S
    common = {"route": "cuda", "source": "src/repro_torch/csrc/spls_plan.cu",
              "replaces": "none: the reference's XLA ops"}
    plan_row = {"name": "spls_plan_block", **common,
                "near_tie_rows": sum(c["near_tie_rows"] for c in out),
                "shape": {"B": shape[0], "KV": shape[1], "G": shape[2],
                          "C": C, "S": S, "w": w, "k": k},
                "tolerance": "mask, kv_any exact; is_critical / leader "
                             "exact but at near-ties (1e-6 x max(1, s))",
                **t, "bound_ms": 1e3 * byte_s, "bound_by": "bytes",
                "cases": out}
    leads = [(K.spls_plan_block(x, **kw)[2].reshape(1, n_heads, C),)
             for (x,) in sets]
    mfi = lambda x: K.spls_mfi(x, w, f_thr)
    t = {"ms": _time_ms(mfi, leads),
         "plain_ms": _time_ms(lambda x: mfi_ffn_sparsity(x, w, f_thr),
                              leads),
         "kernel_ms": _device_ms(mfi, leads, "spls_mfi_kernel")}
    # leaders read; is_critical, leader, votes written
    byte_s = (4 * n_heads * C + 9 * C) / HBM_BYTES_PER_S
    mfi_row = {"name": "spls_mfi", **common,
               "shape": {"B": 1, "H": n_heads, "L": C, "w": w, "f": f_thr},
               "tolerance": "exact", **t, "bound_ms": 1e3 * byte_s,
               "bound_by": "bytes"}
    return [plan_row, mfi_row]


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


def _serve_run(K, Engine, cfg, params, scfg, prompts=None, max_new=16):
    """A warm-up engine (library handles, first launches), then a fresh
    engine on the warm process serves the requests (default: the 8 prompts
    of 384 tokens, 16 new tokens each); the launch counts are set to 0 just
    before the run and read just after it."""
    from repro_torch.serving import Request

    warm = Engine(cfg, params, scfg)
    warm.submit(Request(rid=-1, prompt=np.arange(128, dtype=np.int32),
                        max_new_tokens=2))
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, scfg)
    prompts = _prompts(cfg.vocab_size) if prompts is None else prompts
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
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
               plain_scfg, must_launch, extra=None, prompts=None,
               max_new=16, agree="first") -> tuple:
    """Serve the requests through the kernels, check that every kernel of
    this path was launched, then serve them again through the plain
    backends on the card (which launch no kernel).  ``agree`` is what must
    equal the plain backends' tokens: ``"first"`` every request's first
    token, ``"all"`` every token (the float32 model families), ``None``
    nothing (bf16: the mismatches are reported).  Returns this path's
    launch counts and the kernel run's tokens."""
    eng, reqs, wall, launches, peak = _serve_run(K, Engine, cfg, params,
                                                 scfg, prompts, max_new)
    zero = [k for k in must_launch if launches[k] == 0]
    if zero:
        _fail(f"kernels never launched on the {path} path: {zero}")
    st = eng.stats
    n_tok = sum(len(r.output) for r in reqs)
    report = {"serve": path, "requests": len(reqs),
              "prompt_tokens": len(reqs[0].prompt),
              "new_tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
              "peak_pages": st.get("peak_pages"),
              "preemptions": st.get("preemptions"),
              "flops_saved_pct": st["flops_saved_pct"],
              "peak_device_bytes": peak, "launches": launches}
    report.update(extra(eng, launches, wall) if extra else {})
    print(json.dumps(report, default=str))

    _, reqs_p, wall_p, launches_p, _ = _serve_run(
        K, Engine, plain_cfg, params, plain_scfg, prompts, max_new)
    if any(_backend_launches(launches_p).values()):
        _fail(f"the plain backends of the {path} path launched kernels: "
              f"{launches_p}")
    first_bad = [r.rid for r, p in zip(reqs, reqs_p)
                 if r.output[:1] != p.output[:1]]
    all_bad = [r.rid for r, p in zip(reqs, reqs_p) if r.output != p.output]
    same = sum(a == b for r, p in zip(reqs, reqs_p)
               for a, b in zip(r.output, p.output))
    print(json.dumps({
        "serve": path,
        "plain_backends": [plain_cfg.attn_backend, plain_scfg.attn_backend],
        "plain_compute": plain_scfg.compute_backend, "wall_s": wall_p,
        "first_token_mismatch": first_bad,
        "token_agreement": f"{same}/{n_tok}", "must_agree": agree,
        "note": "SPLS thresholds can turn a float32 last-bit difference "
                "into another plan, so tokens after the first may differ"},
        default=str))
    bad = {"first": first_bad, "all": all_bad, None: []}[agree]
    if bad:
        _fail(f"{path}: tokens ({agree}) differ from the plain backends for "
              f"requests {bad}")
    return launches, [list(r.output) for r in reqs]


def _chunk_stats(n_layers: int):
    """The paged paths' extra report: chunks, capacity picks, launches a
    chunk and decode ticks."""
    def stats(eng, launches, wall=None):
        st = eng.stats
        chunks = st["prefill_chunks"]
        out = {"prefill_chunks": chunks, "compute_backend":
               st["compute_backend"]}
        for cap in ("capacity_q", "capacity_ffn", "capacity_kv"):
            if cap in st:
                out[cap] = st[cap]
        for name in ("gathered_matmul", "gather_rows"):
            if launches[name]:
                out[f"{name}_per_chunk"] = launches[name] / chunks
        out["paged_flash_decode_ticks"] = \
            launches["paged_flash_decode"] / n_layers
        return out
    return stats


def horizon_report(eng, launches, wall) -> dict:
    """Path (h)'s checks on the drained engine: the packed K/V projection
    launched ``gathered_matmul`` twice a layer and chunk beside Q and the
    FFN; ``serving_report`` written to a temporary file, read back and
    validated by the port's ``validate_report`` with nonzero FLOPs saved in
    all four components.  Prints the latency percentiles and the shares."""
    import tempfile

    from repro_torch.observability import (serving_report, validate_report,
                                           write_report)

    cfg, st = eng.cfg, eng.stats
    per_layer = 3 + int(cfg.spls.ffn_sparsity)     # Q, K, V (+ FFN up)
    want = st["prefill_chunks"] * cfg.n_layers * per_layer
    if launches["gathered_matmul"] != want:
        _fail(f"horizon path: gathered_matmul launched "
              f"{launches['gathered_matmul']} times, expected {want} (Q, K, "
              f"V and the FFN of {cfg.n_layers} layers x "
              f"{st['prefill_chunks']} chunks)")
    report = serving_report(eng, wall_s=wall)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "BENCH_serving.json"
        write_report(str(path), report)
        report = json.loads(path.read_text())
    validate_report(report, require_nonzero_flops=True)
    lat = report["latency"]
    sp = report["sparsity"]
    print(json.dumps({
        "serve_report": "causal_paged_horizon1_packed",
        "schema_version": report["schema_version"],
        **{f"{k}_p50": lat[k]["p50"] for k in ("ttft_ms", "tpot_ms",
                                              "e2e_ms")},
        **{f"{k}_p99": lat[k]["p99"] for k in ("ttft_ms", "tpot_ms",
                                              "e2e_ms")},
        **{k: v for k, v in sp.items() if k.startswith("flops_saved")},
        "kept_ratio": sp.get("kept_ratio"),
        "horizon_finalized_cols": sp.get("horizon_finalized_cols"),
        "horizon_kv_capacity_drops": sp.get("horizon_kv_capacity_drops"),
        "throughput": report["throughput"]}, default=str))
    return {"kept_ratio_mean": sp["kept_ratio"]["mean"]}


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

    chunk_stats = _chunk_stats(causal.n_layers)

    paths["causal_paged_chunked"], _ = serve_path(
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

    # f. the same model without SPLS: the non-SPLS chunk step (plain
    # torch attention over the pages, as in the reference), paged decode.
    # The baseline SPLS pruning is measured against
    nospls = dataclasses.replace(
        causal, spls=dataclasses.replace(causal.spls, enabled=False))
    paths["causal_paged_chunked_nospls"], _ = serve_path(
        K, "causal_paged_chunked_nospls: bert-base-esact causal, no SPLS, "
           "dense + cuda_paged_decode", PagedServingEngine, params, nospls,
        ServeConfig(compute_backend="dense",
                    attn_backend="cuda_paged_decode", **base),
        nospls,
        ServeConfig(compute_backend="dense",
                    attn_backend="torch_paged_decode", **base),
        ("paged_flash_decode",), chunk_stats)

    # g. SPLS as in (a) on the reference's default simulation-mode compute
    paths["causal_paged_chunked_spls_dense"], _ = serve_path(
        K, "causal_paged_chunked_spls_dense: bert-base-esact causal, SPLS, "
           "dense + cuda_paged_decode", PagedServingEngine, params, causal,
        ServeConfig(compute_backend="dense",
                    attn_backend="cuda_paged_decode", **base),
        causal,
        ServeConfig(compute_backend="dense",
                    attn_backend="torch_paged_decode", **base),
        ("paged_flash_decode",), chunk_stats)

    # h. vote_horizon 1 with the packed K/V projection, at the knobs of the
    # reference's CI telemetry job (k 0.05, s 0.9, prune vote 1.0, capacity
    # margin 1.0), with the serving report
    horizon = dataclasses.replace(causal, spls=dataclasses.replace(
        causal.spls, k_ratio=0.05, s_threshold=0.9))
    hbase = dict(base, vote_horizon=1, spls_prune_vote=1.0,
                 capacity_margin=1.0)
    paths["causal_paged_horizon1_packed"], _ = serve_path(
        K, "causal_paged_horizon1_packed: bert-base-esact causal, SPLS, "
           "vote_horizon 1, packed_cuda + cuda_paged_decode",
        PagedServingEngine, params, horizon,
        ServeConfig(compute_backend="packed_cuda",
                    attn_backend="cuda_paged_decode", **hbase),
        horizon,
        ServeConfig(compute_backend="packed_torch",
                    attn_backend="torch_paged_decode", **hbase),
        ("gathered_matmul", "gather_rows", "paged_flash_decode"),
        lambda eng, launches, wall: {
            **chunk_stats(eng, launches),
            **horizon_report(eng, launches, wall)})
    del params

    # 2. the published non-causal encoder: whole-prompt prefill.  The
    # ServeConfig names one site's backend, the model config the other's
    params = init_params(CONFIG, seed=SEED)
    on = lambda name: dataclasses.replace(CONFIG, attn_backend=name)
    per_layer = lambda name: (lambda eng, launches, wall: {
        f"{name}_per_layer": launches[name] / CONFIG.n_layers})
    paths["noncausal_paged_full_prefill"], _ = serve_path(
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
    paths["noncausal_dense_engine"], _ = serve_path(
        K, "noncausal_dense_engine: bert-base-esact (non-causal), SPLS, "
           "cuda_flash + cuda_flash_decode", ServingEngine, params,
        on("cuda_flash"), ServeConfig(attn_backend="cuda_flash_decode",
                                      **dense),
        on("torch_flash"), ServeConfig(attn_backend="torch_flash_decode",
                                       **dense),
        ("flash_attention", "flash_decode"), per_layer("flash_decode"))
    return paths


def serve_bf16(K) -> dict:
    """The smoke form of the paper's BERT-Base (2 x 64, 4 heads, Dh 16,
    vocab 256) with ``compute_dtype="bfloat16"``, on the three engine paths
    of phase 3 (causal chunked paged with ``packed_cuda``, non-causal
    whole-prompt paged, the dense engine): 4 requests of 48 tokens, 8 new
    each, through the kernels and then through the plain backends.  Every
    kernel of a path must launch and every request finish; the greedy-token
    mismatches against the plain backends are reported (bf16 rounds the
    two routes' float32 sums at other places, and SPLS thresholds can turn
    that into another plan), not failed."""
    from repro_torch.configs.bert_base_esact import CONFIG
    from repro_torch.models import init_params
    from repro_torch.serving import (PagedServingEngine, Request,
                                     ServeConfig, ServingEngine)

    cfg = dataclasses.replace(CONFIG.smoke(), compute_dtype="bfloat16")
    causal = dataclasses.replace(
        cfg, causal=True, spls=dataclasses.replace(cfg.spls, causal=True))
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, 48).astype(np.int32)
               for _ in range(4)]
    paged = dict(n_slots=2, page_size=8, prefill_chunk=16, max_len=64,
                 vote_horizon=None, spls_prune_vote=0.5)
    on = lambda c, name: dataclasses.replace(c, attn_backend=name)
    paths = [
        ("causal_paged_chunked", PagedServingEngine, causal, causal,
         ServeConfig(compute_backend="packed_cuda",
                     attn_backend="cuda_paged_decode", **paged),
         ServeConfig(compute_backend="packed_torch",
                     attn_backend="torch_paged_decode", **paged),
         ("gathered_matmul", "gather_rows", "paged_flash_decode")),
        ("noncausal_paged_full_prefill", PagedServingEngine, cfg,
         on(cfg, "torch_flash"),
         ServeConfig(compute_backend="packed_cuda",
                     attn_backend="cuda_flash", **paged),
         ServeConfig(compute_backend="packed_torch",
                     attn_backend="torch_paged_decode", **paged),
         ("flash_attention", "paged_flash_decode")),
        ("noncausal_dense_engine", ServingEngine, on(cfg, "cuda_flash"),
         on(cfg, "torch_flash"),
         ServeConfig(attn_backend="cuda_flash_decode", n_slots=2,
                     max_len=64),
         ServeConfig(attn_backend="torch_flash_decode", n_slots=2,
                     max_len=64),
         ("flash_attention", "flash_decode"))]
    report = {}
    for name, Engine, kcfg, pcfg, kscfg, pscfg, must in paths:
        outs, launches = [], []
        params = init_params(kcfg, seed=SEED)
        for c, sc in ((kcfg, kscfg), (pcfg, pscfg)):
            eng = Engine(c, params, sc)
            reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            K.reset_launch_counts()
            eng.run_until_drained(max_ticks=2000)
            torch.cuda.synchronize()
            launches.append(K.launch_counts())
            if not all(r.done for r in reqs):
                _fail(f"bf16 {name}: requests not done")
            outs.append([list(r.output) for r in reqs])
        zero = [k for k in must if launches[0][k] == 0]
        if zero or any(_backend_launches(launches[1]).values()):
            _fail(f"bf16 {name}: kernels {zero} never launched, or the "
                  f"plain backends launched {launches[1]}")
        got, ref = outs
        n_tok = sum(len(o) for o in got)
        same = sum(x == y for a, b in zip(got, ref) for x, y in zip(a, b))
        report[name] = {
            "new_tokens": n_tok,
            "first_token_mismatch": [i for i, (a, b) in enumerate(
                zip(got, ref)) if a[:1] != b[:1]],
            "token_agreement": f"{same}/{n_tok}",
            "launches": {k: v for k, v in launches[0].items() if v}}
    print(json.dumps({"bf16_smoke": report, "config": cfg.name,
                      "compute_dtype": "bfloat16",
                      "note": "kernels against the plain backends on the "
                              "card; mismatches reported, not failed"}))
    return report


# ---------------------------------------------------------------------------
# phase 6: the model families at full width, paths (i)-(o)
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _full_width(arch_id: str, **kw):
    """An architecture of the registry at its published widths, with
    ``kw`` replaced (a cut depth, the compute dtype, SPLS)."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch_id), remat=False, **kw)


def _params(cfg):
    """Random weights from the seed, drawn on the card."""
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    print(json.dumps({
        "params": cfg.name, "n_layers": cfg.n_layers,
        "count": sum(t.numel() for t in leaves),
        "bytes": sum(t.numel() * t.element_size() for t in leaves),
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "init_s": time.perf_counter() - t0}))
    return params


def _free() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _random_prompts(vocab: int, n: int, length: int) -> list:
    rng = np.random.default_rng(SEED + length)
    return [rng.integers(0, vocab, length).astype(np.int32)
            for _ in range(n)]


class _MoECalls:
    """Counts the MoE FFN's calls by input shape (B, L) while on: the
    chunk step calls it at (1, chunk), the decode tick at (slots, 1)."""

    def __init__(self):
        from repro_torch.models import moe
        self.mod, self.orig, self.calls = moe, moe.moe_forward, {}

    def __enter__(self):
        def counted(cfg, p, x, capacity=None):
            key = f"{tuple(x.shape[:2])}"
            self.calls[key] = self.calls.get(key, 0) + 1
            return self.orig(cfg, p, x, capacity)
        self.mod.moe_forward = counted
        return self

    def __exit__(self, *exc):
        self.mod.moe_forward = self.orig


def _no_window(cfg):
    """``cfg`` with every block's window dropped: the control of the bf16
    logit checks (a kernel that ignored the window)."""
    return dataclasses.replace(cfg, period=tuple(
        dataclasses.replace(b, window=None) for b in cfg.period))


def _logit_err(got, ref) -> float:
    # one batch row at a time: a float32 copy of 4352 x 256000 logits is
    # 4.5 GB
    return max(float((g.float() - r.float()).abs().max())
               for g, r in zip(got, ref))


def _hold_logits(path: str, what: str, got, ref, n_ulps: int, row: dict,
                 control=None, control_name="control_window_dropped"
                 ) -> None:
    """Kernel route ``got`` against the plain route ``ref``: max |err|
    within ``n_ulps`` bf16 ulps of max |plain|.  A ``control`` (the kernel
    route with a fault: by default the window dropped) is reported beside
    the tolerance as ``control_name``."""
    err = _logit_err(got, ref)
    tol = n_ulps * float(_bf16_ulp(ref.abs().max()))
    agree = int((got[:, -1].float().argmax(-1)
                 == ref[:, -1].float().argmax(-1)).sum())
    row[what] = {"max_abs_err": err, "tolerance": tol,
                 "tolerance_rule": f"{n_ulps} bf16 ulp of max |plain|",
                 "last_argmax_agree": f"{agree}/{got.shape[0]}"}
    if control is not None:
        c_err = _logit_err(control, ref)
        row[what][control_name] = {
            "max_abs_err": c_err, "over_tolerance": c_err > tol}
    if not all(torch.isfinite(g).all() for g in got) or not err <= tol:
        _fail(f"{path}: bf16 {what} logits, kernels vs plain: max |err| "
              f"{err} > {tol} ({n_ulps} bf16 ulp of max |plain|)")


def _bf16_logits(path: str, params, cfg, prompts, paged=False) -> dict:
    """A bf16 model's logits through the kernels against the plain
    backends on the card, on the same inputs: ``prefill`` of the prompts
    as one batch (``cuda_flash`` / ``torch_flash``), held to 1 bf16 ulp of
    max |plain| (B4 equals its plain version before the cast); then one
    ``decode_step`` from each route's own cache on the plain route's
    greedy token (``cuda_flash_decode`` / ``torch_flash_decode``), held to
    4 ulps (B5's online softmax moves an attention output by one ulp, which
    the later layers carry).  With ``paged``, also one paged decode tick
    (``cuda_paged_decode`` / ``torch_paged_decode``) over the plain
    prefill's K/V scattered into pages, held to 4 ulps.  Where a block has
    a window, the kernel route runs once more with the windows dropped:
    that control's error is reported beside each tolerance."""
    from repro_torch.models import decode_step, prefill

    toks = torch.tensor(np.stack(prompts), device="cuda")
    B, L = toks.shape
    routes = ["torch", "cuda"]
    if any(b.window for b in cfg.period):
        routes.append("control")

    def on(route, kind):
        c = _no_window(cfg) if route == "control" else cfg
        name = "torch" if route == "torch" else "cuda"
        return c, f"{name}_{kind}"

    row = {"bf16_logits": path, "batch": [B, L]}
    logits, caches = {}, {}
    for r in routes:
        c, name = on(r, "flash")
        logits[r], caches[r] = prefill(
            dataclasses.replace(c, attn_backend=name), params, toks,
            max_len=L + 8)
    _hold_logits(path, "prefill", logits["cuda"], logits["torch"], 1, row,
                 logits.get("control"))
    nxt = logits["torch"][:, -1].float().argmax(-1)[:, None].to(torch.int32)
    del logits
    _free()
    pos = torch.full((B,), L, dtype=torch.int32, device="cuda")
    dec = {}
    for r in routes:
        c, name = on(r, "flash_decode")
        dec[r] = decode_step(dataclasses.replace(c, attn_backend=name),
                             params, caches[r], nxt, pos)[0]
    _hold_logits(path, "decode_step", dec["cuda"], dec["torch"], 4, row,
                 dec.get("control"))
    if paged:
        row.update(_paged_tick(path, params, cfg, caches["torch"], L, nxt,
                               pos, routes))
    print(json.dumps(row))
    del dec, caches
    _free()
    return row


def _paged_tick(path: str, params, cfg, dense_cache, L: int, nxt, pos,
                routes) -> dict:
    """One paged decode tick per route over the same page pool: the first
    ``L`` slots of each row of ``dense_cache`` (a plain ``prefill``'s)
    scattered into pages of 16, then ``paged_decode_step`` on ``nxt`` at
    ``pos`` (each route writes the token's K/V into slot ``L`` before it
    reads it)."""
    from types import SimpleNamespace

    from repro_torch.serving.paged_model import (paged_decode_step,
                                                 scatter_prefill)
    from repro_torch.serving.pager import init_paged_cache, init_pos_pages

    B, ps = nxt.shape[0], 16
    P = -(-(L + 1) // ps)
    cache = init_paged_cache(cfg, 1 + B * P, ps, "cuda")
    pos_pages = init_pos_pages(1 + B * P, ps, "cuda")
    # page 0 is the null page
    tables = (1 + torch.arange(B * P, dtype=torch.int32,
                               device="cuda")).view(B, P)
    keep = torch.arange(L, device="cuda")
    for b in range(B):
        flat = tables[b, keep // ps].long() * ps + keep % ps
        scatter_prefill(cache, pos_pages, tuple(
            SimpleNamespace(k=c.k[:, b:b + 1], v=c.v[:, b:b + 1])
            for c in dense_cache), keep, flat)
    kv_len = torch.full((B,), L, dtype=torch.int32, device="cuda")
    out = {}
    for r in routes:
        c = _no_window(cfg) if r == "control" else cfg
        name = "torch" if r == "torch" else "cuda"
        out[r] = paged_decode_step(c, params, cache, pos_pages, tables,
                                   kv_len, pos, nxt,
                                   backend=f"{name}_paged_decode")
    row = {}
    _hold_logits(path, "paged_decode_tick", out["cuda"], out["torch"], 4,
                 row, out.get("control"))
    return row


def families(K) -> dict:
    """The registry's model families at full width through the engines
    (random weights from the seed, drawn on the card), each through the
    kernels and through the plain backends: ``{path: launch counts}``."""
    from repro_torch.core.spls import SPLSConfig
    from repro_torch.serving import (PagedServingEngine, ServeConfig,
                                     ServingEngine)

    paths = {}
    base = dict(n_slots=4, page_size=16, prefill_chunk=64, max_len=512,
                spls_prune_vote=0.5)
    dense = dict(n_slots=4, max_len=512)
    on = lambda c, name: dataclasses.replace(c, attn_backend=name)
    per_layer = lambda name, n: (lambda eng, launches, wall: {
        f"{name}_per_layer": launches[name] / n})

    # i. qwen3-0.6b at full width and depth, float32 (published compute
    # bf16: a cut), the paper's SPLS knobs, packed compute: the main path
    t0 = time.perf_counter()
    qwen = _full_width("qwen3-0.6b", compute_dtype="float32",
                       spls=SPLSConfig(enabled=True, k_ratio=0.12,
                                       s_threshold=0.6, f_threshold=6,
                                       window=8, causal=True))
    params = _params(qwen)
    paths["qwen3_paged_spls"], _ = serve_path(
        K, "qwen3_paged_spls: qwen3-0.6b (28 x 1024, 16 heads, 8 KV heads, "
           "Dh 128, float32), SPLS, packed_cuda + cuda_paged_decode",
        PagedServingEngine, params, qwen,
        ServeConfig(compute_backend="packed_cuda",
                    attn_backend="cuda_paged_decode", **base),
        qwen,
        ServeConfig(compute_backend="packed_torch",
                    attn_backend="torch_paged_decode", **base),
        ("gathered_matmul", "gather_rows", "paged_flash_decode"),
        _chunk_stats(qwen.n_layers), agree="all")
    print(json.dumps({"phase_s": "qwen3_paged_spls",
                      "s": time.perf_counter() - t0}))

    # j. the same model without SPLS through the dense engine (B4, B5);
    # its tokens must equal a paged run's without SPLS
    t0 = time.perf_counter()
    nospls = dataclasses.replace(
        qwen, spls=dataclasses.replace(qwen.spls, enabled=False))
    paths["qwen3_dense_engine"], dense_tokens = serve_path(
        K, "qwen3_dense_engine: qwen3-0.6b, no SPLS, cuda_flash + "
           "cuda_flash_decode", ServingEngine, params,
        on(nospls, "cuda_flash"),
        ServeConfig(attn_backend="cuda_flash_decode", **dense),
        on(nospls, "torch_flash"),
        ServeConfig(attn_backend="torch_flash_decode", **dense),
        ("flash_attention", "flash_decode"),
        per_layer("flash_decode", qwen.n_layers), agree="all")
    paths["qwen3_paged_nospls"], paged_tokens = serve_path(
        K, "qwen3_paged_nospls: qwen3-0.6b, no SPLS, dense + "
           "cuda_paged_decode", PagedServingEngine, params, nospls,
        ServeConfig(compute_backend="dense",
                    attn_backend="cuda_paged_decode", **base),
        nospls,
        ServeConfig(compute_backend="dense",
                    attn_backend="torch_paged_decode", **base),
        ("paged_flash_decode",), _chunk_stats(qwen.n_layers), agree="all")
    same = sum(a == b for x, y in zip(dense_tokens, paged_tokens)
               for a, b in zip(x, y))
    print(json.dumps({"qwen3_dense_vs_paged_nospls":
                      f"{same}/{sum(map(len, dense_tokens))}"}))
    if dense_tokens != paged_tokens:
        _fail("qwen3: the dense engine's tokens differ from the paged "
              "engine's without SPLS")
    del params
    _free()
    print(json.dumps({"phase_s": "qwen3_dense_engine",
                      "s": time.perf_counter() - t0}))

    # k. olmoe-1b-7b at full width and depth (64 experts, top 8), float32
    # (published compute bf16: a cut), paged, no SPLS: MoE in the chunk
    # step and the decode tick
    t0 = time.perf_counter()
    olmoe = _full_width("olmoe-1b-7b", compute_dtype="float32")
    params = _params(olmoe)
    with _MoECalls() as moe:
        paths["olmoe_paged"], _ = serve_path(
            K, "olmoe_paged: olmoe-1b-7b (16 x 2048, 64 experts top 8, "
               "float32), no SPLS, dense + cuda_paged_decode",
            PagedServingEngine, params, olmoe,
            ServeConfig(compute_backend="dense",
                        attn_backend="cuda_paged_decode", **base),
            olmoe,
            ServeConfig(compute_backend="dense",
                        attn_backend="torch_paged_decode", **base),
            ("paged_flash_decode",), _chunk_stats(olmoe.n_layers),
            agree="all")
    print(json.dumps({"olmoe_moe_calls_by_shape": moe.calls}))
    if not {"(1, 64)", "(4, 1)"} <= set(moe.calls):
        _fail(f"olmoe: the MoE FFN did not run in both the chunk step and "
              f"the decode tick: {moe.calls}")
    del params
    _free()
    print(json.dumps({"phase_s": "olmoe_paged",
                      "s": time.perf_counter() - t0}))

    # l. gemma2-27b at full width, depth cut to one period (a local block,
    # window 4096, and a global one), bf16 as published: prompts of 4352
    # tokens so the window bites, through both engines, no SPLS
    t0 = time.perf_counter()
    gemma = _full_width("gemma2-27b", n_layers=2)
    params = _params(gemma)
    prompts = _random_prompts(gemma.vocab_size, 2, 4352)
    gpaged = dict(n_slots=2, page_size=16, prefill_chunk=256, max_len=4608)
    gdense = dict(n_slots=2, max_len=4608)
    paths["gemma2_window_paged"], _ = serve_path(
        K, "gemma2_window_paged: gemma2-27b (2 x 4608, window 4096, "
           "softcaps, bf16), no SPLS, dense + cuda_paged_decode",
        PagedServingEngine, params, gemma,
        ServeConfig(compute_backend="dense",
                    attn_backend="cuda_paged_decode", **gpaged),
        gemma,
        ServeConfig(compute_backend="dense",
                    attn_backend="torch_paged_decode", **gpaged),
        ("paged_flash_decode",), _chunk_stats(gemma.n_layers),
        prompts=prompts, max_new=8, agree=None)
    paths["gemma2_window_dense"], _ = serve_path(
        K, "gemma2_window_dense: gemma2-27b, no SPLS, cuda_flash + "
           "cuda_flash_decode", ServingEngine, params,
        on(gemma, "cuda_flash"),
        ServeConfig(attn_backend="cuda_flash_decode", **gdense),
        on(gemma, "torch_flash"),
        ServeConfig(attn_backend="torch_flash_decode", **gdense),
        ("flash_attention", "flash_decode"),
        per_layer("flash_decode", gemma.n_layers), prompts=prompts,
        max_new=8, agree=None)
    _bf16_logits("gemma2_window", params, gemma, prompts, paged=True)
    del params
    _free()
    print(json.dumps({"phase_s": "gemma2_window",
                      "s": time.perf_counter() - t0}))

    # m. mamba2-370m at full width and depth (bf16 compute as published):
    # the dense engine against a plain prefill + decode_step loop
    t0 = time.perf_counter()
    paths["mamba2_dense_engine"] = mamba2_loop(K, ServingEngine,
                                               ServeConfig)
    _free()
    print(json.dumps({"phase_s": "mamba2_dense_engine",
                      "s": time.perf_counter() - t0}))

    # n. jamba-v0.1-52b at full width, one period of 8 layers (Mamba, MoE
    # 16 experts top 2, attention at index 4), bf16 as published
    t0 = time.perf_counter()
    jamba = _full_width("jamba-v0.1-52b", n_layers=8)
    params = _params(jamba)
    prompts = _random_prompts(jamba.vocab_size, 4, 512)
    jdense = dict(n_slots=4, max_len=536)
    with _MoECalls() as moe:
        paths["jamba_hybrid"], _ = serve_path(
            K, "jamba_hybrid: jamba-v0.1-52b (8 x 4096, Mamba + MoE 16 "
               "experts top 2 + attention, bf16), cuda_flash + "
               "cuda_flash_decode", ServingEngine, params,
            on(jamba, "cuda_flash"),
            ServeConfig(attn_backend="cuda_flash_decode", **jdense),
            on(jamba, "torch_flash"),
            ServeConfig(attn_backend="torch_flash_decode", **jdense),
            ("flash_attention", "flash_decode"), prompts=prompts,
            agree=None)
    print(json.dumps({"jamba_moe_calls_by_shape": moe.calls}))
    _bf16_logits("jamba_hybrid", params, jamba, prompts[:2])
    del params
    _free()
    print(json.dumps({"phase_s": "jamba_hybrid",
                      "s": time.perf_counter() - t0}))

    # o. the launcher on every architecture of the registry; its launches
    # are reported, not counted as a path's: nothing holds its tokens
    # against the plain backends
    t0 = time.perf_counter()
    launcher_sweep(K)
    print(json.dumps({"phase_s": "launcher_sweep",
                      "s": time.perf_counter() - t0}))
    return paths


def mamba2_loop(K, ServingEngine, ServeConfig) -> dict:
    """Path (m): ``ServingEngine`` on mamba2-370m (4 prompts of 512 tokens,
    16 new each, 4 slots), then the same requests through a plain loop of
    ``prefill`` (one prompt at a time, spliced into a 4-row cache) and
    batched ``decode_step``, as the engine orders them: the tokens must be
    equal, and no kernel may launch (the model has no attention)."""
    from repro_torch.models import decode_step, init_cache, prefill

    cfg = _full_width("mamba2-370m")
    params = _params(cfg)
    prompts = _random_prompts(cfg.vocab_size, 4, 512)
    scfg = ServeConfig(n_slots=4, max_len=536)
    eng, reqs, wall, launches, peak = _serve_run(
        K, ServingEngine, cfg, params, scfg, prompts, 16)
    if any(launches.values()):
        _fail(f"mamba2: kernels launched on an attention-free model: "
              f"{launches}")
    n_tok = sum(len(r.output) for r in reqs)

    t0 = time.perf_counter()
    cache = init_cache(cfg, 4, scfg.max_len)
    outs = []
    for s, p in enumerate(prompts):
        toks = torch.tensor(p[None], device="cuda")
        logits, one = prefill(cfg, params, toks, max_len=scfg.max_len)
        for full, o in zip(cache, one):
            for f_full, f_one in zip(full, o):
                f_full[:, s:s + 1].copy_(f_one)
        outs.append([int(logits[0, -1].argmax())])
    pos = torch.full((4,), len(prompts[0]), dtype=torch.int32,
                     device="cuda")
    for _ in range(15):
        tok = torch.tensor([[o[-1]] for o in outs], dtype=torch.int32,
                           device="cuda")
        logits, cache = decode_step(cfg, params, cache, tok, pos)
        for o, t in zip(outs, logits[:, 0].argmax(-1).tolist()):
            o.append(int(t))
        pos += 1
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    got = [list(r.output) for r in reqs]
    same = sum(a == b for x, y in zip(got, outs) for a, b in zip(x, y))
    print(json.dumps({
        "serve": "mamba2_dense_engine: mamba2-370m (48 x 1024, state 128, "
                 "bf16 compute), ServingEngine (no kernel on this model)",
        "requests": 4, "prompt_tokens": len(prompts[0]), "new_tokens": n_tok,
        "wall_s": wall, "tok_per_s": n_tok / wall,
        "peak_device_bytes": peak, "loop_wall_s": loop_s,
        "tokens_vs_loop": f"{same}/{n_tok}"}))
    if got != outs:
        _fail("mamba2: the engine's tokens differ from the plain prefill + "
              "decode_step loop's")
    del params, cache
    return launches


def launcher_sweep(K) -> None:
    """Path (o): ``repro_torch.launch.serve.main`` on the card for every id
    of the registry, dense and with ``--paged --spls``: every run exits 0;
    where the reference's launcher serves, every request is done, and
    where it skips (embeddings input; ``--paged`` on Mamba archs), the same
    skip.  Then ``python -m repro_torch.launch.serve`` itself once, in its
    own process.  The sweep's summed launch counts are printed: no path
    counts them, since nothing holds the sweep's tokens against the plain
    backends."""
    import contextlib
    import io

    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.launch import serve as launch

    total = {}
    rows = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for extra in ([], ["--paged", "--spls"]):
            buf = io.StringIO()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = launch.main(["--arch", arch, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = K.launch_counts()
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            out = buf.getvalue()
            skips = cfg.input_mode != "tokens" or (extra and cfg.has_mamba)
            row = {"arch": arch, "args": " ".join(extra), "rc": rc,
                   "wall_s": wall,
                   "launches": {k: v for k, v in launches.items() if v}}
            if skips:
                row["skipped"] = out.strip()
                ok = rc == 0 and "skipping" in out
            else:
                res = json.loads(out)
                row.update(all_done=res["all_done"],
                           retired=res["retired"], pool=res.get("pool"))
                ok = rc == 0 and res["all_done"] and res["retired"] == 8
            rows.append(row)
            if not ok:
                _fail(f"launch.serve --arch {arch} {' '.join(extra)}: "
                      f"rc {rc}, output {out[-400:]!r}")
    src = str(Path(__file__).resolve().parent / "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen3-0.6b", "--paged", "--spls"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": src})
    sub = {"command": "python -m repro_torch.launch.serve --arch qwen3-0.6b "
                      "--paged --spls", "rc": proc.returncode,
           "wall_s": time.perf_counter() - t0}
    if proc.returncode != 0 or not json.loads(proc.stdout)["all_done"]:
        _fail(f"{sub['command']}: rc {proc.returncode}, "
              f"{proc.stdout[-400:]!r} {proc.stderr[-400:]!r}")
    print(json.dumps({"launcher_sweep": rows, "subprocess": sub,
                      "launches_not_counted": total}))


# ---------------------------------------------------------------------------
# phase 7: training, paths (p)-(r)
# ---------------------------------------------------------------------------

def _train_flops(cfg, tokens: int, L: int) -> float:
    """Model FLOPs of one training step, counted from the config: 6 x the
    parameters that enter a product x tokens (a tied embedding counts once,
    as the head; the lookup and the norms are no product), plus the
    attention products, 12 x layers x heads x Dh x L per token (all L x L
    scores: ``torch_dense`` computes every one).  Remat's extra forward
    is not counted."""
    D, V = cfg.d_model, cfg.vocab_size
    n_mm = cfg.param_count() - (0 if cfg.tied_embeddings else V * D) \
        - (2 * D * cfg.n_periods * len(cfg.period) + D)
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.resolved_head_dim * L
    return 6.0 * n_mm * tokens + float(attn) * tokens


def _grad_check(cfg, params, batch, n_micro: int) -> dict:
    """``make_loss_grad`` once: every gradient leaf finite with a norm
    above 0 (a leaf without a gradient would show 0)."""
    from repro_torch.launch.steps import make_loss_grad
    from repro_torch.tree import leaf_id, leaves_with_path

    t0 = time.perf_counter()
    grads, metrics = make_loss_grad(cfg, n_micro)(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    norms = {leaf_id(p): float(g.float().norm())
             for p, g in leaves_with_path(grads)}
    bad = [k for k, v in norms.items() if not (math.isfinite(v) and v > 0)]
    if bad:
        _fail(f"qwen3_train: gradient leaves not finite or zero: {bad}")
    return {"loss": float(metrics["loss"]), "wall_s": wall,
            "grad_leaves": len(norms), "min_grad_norm": min(norms.values()),
            "max_grad_norm": max(norms.values())}


def _serve_trained(K, cfg, params, prompts, n_new: int) -> dict:
    """Path (p)'s tail: the trained weights through ``make_prefill_step``
    / ``make_serve_step`` on the kernels (``"pallas_flash"`` /
    ``"pallas_flash_decode"``: B4, B5) against the plain backends
    (``torch_flash`` / ``torch_flash_decode``), each route from its own
    cache on the plain route's greedy tokens: prefill logits within 1 bf16
    ulp of max |plain|, each decode step within 4.  The control is the
    kernel route with a window of L - 1 (the last prompt row loses its
    oldest key, a decode step its oldest pos - L + 2 keys)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    B, L = prompts.shape
    ctrl = dataclasses.replace(cfg, period=tuple(
        dataclasses.replace(b, window=L - 1) for b in cfg.period))
    routes = {"plain": (cfg, "torch_flash", "torch_flash_decode"),
              "kernel": (cfg, "pallas_flash", "pallas_flash_decode"),
              "control": (ctrl, "pallas_flash", "pallas_flash_decode")}
    out, toks, launches = {}, [], {}
    for name, (c, fwd, dec) in routes.items():
        prefill_step = make_prefill_step(c, fwd)
        serve_step = make_serve_step(c, dec)
        if name == "kernel":
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
        logits, cache = prefill_step(params, prompts, max_len=L + n_new)
        steps = [logits]
        pos = torch.full((B,), L, dtype=torch.int32, device=prompts.device)
        for s in range(n_new):
            if name == "plain":
                toks.append(steps[-1][:, -1].float().argmax(-1)[:, None]
                            .to(torch.int32))
            lg, cache = serve_step(params, cache, toks[s], pos)
            steps.append(lg)
            pos = pos + 1
        if name == "kernel":
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = K.launch_counts()
        out[name] = steps
        del cache
    row = {"serve_trained": "qwen3-0.6b trained weights, make_prefill_step"
                            "('pallas_flash') + make_serve_step("
                            "'pallas_flash_decode') vs torch_flash / "
                            "torch_flash_decode",
           "batch": [B, L], "decode_steps": n_new, "kernel_wall_s": wall,
           "launches": {k: v for k, v in launches.items() if v}}
    ctrl_name = "control_oldest_keys_dropped"
    _hold_logits("qwen3_train", "prefill", out["kernel"][0],
                 out["plain"][0], 1, row, out["control"][0], ctrl_name)
    for s in range(1, n_new + 1):
        _hold_logits("qwen3_train", f"decode_step_{s}", out["kernel"][s],
                     out["plain"][s], 4, row, out["control"][s], ctrl_name)
    print(json.dumps(row))
    for k in ("flash_attention", "flash_decode"):
        if not launches.get(k):
            _fail(f"qwen3_train: the serve tail launched no {k}")
    return launches


def qwen3_train(K) -> dict:
    """Path (p), the slice's main path: qwen3-0.6b at full width and depth
    (float32 params, bf16 compute, remat on, as published) trained through
    ``Trainer`` on the synthetic ``lm`` task at ``train_4k``'s 4096 tokens,
    ``n_micro`` 8 (the config's microbatch), global batch 8 (cut from 256):
    4 steps with a checkpoint at step 2; a fresh ``Trainer`` restored from
    step 2 runs steps 3-4, held against the uninterrupted run.  No kernel
    may launch while training.  Then the trained weights serve through B4
    / B5 (:func:`_serve_trained`).  Returns the serve tail's launches, the
    median step time, the directory that holds the restored run's
    checkpoints (``b``, steps 2 and 4), which the caller removes, and the
    run's peak device bytes."""
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models import init_params
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    cfg = get_config("qwen3-0.6b")
    n_micro = cfg.microbatch["train_4k"]
    L = 4096
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=L + 1,
                      global_batch=8, seed=SEED)
    tokens = data.global_batch * L
    flops = _train_flops(cfg, tokens, L)
    tcfg = dict(total_steps=4, log_every=1, n_micro=n_micro, seed=SEED)
    row = {"train": "qwen3_train: qwen3-0.6b (28 x 1024, 16 heads, 8 KV "
                    "heads, Dh 128, vocab 151936, tied; float32 params, bf16 "
                    "compute, remat), Trainer, lm task",
           "seq_len": L, "global_batch": data.global_batch,
           "n_micro": n_micro, "tokens_per_step": tokens,
           "model_flops_per_step": flops, "params": cfg.param_count()}

    # every gradient leaf at step 0, on the weights the trainer starts from
    _free()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    params = init_params(cfg, seed=SEED)
    row["grad_check"] = _grad_check(cfg, params, synthetic_batch(data, 0),
                                    n_micro)
    del params
    _free()

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        a = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp / "a"),
                                       ckpt_every=2, **tcfg), data)
        t0 = time.perf_counter()
        out_a = a.run()
        row["run_wall_s"] = time.perf_counter() - t0
        row["disk_free_bytes"] = shutil.disk_usage(tmp).free
        row["steps"] = [{k: m[k] for k in ("step", "loss", "grad_norm",
                                           "lr", "step_time_s")}
                        for m in out_a["metrics"]]
        # the steps' card time: steps 2-4 (step 1 warms the process up)
        dt = statistics.median(m["step_time_s"]
                               for m in out_a["metrics"][1:])
        row.update(step_time_s=dt, tokens_per_s=tokens / dt,
                   model_flops_per_s=flops / dt,
                   peak_device_bytes=torch.cuda.max_memory_allocated())
        loss0 = out_a["metrics"][0]["loss"]
        if abs(loss0 - math.log(cfg.vocab_size)) > 0.5:
            _fail(f"qwen3_train: step 0 loss {loss0} is not within 0.5 of "
                  f"ln V = {math.log(cfg.vocab_size)}")

        # a fresh trainer from the step-2 checkpoint runs steps 3-4
        (tmp / "b").mkdir()
        shutil.copytree(tmp / "a" / "step_000000002",
                        tmp / "b" / "step_000000002")
        shutil.rmtree(tmp / "a")
        b = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp / "b"),
                                       ckpt_every=4, **tcfg), data)
        b.restore_or_init()
        if b.step != 2 or int(b.opt_state.count) != 2:
            _fail(f"qwen3_train: restored step {b.step}, count "
                  f"{int(b.opt_state.count)}, expected 2")
        out_b = b.run()
        launches = K.launch_counts()
        if any(launches.values()):
            _fail(f"qwen3_train: kernels launched while training: "
                  f"{launches}")
        sched = warmup_cosine(b.tcfg.peak_lr, b.tcfg.warmup_steps, 4)
        p_tol = 2 * (sched(2) + sched(3))
        diffs = [(x.float() - y.float()).abs() for x, y in
                 zip(leaves(a.params), leaves(b.params))]
        p_err = max(float(d.max()) for d in diffs)
        changed = sum(int((d > 0).sum()) for d in diffs)
        del diffs
        la = [m["loss"] for m in out_a["metrics"][2:]]
        lb = [m["loss"] for m in out_b["metrics"]]
        row["restored"] = {
            "losses_uninterrupted": la, "losses_restored": lb,
            "loss_tolerance": "step 3: 1e-6 x loss (the same forward on "
                              "the same restored bits); step 4: 1e-3 x loss",
            "params_max_abs_err": p_err,
            "params_elements_differing": changed,
            "params_tolerance": p_tol,
            "params_tolerance_rule": "2 x (lr at counts 2 and 3): Adam "
                                     "moves an element by at most lr a "
                                     "step"}
        if not (abs(la[0] - lb[0]) <= 1e-6 * abs(la[0])
                and abs(la[1] - lb[1]) <= 1e-3 * abs(la[1])
                and p_err <= p_tol):
            _fail(f"qwen3_train: the restored run differs from the "
                  f"uninterrupted one: {row['restored']}")
        del b
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    row["device"] = _smi()
    print(json.dumps(row))
    _free()

    prompts = synthetic_batch(dataclasses.replace(
        data, seq_len=513, global_batch=2, seed=SEED + 1), 0)["inputs"]
    launches = _serve_trained(K, cfg, a.params, prompts, 8)
    del a
    _free()
    return launches, dt, tmp, row["peak_device_bytes"]


class _Plans:
    """While on, ``blocks.build_block_plan`` records each plan it builds
    into ``record`` (and, given ``inputs``, each call's block params and
    normalized input); with ``feed``, it returns the next plan of ``feed``
    (moved to the input's device) instead of building one."""

    def __init__(self, record: list, feed=None, inputs=None):
        from repro_torch.models import blocks
        self.blocks, self.record, self.feed = blocks, record, feed
        self.inputs = inputs

    def __enter__(self):
        self.orig = build = self.blocks.build_block_plan

        def plan(cfg, p, xn):
            if self.inputs is not None:
                self.inputs.append((p, xn.detach()))
            if self.feed is None:
                got = build(cfg, p, xn)
            else:
                got = self.feed.pop(0)
                got = type(got)(*(f.to(xn.device) for f in got))
            self.record.append(got)
            return got

        self.blocks.build_block_plan = plan
        return self

    def __exit__(self, *exc):
        self.blocks.build_block_plan = self.orig


# a top-k split is a near-tie when the scores it swapped lie within the
# PAM's tolerance (PERF.md: rtol = atol = 1e-5) of the row's k-th score
PAM_TIE = 1e-5


def _plan_split_report(cfg, card_plans, cpu_plans, card_in, cpu_in) -> dict:
    """C1's attribution of the card's own SPLS plans against the CPU's:
    differing entries per layer and field; for layer 0, max |xn_card -
    xn_cpu|, the CPU's plan on the card's own xn (which separates the
    inputs' share from the ops'), and at every differing row of the
    attention mask the predicted-score gap between the swapped columns and
    the row's k-th score, on each device's own PAM."""
    from repro_torch.core.planner import PlanContext
    from repro_torch.core.topk import topk_count

    per_layer = [{f: int((a.cpu() != b).sum())
                  for f, a, b in zip(pa._fields, pa, pb)}
                 for pa, pb in zip(card_plans, cpu_plans)]
    ctx = PlanContext.for_config(cfg)
    (p_card, xn_card), (p_cpu, xn_cpu) = card_in[0], cpu_in[0]
    L = xn_cpu.shape[1]

    def pam(p, xn):
        qh, kh = ctx.predict_heads(p["attn"], xn, act_axis=None)
        s = torch.matmul(qh, kh[:, :, None].transpose(-1, -2)) \
            * ctx.Dh ** -0.5
        if ctx.scfg.causal:
            tri = torch.ones((L, L), dtype=torch.bool, device=s.device).tril()
            s = s.masked_fill(~tri, torch.finfo(s.dtype).min / 2)
        return s.cpu()

    with torch.no_grad():
        pam_cpu, pam_card = pam(p_cpu, xn_cpu), pam(p_card, xn_card)
        on_card_xn = ctx.plan_exact(p_cpu["attn"], xn_card.cpu())
    k = topk_count(L, ctx.scfg.k_ratio)
    diff = card_plans[0].attn_mask.cpu() != cpu_plans[0].attn_mask
    splits = []
    for row in diff.any(-1).nonzero().tolist():
        r = tuple(row)
        cols = diff[r].nonzero().flatten()
        gaps = []
        for scores in (pam_cpu[r], pam_card[r]):
            kth = torch.sort(scores, descending=True,
                             stable=True).values[k - 1]
            gaps.append((float((scores[cols] - kth).abs().max()),
                         PAM_TIE * max(1.0, abs(float(kth)))))
        splits.append({"row": row, "cols": cols.tolist(),
                       "gap_cpu": gaps[0][0], "gap_card": gaps[1][0],
                       "tolerance": gaps[0][1],
                       "near_tie": all(g <= tol for g, tol in gaps)})
    return {"per_layer": per_layer,
            "layer0_xn_max_abs_diff": float((xn_card.cpu() - xn_cpu)
                                            .abs().max()),
            "layer0_card_vs_cpu_plan_on_card_xn": {
                f: int((a.cpu() != b).sum()) for f, a, b in
                zip(on_card_xn._fields, card_plans[0], on_card_xn)},
            "layer0_mask_splits": splits}


def _rel_err(grads, ref) -> float:
    """Max over leaves of max |grads - ref| / max |ref| (on the host)."""
    from repro_torch.tree import leaves

    out = 0.0
    for a, r in zip(leaves(grads), leaves(ref)):
        a, r = a.float().cpu(), r.float().cpu()
        out = max(out, float((a - r).abs().max())
                  / (float(r.abs().max()) or 1.0))
    return out


def train_smoke_cpu_vs_card(K) -> None:
    """Path (q): ``make_loss_grad`` on the float32 smoke forms of
    qwen3-0.6b and olmoe-1b-7b, without and with the training launcher's
    SPLS knobs, on the card and on the CPU from the same weights and
    batch (8 x 64 tokens): loss rtol 1e-5, every gradient leaf within 1e-4
    x max |CPU grad|.  With SPLS, the CPU's plans are fed to the card run
    (a near-tie of the predicted scores may plan otherwise on the card;
    the entries where the card's own plans differ are reported).  Remat on
    is held against remat off on the card, each with the card's own plans,
    within 1e-5 x max |grad| (the plan rebuilt in the recompute, on
    autograd's own thread, must be the forward's).  Then the refusal: a
    ``cuda_flash`` forward on tensors that require grad must raise."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.launch.steps import make_loss_grad
    from repro_torch.launch.train import train_config
    from repro_torch.models import init_params
    from repro_torch.models.attn_backend import get_backend
    from repro_torch.tree import leaves, tree_map

    rows = []
    K.reset_launch_counts()
    for arch in ("qwen3-0.6b", "olmoe-1b-7b"):
        for spls in (False, True):
            cfg = train_config(arch, spls=spls)
            params = init_params(cfg, seed=SEED, device="cpu")
            batch = synthetic_batch(DataConfig(
                vocab_size=cfg.vocab_size, seq_len=65, global_batch=8,
                seed=SEED), 0, "cpu")
            card = lambda tree: tree_map(lambda x: x.to("cuda"), tree)
            cpu_plans, card_plans, cpu_in, card_in = [], [], [], []
            with _Plans(cpu_plans, inputs=cpu_in):
                g_cpu, m_cpu = make_loss_grad(cfg)(params, batch)
            with _Plans(card_plans, inputs=card_in):
                g_own, m_own = make_loss_grad(cfg)(card(params),
                                                   card(batch))
            g_remat, _ = make_loss_grad(dataclasses.replace(
                cfg, remat=True))(card(params), card(batch))
            g_card, m_card = g_own, m_own
            plan_diff, splits = 0, None
            if spls:
                plan_diff = sum(int((a.cpu() != b).sum()) for pa, pb in
                                zip(card_plans, cpu_plans)
                                for a, b in zip(pa, pb))
                splits = _plan_split_report(cfg, card_plans, cpu_plans,
                                            card_in, cpu_in)
                print(json.dumps({"c1_plan_splits": arch, **splits}))
                layer0 = sum(splits["per_layer"][0].values())
                wide = [x for x in splits["layer0_mask_splits"]
                        if not x["near_tie"]]
                if wide:
                    _fail(f"{arch}: layer-0 plan splits that are not "
                          f"near-ties (PAM gap > {PAM_TIE} x max(1, |k-th "
                          f"score|)): {wide}")
                if splits["layer0_xn_max_abs_diff"] == 0.0 and layer0:
                    _fail(f"{arch}: layer 0's inputs are equal on both "
                          f"devices and its plans still differ in {layer0} "
                          f"entries: {splits['per_layer'][0]}")
                with _Plans([], feed=list(cpu_plans)):
                    g_card, m_card = make_loss_grad(cfg)(card(params),
                                                         card(batch))
            row = {"arch": arch, "spls": spls,
                   "loss_cpu": float(m_cpu["loss"]),
                   "loss_card": float(m_card["loss"]),
                   "grad_max_rel_err": _rel_err(g_card, g_cpu),
                   "remat_vs_no_remat_max_rel_err": _rel_err(g_remat,
                                                             g_own),
                   "card_own_plan_entries_differing": plan_diff,
                   "grad_leaves": len(leaves(g_cpu))}
            rows.append(row)
            if not (abs(row["loss_card"] - row["loss_cpu"])
                    <= 1e-5 * abs(row["loss_cpu"])
                    and row["grad_max_rel_err"] <= 1e-4
                    and row["remat_vs_no_remat_max_rel_err"] <= 1e-5):
                _fail(f"train_smoke_cpu_vs_card: {row}")
    launches = K.launch_counts()
    if any(launches.values()):
        _fail(f"train_smoke_cpu_vs_card: kernels launched while training: "
              f"{launches}")

    # the refusal: a kernel forward that autograd would differentiate
    cfg = train_config("qwen3-0.6b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((1, 2, 2, 16, 16), device="cuda", generator=gen,
                    requires_grad=True)
    k = torch.randn((1, 2, 16, 16), device="cuda", generator=gen)
    refusal = None
    try:
        get_backend("cuda_flash")(cfg, q, k, k)
    except RuntimeError as e:
        refusal = str(e)
    if refusal is None or "no backward kernel" not in refusal or \
            K.launch_counts()["flash_attention"]:
        _fail(f"cuda_flash refusal: {refusal!r}, launches "
              f"{K.launch_counts()}")
    print(json.dumps({"train_smoke_cpu_vs_card": rows,
                      "refusal": refusal}))


def train_launcher_sweep(K) -> None:
    """Path (r): ``repro_torch.launch.train.main`` on the card for every id
    of the registry at its smoke form, 2 steps (the launcher's defaults:
    global batch 8, 64 tokens); qwen3-0.6b once more with ``--spls``; then
    ``python -m repro_torch.launch.train`` once in its own process.  Each
    run exits 0 with finite losses, and no kernel launches."""
    import contextlib
    import io

    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch import train as launch

    rows = []
    runs = [["--arch", a] for a in ARCH_IDS] + [["--arch", "qwen3-0.6b",
                                                 "--spls"]]
    for args in runs:
        buf = io.StringIO()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = launch.main(args + ["--steps", "2"])
        torch.cuda.synchronize()
        out = json.loads(buf.getvalue())
        row = {"args": " ".join(args), "rc": rc,
               "wall_s": time.perf_counter() - t0,
               "losses": [m["loss"] for m in out],
               "step_time_s": [m["step_time_s"] for m in out]}
        rows.append(row)
        if rc != 0 or not out or not all(map(math.isfinite,
                                             row["losses"])) \
                or any(K.launch_counts().values()):
            _fail(f"launch.train {row['args']}: {row}, launches "
                  f"{K.launch_counts()}")
    src = str(Path(__file__).resolve().parent / "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-0.6b", "--steps", "2"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": src})
    sub = {"command": "python -m repro_torch.launch.train --arch qwen3-0.6b "
                      "--steps 2", "rc": proc.returncode,
           "wall_s": time.perf_counter() - t0}
    if proc.returncode != 0 or not all(
            math.isfinite(m["loss"]) for m in json.loads(proc.stdout)):
        _fail(f"{sub['command']}: rc {proc.returncode}, "
              f"{proc.stdout[-400:]!r} {proc.stderr[-400:]!r}")
    print(json.dumps({"train_launcher_sweep": rows, "subprocess": sub}))


# ---------------------------------------------------------------------------
# phase 8: capacity-mode SPLS training, sampling, the ESACT model and the
# examples, paths (s)-(v)
# ---------------------------------------------------------------------------

# the reference's SPLS training configuration (repro/launch/dryrun.py)
TRAIN_SPLS = dict(enabled=True, k_ratio=0.12, s_threshold=0.6,
                  f_threshold=6, window=8, causal=True,
                  q_capacity_ratio=0.5, kv_capacity_ratio=0.75)
TRAIN_SPLS_L = 4096


class _Backends:
    """While on, records the forward backend each attention site
    resolves (``models.attention``'s ``get_backend`` calls)."""

    def __init__(self):
        from repro_torch.models import attention
        self.mod, self.orig, self.names = attention, attention.get_backend, []

    def __enter__(self):
        def get(name):
            self.names.append(name)
            return self.orig(name)
        self.mod.get_backend = get
        return self

    def __exit__(self, *exc):
        self.mod.get_backend = self.orig


def _attn_grad_norms(cfg, grads) -> dict:
    """{weight: [norm of each layer's gradient]} of the attention
    projections, on the host."""
    attn = grads["periods"][0]["attn"]
    return {w: [float(attn[w][i].float().norm())
                for i in range(cfg.n_periods)]
            for w in ("wq", "wk", "wv", "wo")}


def _packed_smoke_cpu_vs_card(K) -> dict:
    """(s)'s check at (q)'s size: ``make_loss_grad`` on qwen3-0.6b's
    float32 smoke form at q 0.5 / kv 0.75 of L, card against CPU, the
    CPU's plans fed to the card; loss rtol 1e-5, every leaf within 1e-4 x
    max |CPU grad|; every forward site on ``torch_packed``."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.launch.steps import make_loss_grad
    from repro_torch.launch.train import train_config
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map

    cfg = train_config("qwen3-0.6b", spls=True)
    cfg = dataclasses.replace(cfg, spls=dataclasses.replace(
        cfg.spls, q_capacity_ratio=0.5, kv_capacity_ratio=0.75))
    params = init_params(cfg, seed=SEED, device="cpu")
    batch = synthetic_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=65,
                                       global_batch=8, seed=SEED), 0, "cpu")
    card = lambda tree: tree_map(lambda x: x.to("cuda"), tree)
    plans = []
    with _Plans(plans), _Backends() as cpu_sites:
        g_cpu, m_cpu = make_loss_grad(cfg)(params, batch)
    K.reset_launch_counts()
    with _Plans([], feed=list(plans)), _Backends() as card_sites:
        g_card, m_card = make_loss_grad(cfg)(card(params), card(batch))
    row = {"arch": "qwen3-0.6b smoke, float32",
           "spls": dataclasses.asdict(cfg.spls),
           "loss_cpu": float(m_cpu["loss"]),
           "loss_card": float(m_card["loss"]),
           "grad_max_rel_err": _rel_err(g_card, g_cpu),
           "sites": sorted(set(cpu_sites.names + card_sites.names)),
           "launches": K.launch_counts()}
    if not (abs(row["loss_card"] - row["loss_cpu"])
            <= 1e-5 * abs(row["loss_cpu"]) and row["grad_max_rel_err"] <= 1e-4
            and row["sites"] == ["torch_packed"]
            and not any(row["launches"].values())):
        _fail(f"qwen3_train_spls_packed smoke, card vs CPU: {row}")
    return row


def qwen3_train_spls_packed(K, dense_step_s: float):
    """Path (s), the slice's main path: qwen3-0.6b at full width and depth
    (float32 params, bf16 compute, remat, as (p)) trained under the
    reference's SPLS training configuration (k 0.12, s 0.6, f 6, window 8,
    q capacity 0.5, kv capacity 0.75 of L) through ``Trainer`` on the
    synthetic ``lm`` task, ``TRAIN_SPLS_L`` tokens, global batch 8,
    ``n_micro`` 8, 2 steps (the script's time limit): every forward
    attention call resolves
    ``torch_packed`` (28 sites x 8 micro-batches x 2, remat's recompute),
    step 1's gradient of every attention weight of every layer is finite
    and nonzero, every loss finite, no kernel launch; step time, tokens/s,
    peak memory beside (p)'s dense step.  Then the smoke form, card
    against CPU (:func:`_packed_smoke_cpu_vs_card`).  Returns the trained
    parameters, which (t) serves."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.spls import SPLSConfig
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.launch.steps import make_loss_grad
    from repro_torch.models import init_params
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                              spls=SPLSConfig(**TRAIN_SPLS))
    n_micro, L = cfg.microbatch["train_4k"], TRAIN_SPLS_L
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=L + 1,
                      global_batch=8, seed=SEED)
    tokens = data.global_batch * L
    row = {"train": "qwen3_train_spls_packed: qwen3-0.6b (28 x 1024, float32 "
                    "params, bf16 compute, remat), SPLS k 0.12 s 0.6 f 6 "
                    "window 8, q capacity 0.5, kv capacity 0.75, Trainer, "
                    "lm task",
           "seq_len": L, "global_batch": data.global_batch,
           "n_micro": n_micro, "tokens_per_step": tokens}
    _free()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    params = init_params(cfg, seed=SEED)
    t0 = time.perf_counter()
    with _Backends() as sites:
        grads, metrics = make_loss_grad(cfg, n_micro)(
            params, synthetic_batch(data, 0))
    torch.cuda.synchronize()
    norms = _attn_grad_norms(cfg, grads)
    expect = cfg.n_layers * n_micro * 2
    row["step1_grads"] = {
        "loss": float(metrics["loss"]), "wall_s": time.perf_counter() - t0,
        "attn_grad_norm_min": {w: min(v) for w, v in norms.items()},
        "attn_grad_norm_max": {w: max(v) for w, v in norms.items()},
        "forward_attention_calls": len(sites.names),
        "torch_packed_calls": sites.names.count("torch_packed"),
        "expected_calls": f"{expect} = {cfg.n_layers} sites x {n_micro} "
                          f"micro-batches x 2 (remat recomputes)"}
    bad = {w: [i for i, x in enumerate(v) if not (math.isfinite(x) and x > 0)]
           for w, v in norms.items()}
    if any(bad.values()) or sites.names != ["torch_packed"] * expect:
        _fail(f"qwen3_train_spls_packed: layers whose attention gradient "
              f"is zero or not finite {bad}; sites "
              f"{sorted(set(sites.names))} x {len(sites.names)} (expected "
              f"torch_packed x {expect})")
    del params, grads
    _free()

    t = Trainer(cfg, TrainerConfig(total_steps=2, log_every=1,
                                   n_micro=n_micro, seed=SEED), data)
    out = t.run()
    launches = K.launch_counts()
    dt = statistics.median(m["step_time_s"] for m in out["metrics"][1:])
    row["steps"] = [{k: m[k] for k in ("step", "loss", "grad_norm",
                                       "step_time_s")}
                    for m in out["metrics"]]
    row.update(step_time_s=dt, tokens_per_s=tokens / dt,
               peak_device_bytes=torch.cuda.max_memory_allocated(),
               dense_step_time_s_path_p=dense_step_s,
               step_time_over_dense=dt / dense_step_s,
               launches_while_training=launches)
    if not all(math.isfinite(m["loss"]) for m in out["metrics"]) or \
            len(out["metrics"]) != 2 or any(launches.values()):
        _fail(f"qwen3_train_spls_packed: {row}")
    _free()
    row["smoke_card_vs_cpu"] = _packed_smoke_cpu_vs_card(K)
    row["device"] = _smi()
    print(json.dumps(row))
    return t.params


class _Picks:
    """While on, files every pick of an engine under the request and
    output position ``(rid, j)`` it fills: the top two scores' tokens and
    their gap -- the logits for a greedy pick, the perturbed scores
    (recomputed from the generator's state before the draw) for a sampled
    one.  It checks that the pick is their argmax and that the token the
    engine appended is the one picked for that request's row.
    ``slot_reqs()`` gives the engine's request per batch row (slot)."""

    def __init__(self, reqs, slot_reqs):
        from repro_torch.serving import engine
        self.mod, self.orig = engine, engine._sample_tokens
        self.reqs, self.slot_reqs = reqs, slot_reqs
        self.records = {}          # (rid, j) -> ((top, second), gap)
        self._open = None          # the last pick, until its caller appends

    def _settle(self) -> None:
        """File the last pick under the positions its caller appended."""
        if self._open is None:
            return
        before, slot_of, tops, gaps = self._open
        self._open = None
        grown = [(r, n) for r, n in zip(self.reqs, before)
                 if len(r.output) > n]
        if len(tops) == 1 and len(grown) != 1:
            _fail(f"a single-row pick filled {len(grown)} requests")
        for r, n in grown:
            row = 0 if len(tops) == 1 else slot_of[id(r)]
            if r.output[n] != tops[row][0]:
                _fail(f"request {r.rid} token {n}: appended {r.output[n]}, "
                      f"picked {tops[row][0]}")
            self.records[(r.rid, n)] = (tuple(tops[row]), gaps[row])

    def __enter__(self):
        tiny = torch.finfo(torch.float32).tiny

        def pick(logits, greedy, temperature, generator):
            argmax = greedy or temperature <= 0.0
            self._settle()
            before = [len(r.output) for r in self.reqs]
            slot_of = {id(q): s for s, q in enumerate(self.slot_reqs())
                       if q is not None}
            if argmax:
                out = self.orig(logits, greedy, temperature, generator)
                top = logits.float().topk(2, dim=-1)
            else:
                state = generator.get_state()
                out = self.orig(logits, greedy, temperature, generator)
                replay = torch.Generator(device=logits.device)
                replay.set_state(state)
                u = torch.rand(logits.shape, generator=replay,
                               device=logits.device).clamp_(min=tiny)
                top = (logits.float() / temperature
                       - torch.log(-torch.log(u))).topk(2, dim=-1)
            if not torch.equal(top.indices[..., 0], out):
                _fail("a pick is not the argmax of its (perturbed) scores")
            self._open = (before, slot_of,
                          top.indices.reshape(-1, 2).tolist(),
                          (top.values[..., 0] - top.values[..., 1])
                          .reshape(-1).tolist())
            return out

        self.mod._sample_tokens = pick
        return self

    def __exit__(self, *exc):
        self.mod._sample_tokens = self.orig
        if exc[0] is None:
            self._settle()

    def near_tie(self, rid: int, j: int, a: int, b: int,
                 limit: float = 1e-4):
        """The gap of the pick at ``(rid, j)`` if its top two perturbed
        tokens are a and b and it lies within ``limit``."""
        rec = self.records.get((rid, j))
        if rec is not None and set(rec[0]) == {a, b} and rec[1] <= limit:
            return rec[1]
        return None


# path (t)'s new tokens per request (cut from 16 for the script's time limit)
T_NEW = 8


def _sampled(K, Engine, cfg, params, scfg, prompts, check=False,
             max_new: int = 16) -> tuple:
    """One run of ``Engine`` on ``prompts`` (``max_new`` new tokens
    each); its
    tokens, launches and wall, and with ``check`` the picks' records
    (:class:`_Picks`, greedy ones too, whose replay then lies inside the
    wall)."""
    from repro_torch.serving import Request

    eng = Engine(cfg, params, scfg)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    slot_reqs = (lambda: eng.slots) if Engine.__name__ == "ServingEngine" \
        else (lambda: [st and st.req for st in eng.sched.slots])
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with (_Picks(reqs, slot_reqs) if check
          else contextlib.nullcontext()) as picks:
        eng.run_until_drained(max_ticks=5000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.done for r in reqs):
        _fail(f"sampled serving: requests not done")
    return [list(r.output) for r in reqs], K.launch_counts(), wall, picks


def qwen3_sampled_serving(K, params) -> dict:
    """Path (t): the weights (s) trained, served at full width in float32
    by temperature sampling (T 0.8, seed 0): 2 prompts of 384 tokens from
    (i)'s traffic, :data:`T_NEW` new tokens each, through the paged engine with SPLS
    (``packed_cuda`` + ``cuda_paged_decode``: B1 / B2 / B3) and the dense
    engine (``cuda_flash`` + ``cuda_flash_decode``: B4 / B5), each against
    the same run on the plain backends: tokens equal but at printed
    near-ties (the top two perturbed scores within 1e-4); seed 0 again
    repeats, seed 1 differs, ``greedy=False`` at T 0 equals greedy."""
    from repro_torch.core.spls import SPLSConfig
    from repro_torch.serving import (PagedServingEngine, ServeConfig,
                                     ServingEngine)

    qwen = _full_width("qwen3-0.6b", compute_dtype="float32",
                       spls=SPLSConfig(enabled=True, k_ratio=0.12,
                                       s_threshold=0.6, f_threshold=6,
                                       window=8, causal=True))
    nospls = dataclasses.replace(
        qwen, spls=dataclasses.replace(qwen.spls, enabled=False))
    on = lambda c, name: dataclasses.replace(c, attn_backend=name)
    prompts = _prompts(qwen.vocab_size)[:2]     # the script's time limit
    hot = dict(greedy=False, temperature=0.8, seed=0)
    paged = dict(n_slots=4, page_size=16, prefill_chunk=64, max_len=512,
                 spls_prune_vote=0.5)
    engines = {
        "paged_spls": (PagedServingEngine, qwen, qwen, dict(
            paged, compute_backend="packed_cuda",
            attn_backend="cuda_paged_decode"), dict(
            paged, compute_backend="packed_torch",
            attn_backend="torch_paged_decode"),
            ("gathered_matmul", "gather_rows", "paged_flash_decode")),
        "dense_engine": (ServingEngine, on(nospls, "cuda_flash"),
                         on(nospls, "torch_flash"), dict(
            n_slots=4, max_len=512, attn_backend="cuda_flash_decode"), dict(
            n_slots=4, max_len=512, attn_backend="torch_flash_decode"),
            ("flash_attention", "flash_decode"))}
    paths, rows = {}, []
    for name, (Engine, kcfg, pcfg, kscfg, pscfg, must) in engines.items():
        run = lambda c, sc, check=False, **kw: _sampled(
            K, Engine, c, params, ServeConfig(**{**sc, **hot, **kw}),
            prompts, check, T_NEW)
        # the checked runs warm library handles and builds; the timed
        # ones repeat them without the replay
        toks, _, _, picks = run(kcfg, kscfg, check=True)
        again, launches, wall, _ = run(kcfg, kscfg)
        plain, launches_pc, _, picks_p = run(pcfg, pscfg, check=True)
        plain_again, launches_p, wall_p, _ = run(pcfg, pscfg)
        seed1 = run(kcfg, kscfg, seed=1)[0]
        cold = run(kcfg, kscfg, temperature=0.0)[0]
        greedy = run(kcfg, kscfg, greedy=True)[0]
        ties, bad = [], []
        for rid, (a, b) in enumerate(zip(toks, plain)):
            j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if j is None:
                continue
            gap = picks.near_tie(rid, j, a[j], b[j])
            if gap is None:
                gap = picks_p.near_tie(rid, j, a[j], b[j])
            (bad if gap is None else ties).append(
                {"rid": rid, "token": j, "kernel": a[j], "plain": b[j],
                 "gap": gap})
        n_tok = sum(map(len, toks))
        row = {"serve": f"qwen3_sampled_serving {name}",
               "backends": [kcfg.attn_backend, kscfg.get("compute_backend"),
                            kscfg["attn_backend"]],
               "plain_backends": [pcfg.attn_backend,
                                  pscfg.get("compute_backend"),
                                  pscfg["attn_backend"]],
               "temperature": 0.8, "seed": 0, "requests": len(prompts),
               "new_tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
               "plain_wall_s": wall_p, "sampled_picks": len(picks.records),
               "kernel_vs_plain_equal": sum(
                   x == y for a, b in zip(toks, plain)
                   for x, y in zip(a, b)),
               "near_ties": ties, "unexplained_mismatches": bad,
               "seed0_rerun_equal": again == toks,
               "plain_rerun_equal": plain_again == plain,
               "seed1_differs": seed1 != toks,
               "t0_equals_greedy": cold == greedy,
               "sampled_differs_from_greedy": toks != greedy,
               "launches": launches}
        rows.append(row)
        if bad or again != toks or seed1 == toks or cold != greedy or \
                any(_backend_launches(launches_p).values()) or \
                any(_backend_launches(launches_pc).values()) or \
                any(launches[k] == 0 for k in must):
            _fail(f"qwen3_sampled_serving {name}: {row}, plain launches "
                  f"{launches_p}")
        paths[f"qwen3_sampled_{name}"] = launches
    print(json.dumps({"qwen3_sampled_serving": rows, "device": _smi()}))
    return paths


def perfmodel_from_card(report: dict) -> None:
    """Path (u): path (d)'s reduction report (BERT-Base, 8 x 384, the mean
    over layers, measured on the card) through the ESACT accelerator's
    model at L 384, D 768, H 12, d_ff 3072.  The figures are the model's
    estimate for the accelerator (16 x 64 PEs at 500 MHz), not a time or
    an energy of the card."""
    from repro_torch.perfmodel import (attention_level_comparison,
                                       energy_efficiency,
                                       reductions_from_report,
                                       speedup_breakdown)

    red = reductions_from_report(report)
    L, D, H, d_ff = 384, 768, 12, 3072
    sb = speedup_breakdown(L, D, H, d_ff, red)
    prod = sb["spls_speedup"] * sb["progressive_speedup"] \
        * sb["dynamic_speedup"]
    rel = abs(sb["end_to_end_speedup"] - prod) / prod
    print(json.dumps({
        "perfmodel_from_card": "the ESACT accelerator model's estimate "
                               "(16 x 64 PEs, 500 MHz, TSMC 28 nm), fed the "
                               "sparsity path (d) measured on the card; not "
                               "a time or an energy of the card",
        "shape": {"L": L, "D": D, "H": H, "d_ff": d_ff},
        "reductions": red, "speedup_breakdown": sb,
        "product_rel_err": rel,
        "energy_efficiency": energy_efficiency(L, D, H, d_ff, red),
        "attention_level": attention_level_comparison(L, D, H,
                                                      red["attention"])}))
    if not rel <= 1e-12:
        _fail(f"perfmodel: end-to-end speedup {sb['end_to_end_speedup']} "
              f"is not the product of its factors {prod}")


def examples_on_card() -> None:
    """Path (v): ``repro_torch.quickstart.main([])`` and
    ``repro_torch.spls_ablation.main(["--steps", "200"])`` on the card;
    each prints its table."""
    import contextlib
    import io

    from repro_torch import quickstart, spls_ablation

    for name, fn, args, marker in (
            ("quickstart", quickstart.main, [], "relative L2 deviation"),
            ("spls_ablation", spls_ablation.main, ["--steps", "200"],
             "spls k=0.12 s=0.8")):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(buf.getvalue(), end="")
        print(json.dumps({"example": f"repro_torch.{name}", "args": args,
                          "wall_s": wall}))
        if marker not in buf.getvalue():
            _fail(f"{name} printed no table")


# ---------------------------------------------------------------------------
# phase 4: the exact-plan forward, path (d)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _model_axis(model: int):
    """A (1, ``model``) ``(data, model)`` mesh over the ``fake`` process
    group (``model`` ranks, this process rank 0) with its activation rules
    installed, as a tensor-parallel launcher installs them; the tensors stay
    plain ones on the card (one global view), so only the head layout
    follows the mesh.  The group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.sharding import axis_rules
    from repro_torch.sharding.rules import activation_rules

    dist.init_process_group("fake", rank=0, world_size=model,
                            store=FakeStore())
    try:
        mesh = make_cpu_mesh(1, model)
        with axis_rules(activation_rules(mesh), mesh):
            yield mesh
    finally:
        dist.destroy_process_group()


def qwen3_flat_heads(K) -> dict:
    """Path (w): qwen3-0.6b at full width and depth, float32, (i)'s SPLS
    knobs, (i)'s traffic cut to 4 prompts of 384 (the script's time
    limit), 16 new tokens each, through
    ``ServingEngine`` on ``cuda_flash`` + ``cuda_flash_decode`` under a
    mesh whose model axis is 16: KV 8 and G 2 do not divide it, H 16 does,
    so the layout is flat -- a flat SPLS plan, B4 at G 1 over 16 heads;
    decode stays structured (B5).  Tokens must equal the same engine's
    without a mesh (the structured layout) but at near-ties (top two logits
    within 1e-4 at the first differing pick); then the plain backends in
    the flat layout, tokens equal likewise."""
    from repro_torch.core.spls import SPLSConfig
    from repro_torch.models.attention import head_shard_mode
    from repro_torch.serving import ServeConfig, ServingEngine

    qwen = _full_width("qwen3-0.6b", compute_dtype="float32",
                       spls=SPLSConfig(enabled=True, k_ratio=0.12,
                                       s_threshold=0.6, f_threshold=6,
                                       window=8, causal=True))
    params = _params(qwen)
    prompts = _prompts(qwen.vocab_size)[:4]
    dense = dict(n_slots=4, max_len=512)
    kern = (dataclasses.replace(qwen, attn_backend="cuda_flash"),
            ServeConfig(attn_backend="cuda_flash_decode", **dense))
    plain = (dataclasses.replace(qwen, attn_backend="torch_flash"),
             ServeConfig(attn_backend="torch_flash_decode", **dense))
    run = lambda c, check=True: _sampled(K, ServingEngine, c[0], params,
                                         c[1], prompts, check)
    run(kern, check=False)                       # warm-up: handles, builds
    structured, launches_s, wall_s, picks_s = run(kern)
    with _model_axis(16):
        mode = head_shard_mode(qwen)
        if mode != "flat":
            _fail(f"qwen3_flat_heads: layout {mode!r} under a 16-wide "
                  f"model axis, expected 'flat'")
        flat, launches, wall, picks = run(kern)
        flat_plain, launches_p, wall_p, picks_p = run(plain)
    if any(_backend_launches(launches_p).values()):
        _fail(f"qwen3_flat_heads: the plain backends launched {launches_p}")
    zero = [k for k in ("flash_attention", "flash_decode") if not launches[k]]
    if zero:
        _fail(f"qwen3_flat_heads: kernels never launched: {zero}")

    def compare(a_runs, b_runs, a_picks, b_picks):
        ties, bad = [], []
        for rid, (a, b) in enumerate(zip(a_runs, b_runs)):
            j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if j is None:
                continue
            gap = a_picks.near_tie(rid, j, a[j], b[j])
            if gap is None:
                gap = b_picks.near_tie(rid, j, a[j], b[j])
            (bad if gap is None else ties).append(
                {"rid": rid, "token": j, "a": a[j], "b": b[j], "gap": gap})
        return ties, bad

    ties, bad = compare(flat, structured, picks, picks_s)
    ties_p, bad_p = compare(flat, flat_plain, picks, picks_p)
    n_tok = sum(map(len, flat))
    row = {"serve": "qwen3_flat_heads: qwen3-0.6b (28 x 1024, 16 heads, 8 "
                    "KV heads, float32), SPLS, ServingEngine, cuda_flash + "
                    "cuda_flash_decode, (1, 16) mesh: flat heads",
           "requests": len(prompts), "new_tokens": n_tok,
           "wall_s": wall, "tok_per_s": n_tok / wall,
           "structured_wall_s": wall_s, "plain_flat_wall_s": wall_p,
           "launches": launches, "structured_launches": launches_s,
           "flat_vs_structured_equal": sum(
               x == y for a, b in zip(flat, structured)
               for x, y in zip(a, b)),
           "flat_kernel_vs_plain_equal": sum(
               x == y for a, b in zip(flat, flat_plain)
               for x, y in zip(a, b)),
           "near_ties": ties + ties_p,
           "unexplained_mismatches": bad + bad_p,
           "device": _smi()}
    print(json.dumps(row, default=str))
    if bad or bad_p:
        _fail(f"qwen3_flat_heads: tokens differ off a near-tie: "
              f"{bad + bad_p}")
    del params
    _free()
    return {"qwen3_flat_heads": launches}


def musicgen_padded_heads(K) -> dict:
    """Path (x): musicgen-medium at full width and depth (48 x 1536, 24
    heads, float32; published compute bf16, a cut: in bf16 the 32-head
    ``wo`` sum would round elsewhere than the 24-head one over 48 layers),
    2 inputs of 512 frame embeddings through ``models.forward`` on
    ``cuda_flash``: under a 16-wide model axis nothing divides 24, so the
    heads are padded to H' 32 (zero ``wq`` / ``wo`` rows, no SPLS plan),
    against the structured forward without a mesh, and against the plain
    backend (``torch_flash``) under the same mesh.  Logits within 1e-4 x
    max |structured| and 1e-4 x max |plain| (PERF.md's limit for logits
    after several layers)."""
    from repro_torch.models import forward
    from repro_torch.models.attention import _pad_heads_to, head_shard_mode

    cfg = _full_width("musicgen-medium", compute_dtype="float32",
                      attn_backend="cuda_flash")
    params = _params(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((2, 512, cfg.d_model), device="cuda", generator=gen)

    def timed(c=cfg):
        with torch.no_grad():
            forward(c, params, x)                    # warm
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            out = forward(c, params, x)
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0, K.launch_counts()

    ref, wall_s, launches_s = timed()
    with _model_axis(16):
        mode, hp = head_shard_mode(cfg), _pad_heads_to(cfg)
        got, wall, launches = timed()
        plain, wall_p, launches_p = timed(
            dataclasses.replace(cfg, attn_backend="torch_flash"))
    if (mode, hp) != ("padded", 32):
        _fail(f"musicgen_padded_heads: layout {mode!r}, H' {hp}")
    if any(launches_p.values()):
        _fail(f"musicgen_padded_heads: the plain backend launched "
              f"{launches_p}")
    err = float((got - ref).abs().max())
    limit = 1e-4 * float(ref.abs().max())
    err_p = float((got - plain).abs().max())
    limit_p = 1e-4 * float(plain.abs().max())
    row = {"forward": "musicgen_padded_heads: musicgen-medium (48 x 1536, "
                      "24 heads padded to 32, float32), 2 x 512 frame "
                      "embeddings, cuda_flash, (1, 16) mesh",
           "wall_s": wall, "structured_wall_s": wall_s,
           "launches": launches, "structured_launches": launches_s,
           "max_abs_err": err, "limit": limit,
           "max_abs_structured": float(ref.abs().max()),
           "plain_padded_wall_s": wall_p,
           "kernel_vs_plain_padded_max_abs_err": err_p,
           "kernel_vs_plain_padded_limit": limit_p,
           "finite": bool(torch.isfinite(got).all()), "device": _smi()}
    print(json.dumps(row))
    if not (row["finite"] and err <= limit and err_p <= limit_p):
        _fail(f"musicgen_padded_heads: {row}")
    if launches["flash_attention"] != cfg.n_layers:
        _fail(f"musicgen_padded_heads: B4 launched "
              f"{launches['flash_attention']} times, expected "
              f"{cfg.n_layers}")
    del params, ref, got, plain
    _free()
    return {"musicgen_padded_heads": launches}


def production_specs_table() -> None:
    """The body of path (y), run in a process of its own: every
    architecture's parameter, AdamW-state and decode-cache shardings at
    full width on 16 x 16 and 2 x 16 x 16 over the ``fake`` group; the
    bytes a device holds of each, and the largest leaf left replicated."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import abstract_cache, abstract_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import mesh_axis_sizes
    from repro_torch.sharding.rules import (cache_sharding,
                                            opt_state_sharding,
                                            param_sharding)
    from repro_torch.tree import leaf_id, leaves_with_path

    decode = next(s for s in LM_SHAPES if s.name == "decode_32k")
    rows = []
    for multi_pod in (False, True):
        dist.init_process_group("fake", rank=0,
                                world_size=512 if multi_pod else 256,
                                store=FakeStore())
        try:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            sizes = mesh_axis_sizes(mesh)

            def per_device(tree, shd):
                total, largest = 0, (0, None)
                for (path, t), (_, s) in zip(leaves_with_path(tree),
                                             leaves_with_path(shd)):
                    n = t.numel() * t.element_size()
                    for ax in s.spec:
                        for a in (() if ax is None else (ax,)
                                  if isinstance(ax, str) else ax):
                            n //= sizes[a]
                    total += n
                    if all(ax is None for ax in s.spec):
                        largest = max(largest, (n, leaf_id(path)),
                                      key=lambda x: x[0])
                return total, largest

            for arch in ARCH_IDS:
                cfg = get_config(arch)
                ab = abstract_params(cfg)
                pshd = param_sharding(cfg, mesh, ab)
                opt = adamw_init(AdamWConfig(), ab)
                oshd = opt_state_sharding(pshd, opt)
                cache = abstract_cache(cfg, decode.global_batch,
                                       decode.seq_len)
                cshd = cache_sharding(cfg, mesh, cache, decode.global_batch,
                                      decode.seq_len)
                row = {"arch": arch, "mesh": "x".join(
                    str(v) for v in sizes.values())}
                for what, tree, shd in (("params", ab, pshd),
                                        ("adamw", opt, oshd),
                                        ("decode_32k_cache", cache, cshd)):
                    total, (big, big_id) = per_device(tree, shd)
                    row[f"{what}_bytes_per_device"] = total
                    row[f"{what}_largest_replicated"] = [big_id, big]
                rows.append(row)
        finally:
            dist.destroy_process_group()
    print(json.dumps({"production_specs": rows}))


def production_specs(proc) -> list:
    """Path (y): :func:`production_specs_table` in a subprocess (``proc``,
    started by :func:`start_host_dryruns`), which keeps the ``fake``
    default process group out of the other phases.  Returns the table's
    rows."""
    line = _aa_wait("production_specs", proc, 300)[-1]
    print(line)
    return json.loads(line)["production_specs"]


# path (aa)'s cells on one card, for qwen3-0.6b (aa.2) and h2o-danube3-4b
# (ab) at full width, published dtypes
AA_CELLS = (("prefill", 4096, 2), ("decode", 4096, 8))
# path (ab)'s architecture: Dh 120, G 4 (aa's qwen3-0.6b: Dh 128, G 2)
AB_ARCH = "h2o-danube3-4b"


def _aa_inputs(cfg, kind: str, L: int, B: int, gen) -> tuple:
    """A step's inputs on the card: random weights from the seed, random
    tokens; a decode step's cache is the prefill of its first L - 1
    tokens (through B4), so that B5 reads the model's own keys, and every
    row writes slot L - 1 with the last token."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    params = init_params(cfg, seed=SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, L), generator=gen,
                         dtype=torch.int32, device="cuda")
    if kind == "prefill":
        return params, toks
    _, cache = make_prefill_step(cfg, "pallas_flash")(params, toks[:, :-1], L)
    return (params, cache, toks[:, -1:].contiguous(),
            torch.full((B,), L - 1, dtype=torch.int32, device="cuda"))


def one_rank_dryruns() -> None:
    """The host's part of paths (aa.2), (ab) and (ac), run in a process of
    its own while the card trains: the dry runs of their steps on a
    one-rank mesh (a ``fake`` group of one rank), printed as one JSON line
    ``{"<arch> <kind>": analyze_step's result}``, (ac)'s under ``"ac"``."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import (analyze_step, fake_group,
                                           spls_config)
    from repro_torch.launch.mesh import make_cpu_mesh

    out = {}
    with fake_group(1):
        mesh = make_cpu_mesh(1, 1)
        for arch in ("qwen3-0.6b", AB_ARCH):
            for kind, L, B in AA_CELLS:
                out[f"{arch} {kind}"] = analyze_step(
                    get_config(arch), ShapeCfg(f"aa_{kind}", L, B, kind),
                    mesh)
        kind, L, B = AC_CELL
        out["ac"] = analyze_step(spls_config(get_config(AB_ARCH)),
                                 ShapeCfg("ac", L, B, kind), mesh)
    print(json.dumps(out))


def dryrun_vs_card_body(arch: str, cells, dry: dict) -> None:
    """The body of path (aa.2) (``arch`` qwen3-0.6b) and of path (ab)
    (:data:`AB_ARCH`), run in a process of its own: the
    dry runs (``dry``, :func:`one_rank_dryruns`) of ``arch``'s ``cells``
    -- a prefill (B 2 x L 4096), a decode step (B 8 against a 4096-token
    cache) -- on a one-rank mesh (a ``fake`` group of one rank,
    destroyed after), then the same steps for real on the card under the
    dry run's routes (``route_as("cpu")``): the real inputs' bytes must
    equal the dry run's argument bytes and ``FlopCounterMode``'s count of
    the real step its ``dot_flops``, exactly; the predicted peak (argument
    plus temp bytes) must lie within 25 % of the bytes allocated at the
    step's peak above those allocated before its inputs were made.  Then
    the same steps through the kernels (``cuda_flash`` B4,
    ``cuda_flash_decode`` B5), timed beside the dry run's roofline terms,
    and their logits held against the same steps through the kernels'
    plain versions (``torch_flash`` / ``torch_flash_decode``) on the same
    inputs: 1 bf16 ulp of max |plain| after the prefill, 4 after the decode
    step from the prefill's cache (:func:`_bf16_logits`' tolerances).  A control, reported beside
    each tolerance, runs the kernels with a fault: the prefill with the
    causal mask dropped, the decode step on a zeroed cache.  Prints one
    JSON line with the launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device, route_as
    from repro_torch.launch.dryrun import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import leaves, tree_map

    resolve_device()
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, launches, bad = [], {}, []
    for kind, L, B in cells:
        d = dry[f"{arch} {kind}"]
        mem, stats = d["memory"], d["stats"]
        _free()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        args = _aa_inputs(cfg, kind, L, B, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        arg_bytes = sum(t.numel() * t.element_size() for t in leaves(args)
                        if isinstance(t, torch.Tensor))
        plain = (make_prefill_step(cfg) if kind == "prefill"
                 else make_serve_step(cfg))
        with route_as("cpu"), FlopCounterMode(display=False) as fc:
            out = plain(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        predicted = mem["argument_bytes_per_device"] + \
            mem["temp_bytes_per_device"]
        # the kernels' plain versions; then the kernels: warmed once, then
        # one timed call, whose logits are held against the plain ones
        make = make_prefill_step if kind == "prefill" else make_serve_step
        names = (("torch_flash", "pallas_flash") if kind == "prefill"
                 else ("torch_flash_decode", "pallas_flash_decode"))
        ref = make(cfg, names[0])(*args)[0]
        fast = make(cfg, names[1])
        fast(*args)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        got = fast(*args)[0]
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        n = K.launch_counts()
        if kind == "prefill":
            control_name = "control_causal_dropped"
            control = make(dataclasses.replace(cfg, causal=False),
                           names[1])(*args)[0]
        else:
            control_name = "control_cache_zeroed"
            control = fast(args[0], tree_map(torch.zeros_like, args[1]),
                           *args[2:])[0]
        kernel = "flash_attention" if kind == "prefill" else "flash_decode"
        launches[kernel] = n[kernel]
        roof = {"compute_s": stats["dot_flops"] / PEAK_FLOPS,
                "memory_s": stats["traffic_bytes"] / HBM_BW}
        row = {"dryrun_vs_card": f"{arch} {kind} B {B} x L {L}",
               "argument_bytes_dry": mem["argument_bytes_per_device"],
               "argument_bytes_card": arg_bytes,
               "dot_flops_dry": stats["dot_flops"],
               "flop_counter_card": float(fc.get_total_flops()),
               "temp_bytes_dry": mem["temp_bytes_per_device"],
               "peak_bytes_predicted": predicted,
               "peak_bytes_card": peak,
               "peak_ratio": predicted / peak,
               "kernel_step_s": step_s, "kernel_launches": n,
               "roofline_dry": roof,
               "step_over_roofline": step_s / max(roof.values()),
               "trace_s": d["trace_s"], "device": _smi()}
        try:
            _hold_logits(f"dryrun_vs_card {arch} {kind}", "logits", got,
                         ref, 1 if kind == "prefill" else 4, row, control,
                         control_name)
        except SystemExit as e:
            bad.append(str(e))
        del ref, got, control
        rows.append(row)
        print(json.dumps(row))
        if arg_bytes != mem["argument_bytes_per_device"]:
            bad.append(f"{kind}: argument bytes {arg_bytes} on the card, "
                       f"{mem['argument_bytes_per_device']} dry")
        if row["flop_counter_card"] != stats["dot_flops"]:
            bad.append(f"{kind}: dot FLOPs {row['flop_counter_card']} on "
                       f"the card, {stats['dot_flops']} dry")
        if abs(predicted - peak) > 0.25 * peak:
            bad.append(f"{kind}: predicted peak {predicted} bytes, the "
                       f"card's {peak}")
        if not n[kernel]:
            bad.append(f"{kind}: {kernel} was not launched")
        del args
    print(json.dumps({"dryrun_vs_card_launches": launches}))
    if bad:
        raise SystemExit(f"dryrun_vs_card {arch}: {bad}")


# path (ac): an SPLS prefill past the chunked-plan threshold
AC_CELL = ("prefill", 8192, 1)
# (ac.1)'s argument bytes per device: ``python -m repro_torch.launch.dryrun
# --arch h2o-danube3-4b --shape prefill_32k --spls --multi-pod`` on this
# repository's CPU host (torch 2.13), equal to the reference's
AC1_ARGUMENT_BYTES = 2154593792


def dryrun_vs_card_spls_body(d: dict) -> None:
    """The body of path (ac), run in a process of its own:
    :data:`AB_ARCH` with the dry run's SPLS configuration
    (:func:`repro_torch.launch.dryrun.spls_config`), a prefill of
    :data:`AC_CELL` -- at 8192 tokens the chunked plan (16 row blocks of
    512, 12 bisection steps each) and the chunked attention (3 KV chunks
    of 2048) run.  Its dry run on a one-rank mesh (``d``,
    :func:`one_rank_dryruns`) counts those loops by trip count; the same step on the card under the dry run's routes
    (``route_as("cpu")``: ``packed_torch``, ``torch_chunked``) runs every
    iteration, and must give the dry run's argument bytes and dot FLOPs
    exactly (``FlopCounterMode``), its peak within 25 % of the predicted
    one.  Then the step with ``compute_backend="packed_cuda"`` (B1 and B2
    compute the packed FFN rows; the attention stays ``torch_chunked``, as
    every route takes a chunked plan there), timed beside the dry run's
    roofline, its logits held against ``packed_torch``'s on the same
    inputs (1 bf16 ulp of max |plain|); the control computes the FFN on
    every row (FFN sparsity off).  The reference is a ``packed_torch`` step
    of its own, outside ``FlopCounterMode`` and ``route_as``: the counted
    step's logits differed from ``packed_cuda``'s by 1.1 (on an H100,
    torch 2.11), where this one's agree.  Prints one JSON line with the
    launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device, route_as
    from repro_torch.launch.dryrun import HBM_BW, PEAK_FLOPS, spls_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.tree import leaves

    resolve_device()
    cfg = spls_config(get_config(AB_ARCH))
    kind, L, B = AC_CELL
    mem, stats = d["memory"], d["stats"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    _free()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = _aa_inputs(cfg, kind, L, B, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arg_bytes = sum(t.numel() * t.element_size() for t in leaves(args)
                    if isinstance(t, torch.Tensor))
    with route_as("cpu"), FlopCounterMode(display=False) as fc:
        out = make_prefill_step(cfg)(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    predicted = mem["argument_bytes_per_device"] + mem["temp_bytes_per_device"]
    step = lambda c, backend: make_prefill_step(dataclasses.replace(
        c, compute_backend=backend))(*args)[0]
    # the packed_torch step also warms the same plan and attention; B1 and
    # B2 ran on earlier paths
    ref = step(cfg, "packed_torch")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = step(cfg, "packed_cuda")
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    n = K.launch_counts()
    control = step(dataclasses.replace(cfg, spls=dataclasses.replace(
        cfg.spls, ffn_sparsity=False)), "packed_cuda")
    roof = {"compute_s": stats["dot_flops"] / PEAK_FLOPS,
            "memory_s": stats["traffic_bytes"] / HBM_BW}
    row = {"dryrun_vs_card_spls": f"{AB_ARCH} SPLS {kind} B {B} x L {L}",
           "argument_bytes_dry": mem["argument_bytes_per_device"],
           "argument_bytes_card": arg_bytes,
           "dot_flops_dry": stats["dot_flops"],
           "flop_counter_card": float(fc.get_total_flops()),
           "temp_bytes_dry": mem["temp_bytes_per_device"],
           "peak_bytes_predicted": predicted, "peak_bytes_card": peak,
           "peak_ratio": predicted / peak, "packed_cuda_step_s": step_s,
           "kernel_launches": n, "roofline_dry": roof,
           "step_over_roofline": step_s / max(roof.values()),
           "trace_s": d["trace_s"], "device": _smi()}
    bad = []
    try:
        _hold_logits(f"dryrun_vs_card_spls {AB_ARCH}", "logits", got, ref,
                     1, row, control, "control_ffn_dense")
    except SystemExit as e:
        bad.append(str(e))
    print(json.dumps(row))
    if arg_bytes != mem["argument_bytes_per_device"]:
        bad.append(f"argument bytes {arg_bytes} on the card, "
                   f"{mem['argument_bytes_per_device']} dry")
    if row["flop_counter_card"] != stats["dot_flops"]:
        bad.append(f"dot FLOPs {row['flop_counter_card']} on the card, "
                   f"{stats['dot_flops']} dry")
    if abs(predicted - peak) > 0.25 * peak:
        bad.append(f"predicted peak {predicted} bytes, the card's {peak}")
    launches = {k: n[k] for k in ("gathered_matmul", "gather_rows")}
    if not all(launches.values()):
        bad.append(f"B1 / B2 not launched: {n}")
    print(json.dumps({"dryrun_vs_card_launches": launches}))
    if bad:
        raise SystemExit(f"dryrun_vs_card_spls {AB_ARCH}: {bad}")


# one OpenMP thread for each subprocess: the host pool's dry runs overlap
# the timed card phases, and idle OpenMP threads of several processes spin
# against each other (as ``dryrun_all`` runs its cells)
_ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def _aa_subprocess(code: str):
    root = Path(__file__).resolve().parent
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as c; "
         "c.sys.path.insert(0, 'src'); " + code], cwd=root,
        env=dict(os.environ, **_ONE_THREAD), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _dryrun_cli(arch: str, shape: str, *flags: str):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, *flags], cwd=Path(__file__).resolve().parent,
        env=dict(os.environ, PYTHONPATH="src", **_ONE_THREAD),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_host_dryruns() -> dict:
    """The runs that use the host only, started early so they overlap the
    card's training phases: (aa.1) and (ab.1) ``python -m
    repro_torch.launch.dryrun --arch qwen3-0.6b`` (``AB_ARCH``) ``--shape
    decode_32k``, (ac.1) ``AB_ARCH``'s ``prefill_32k --spls
    --multi-pod``, (aa.3) :func:`dryrun_p_step`, the one-rank dry runs of
    (aa.2), (ab) and (ac) (:func:`one_rank_dryruns`) and path (y)'s table
    (:func:`production_specs_table`).  :func:`production_specs` and
    :func:`dryrun_vs_card` read them."""
    return {"aa1": _dryrun_cli("qwen3-0.6b", "decode_32k"),
            "ab1": _dryrun_cli(AB_ARCH, "decode_32k"),
            "ac1": _dryrun_cli(AB_ARCH, "prefill_32k", "--spls",
                               "--multi-pod"),
            "aa3": _aa_subprocess("c.dryrun_p_step()"),
            "dry": _aa_subprocess("c.one_rank_dryruns()"),
            "y": _aa_subprocess("c.production_specs_table()")}


def _aa_wait(name: str, proc, timeout: int) -> list:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        _fail(f"{name}: no result in {timeout} s")
    if proc.returncode:
        _fail(f"{name}: exit {proc.returncode}: {out[-1500:]} "
              f"{err[-2500:]}")
    return out.strip().splitlines()


def dryrun_p_step() -> None:
    """The body of path (aa.3): the dry run of path (p)'s own step
    (qwen3-0.6b, 1 x 1 mesh, B 8 x 4096, 8 microbatches of one row,
    remat), printed as one JSON line."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import analyze_step, fake_group
    from repro_torch.launch.mesh import make_cpu_mesh

    with fake_group(1):
        a = analyze_step(get_config("qwen3-0.6b"),
                         ShapeCfg("p", 4096, 8, "train"), make_cpu_mesh(1, 1),
                         n_micro=1)
    print(json.dumps(a))


def _dryrun_decode_32k(specs: list, arch: str, proc) -> None:
    """(aa.1) / (ab.1): the host dry run of ``arch``'s ``decode_32k`` on 16
    x 16, whose argument bytes must equal path (y)'s parameter and cache
    bytes plus the tokens' and positions' local bytes, and whose alias
    bytes the cache's (updated in place)."""
    res = json.loads("\n".join(_aa_wait(f"dryrun {arch} decode_32k", proc,
                                         300)))
    row = next(r for r in specs
               if r["arch"] == arch and r["mesh"] == "16x16")
    B = 128 // 16                      # decode_32k's batch over the data axis
    cache = row["decode_32k_cache_bytes_per_device"]
    expected = row["params_bytes_per_device"] + cache + B * 4 + B * 4
    mem = res["memory"]
    print(json.dumps({"dryrun_decode_32k": res, "path_y_bytes": expected,
                      "path_y_cache_bytes": cache}))
    if mem["argument_bytes_per_device"] != expected:
        _fail(f"dryrun {arch} decode_32k: argument bytes "
              f"{mem['argument_bytes_per_device']}, path (y) gives "
              f"{expected}")
    if mem["alias_bytes_per_device"] != cache:
        _fail(f"dryrun {arch} decode_32k: alias bytes "
              f"{mem['alias_bytes_per_device']}, the cache's {cache}")


def dryrun_vs_card(specs: list, p_step_s: float, p_peak: int,
                   host: dict) -> dict:
    """Paths (aa), (ab) and (ac): (aa.1) / (ab.1) :func:`_dryrun_decode_32k`
    of qwen3-0.6b / ``AB_ARCH``; (aa.2) / (ab) :func:`dryrun_vs_card_body`
    of each and (ac) :func:`dryrun_vs_card_spls_body`, each in a
    subprocess, one after the other; (ac.1)'s argument bytes; (aa.3) the
    dry run of path (p)'s step (:func:`dryrun_p_step`) beside (p)'s
    measured peak and step time.  ``host`` holds (aa.1), (ab.1), (ac.1)
    and (aa.3), started by :func:`start_host_dryruns`.  Returns (aa.2)'s,
    (ab)'s and (ac)'s launches."""
    from repro_torch.launch.dryrun import HBM_BW, PEAK_FLOPS

    launches = {}
    dry = json.loads(_aa_wait("one-rank dry runs", host["dry"], 300)[-1])
    for path, arch, cells in (("dryrun_vs_card", "qwen3-0.6b", AA_CELLS),
                              ("dryrun_vs_card_h2o", AB_ARCH, AA_CELLS)):
        t0 = time.perf_counter()
        lines = _aa_wait(f"dryrun_vs_card {arch}", _aa_subprocess(
            f"c.dryrun_vs_card_body({arch!r}, {cells!r}, {dry!r})"), 300)
        for ln in lines[:-1]:
            print(ln)
        launches[path] = json.loads(lines[-1])["dryrun_vs_card_launches"]
        print(json.dumps({"phase_s": path, "s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    lines = _aa_wait(f"dryrun_vs_card_spls {AB_ARCH}", _aa_subprocess(
        f"c.dryrun_vs_card_spls_body({dry['ac']!r})"), 300)
    for ln in lines[:-1]:
        print(ln)
    launches["dryrun_vs_card_spls"] = json.loads(
        lines[-1])["dryrun_vs_card_launches"]
    print(json.dumps({"phase_s": "dryrun_vs_card_spls",
                      "s": time.perf_counter() - t0}))
    _dryrun_decode_32k(specs, "qwen3-0.6b", host["aa1"])
    _dryrun_decode_32k(specs, AB_ARCH, host["ab1"])
    ac1 = json.loads("\n".join(_aa_wait(
        f"dryrun {AB_ARCH} prefill_32k --spls --multi-pod", host["ac1"],
        300)))
    print(json.dumps({"dryrun_prefill_32k_spls_multi_pod": ac1,
                      "argument_bytes_host": AC1_ARGUMENT_BYTES}))
    if ac1["memory"]["argument_bytes_per_device"] != AC1_ARGUMENT_BYTES:
        _fail(f"dryrun {AB_ARCH} prefill_32k --spls --multi-pod: argument "
              f"bytes {ac1['memory']['argument_bytes_per_device']}, this "
              f"repository's host gives {AC1_ARGUMENT_BYTES}")

    p = json.loads(_aa_wait("dryrun of path (p)", host["aa3"], 300)[-1])
    roof = {"compute_s": p["stats"]["dot_flops"] / PEAK_FLOPS,
            "memory_s": p["stats"]["traffic_bytes"] / HBM_BW}
    peak = p["memory"]["argument_bytes_per_device"] + \
        p["memory"]["temp_bytes_per_device"]
    print(json.dumps({"dryrun_path_p": p, "peak_bytes_predicted": peak,
                      "peak_bytes_p": p_peak, "peak_ratio": peak / p_peak,
                      "roofline": roof, "step_s_p": p_step_s,
                      "step_over_roofline": p_step_s / max(roof.values())}))
    return launches


def sharded_restore_body(ckpt: str) -> None:
    """The body of path (z), run in a process of its own: a one-rank NCCL
    group and a 1 x 1 CUDA ``DeviceMesh``; the trained qwen3-0.6b
    checkpoint of path (p) restored through ``shardings=`` must equal a
    plain restore bit for bit, leaf by leaf; then one ``Trainer(mesh=)``
    step from the sharded state (the ``DTensor`` leaves, which the trainer
    gathers when it starts) must equal the same step without a mesh from
    the plain restore."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.models import abstract_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.sharding.rules import (opt_state_sharding,
                                            param_sharding)
    from repro_torch.tree import leaves

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            torch.cuda.set_device(0)
            mesh = make_cpu_mesh(1, 1, device_type="cuda")
            cfg = get_config("qwen3-0.6b")
            like_p = abstract_params(cfg)        # structure and dtypes
            like = {"params": like_p,
                    "opt": adamw_init(AdamWConfig(), like_p)}
            t0 = time.perf_counter()
            plain, step, _ = restore_checkpoint(ckpt, like)
            plain_s = time.perf_counter() - t0
            pshd = param_sharding(cfg, mesh, like_p)
            shd = {"params": pshd,
                   "opt": opt_state_sharding(pshd, like["opt"])}
            t0 = time.perf_counter()
            sharded, step2, _ = restore_checkpoint(ckpt, like,
                                                   shardings=shd)
            torch.cuda.synchronize()
            sharded_s = time.perf_counter() - t0
            del like
            n_leaves, n_diff = 0, 0
            for a, b in zip(leaves(sharded), leaves(plain)):
                n_leaves += 1
                loc = a.to_local()
                n_diff += int(not (loc.dtype == b.dtype and
                                   torch.equal(loc, b)))
            placements = sorted({repr(tuple(x.placements))
                                 for x in leaves(sharded)})

            data = DataConfig(vocab_size=cfg.vocab_size, seq_len=513,
                              global_batch=2, seed=SEED)
            runs = {}
            for name, m, state in (("mesh", mesh, sharded),
                                   ("plain", None, plain)):
                tr = Trainer(cfg, TrainerConfig(total_steps=step + 1,
                                                log_every=1, seed=SEED),
                             data, mesh=m)
                tr.params, tr.opt_state = state["params"], state["opt"]
                tr.step = step
                out = tr.run()
                runs[name] = (tr.params, out["metrics"][-1]["loss"])
            same = all(torch.equal(a, b) for a, b in
                       zip(leaves(runs["mesh"][0]),
                           leaves(runs["plain"][0])))
            row = {"sharded_restore_on_card": ckpt, "step": step,
                   "leaves": n_leaves, "leaves_differing": n_diff,
                   "placements": placements, "plain_restore_s": plain_s,
                   "sharded_restore_s": sharded_s,
                   "trainer_mesh_loss": runs["mesh"][1],
                   "trainer_plain_loss": runs["plain"][1],
                   "trainer_step_params_equal": same}
            print(json.dumps(row))
            if n_diff or step != step2 or not same or \
                    runs["mesh"][1] != runs["plain"][1]:
                raise SystemExit(f"sharded_restore_on_card: {row}")
        finally:
            dist.destroy_process_group()


def sharded_restore_on_card(ckpt: Path) -> None:
    """Path (z): :func:`sharded_restore_body` in a subprocess (its NCCL
    group stays out of this process)."""
    root = Path(__file__).resolve().parent
    out = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as c; "
         "c.sys.path.insert(0, 'src'); "
         f"c.sharded_restore_body({str(ckpt)!r})"],
        cwd=root, capture_output=True, text=True, timeout=600)
    if out.returncode:
        _fail(f"sharded_restore_on_card: exit {out.returncode}: "
              f"{out.stdout[-1500:]} {out.stderr[-2500:]}")
    print(out.stdout.strip().splitlines()[-1])


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
    is an upper bound.  A trace that comes back empty is taken again, up to
    three times (as in :func:`_device_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
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
        if spans:
            break
    else:
        _fail("the profiler saw no kernel on the card, three times")
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
        out[f"hlog_{name}_vs_plain_err"] = exact
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
    path's launch counts and its plans' mean stats and FLOPs reduction
    over layers."""
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
    blocks = long_launches["spls_plan_block"]
    if not torch.isfinite(y).all() or \
            any(_backend_launches(long_launches).values()) or \
            not blocks or long_launches["spls_mfi"] != blocks:
        _fail(f"block at L={L2}: finite {bool(torch.isfinite(y).all())}, "
              f"launches {long_launches} (the row-block route launches no "
              f"backend kernel, the plan kernels once a row block)")
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
        "route": "plan_scan (spls_plan_block, spls_mfi) -> torch_chunked",
        "plan_kernel_launches": blocks,
        "wall_s": wall2, "peak_device_bytes_above_inputs": peak2,
        "plan_only_peak_bytes_above_inputs": plan_peak,
        "one_float32_pam_bytes": cfg.n_heads * L2 * L2 * 4,
        "q_kept": kept(plan.q_critical), "kv_kept": kept(plan.kv_keep),
        "ffn_kept": kept(plan.ffn_critical),
        "checked": "finite outputs only: no reference at this length"}))
    return {"flash_attention": launches["flash_attention"],
            "hlog_qmatmul": ops_launches["hlog_qmatmul"],
            "local_similarity_dist": ops_launches["local_similarity_dist"]
            }, mean


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
        # e.g. a wait that ptxas put in to serialize wgmma products
        for ln in _build.build_log(name).splitlines():
            if "C7517" in ln or "Performance Loss" in ln:
                print(f"  {name}: {ln.strip()}")

    host = {}
    try:
        return _phases(K, ptxas, smi, host)
    finally:
        for proc in host.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _phases(K, ptxas: dict, smi: str, host: dict) -> int:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [check_gathered_matmul(K, gen), check_gather_rows(K, gen),
            check_paged_decode(K, gen), check_flash_attention(K, gen),
            check_flash_decode(K, gen), check_hlog_qmatmul(K, gen),
            check_local_similarity(K, gen), *check_spls_plan(K, gen)]
    host_path(K, gen)
    paths = serve(K)
    paths["noncausal_exact_forward"], report_d = exact_forward(K)
    serve_bf16(K)
    paths.update(families(K))
    # path (aa)'s host-only dry runs overlap the training phases, after the
    # serve paths whose walls the host's load would move
    host.update(start_host_dryruns())
    t0 = time.perf_counter()
    paths["qwen3_train"], dense_step_s, ckpt, p_peak = qwen3_train(K)
    print(json.dumps({"phase_s": "qwen3_train",
                      "s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    try:
        sharded_restore_on_card(ckpt / "b")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(json.dumps({"phase_s": "sharded_restore_on_card",
                      "s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    train_smoke_cpu_vs_card(K)
    print(json.dumps({"phase_s": "train_smoke_cpu_vs_card",
                      "s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    train_launcher_sweep(K)
    print(json.dumps({"phase_s": "train_launcher_sweep",
                      "s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    trained = qwen3_train_spls_packed(K, dense_step_s)
    print(json.dumps({"phase_s": "qwen3_train_spls_packed",
                      "s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    paths.update(qwen3_sampled_serving(K, trained))
    del trained
    _free()
    print(json.dumps({"phase_s": "qwen3_sampled_serving",
                      "s": time.perf_counter() - t0}))
    perfmodel_from_card(report_d)
    t0 = time.perf_counter()
    examples_on_card()
    print(json.dumps({"phase_s": "examples_on_card",
                      "s": time.perf_counter() - t0}))
    for name, phase in (("qwen3_flat_heads", qwen3_flat_heads),
                        ("musicgen_padded_heads", musicgen_padded_heads)):
        t0 = time.perf_counter()
        paths.update(phase(K))
        print(json.dumps({"phase_s": name, "s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    specs = production_specs(host["y"])
    print(json.dumps({"phase_s": "production_specs",
                      "s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    paths.update(dryrun_vs_card(specs, dense_step_s, p_peak, host))
    print(json.dumps({"phase_s": "dryrun_vs_card",
                      "s": time.perf_counter() - t0}))
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
