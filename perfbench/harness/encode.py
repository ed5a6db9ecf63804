"""Back-to-back encoder batches through the program's ``models.forward``.

Set-up draws the weights and a pool of token batches on the card from the
run's seed and runs the mix's warm-up batches.  The window then calls
``forward`` on one batch after another, each ended by
``torch.cuda.synchronize()``; a batch's wall time runs from the call to the
end of that synchronisation.  After the window a sample of the window's
batches, drawn from the seed, is recomputed by the plain reference.
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import List

import numpy as np
import torch

from . import flops as fl
from . import traffic as tr
from .trace import PhaseLog, profiled, summarize

clock = time.monotonic


def batches(traffic: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """(pool, batch, seq_len) int32 token ids: each row's kind from the
    mix's ``length_seed`` (the same rows for every seed), its tokens from
    the run's seed."""
    n, B, L = traffic["pool"], traffic["batch"], traffic["seq_len"]
    shape_rng = np.random.default_rng(traffic["length_seed"])
    kinds = list(traffic["prompt_kinds"])
    share = np.asarray([traffic["prompt_kinds"][k] for k in kinds], float)
    rng = np.random.default_rng(tr.seed_int(seed))
    run = traffic.get("run_length", 16)
    rows = [tr.make_prompt(rng, kinds[int(shape_rng.choice(
        len(kinds), p=share / share.sum()))], L, vocab, run)
        for _ in range(n * B)]
    return torch.as_tensor(np.stack(rows).reshape(n, B, L)).to(device)


def flops_per_batch(cfg: dict, B: int, L: int) -> float:
    """The dense encoder: every token's projections and FFN, attention over
    all L columns, and the LM head on every position."""
    return B * L * (fl.proj_flops(cfg) + fl.head_flops(cfg)) \
        + B * L * fl.attn_flops(cfg, L)


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, limits: dict, t_start: float, check_fn=None) -> dict:
    from repro_torch.models import forward

    model = importlib.import_module(f"perfbench.models.{cfg['family']}")
    arch = model.arch_config(cfg, traffic["attn_backend"])
    params = model.make_weights(cfg, tr.seed_int(seed), device)
    pool = batches(traffic, cfg["vocab_size"], seed, device)
    n_pool, B, L = pool.shape
    chk = traffic["check"]
    rng = np.random.default_rng(tr.seed_int(seed) ^ 0xC0FFEE)
    pick = sorted(rng.choice(n_pool, min(chk["batches"], n_pool),
                             replace=False).tolist())
    rows = sorted(rng.choice(B, min(chk["rows"], B), replace=False).tolist())
    for i in range(traffic["warmup_batches"]):
        forward(arch, params, pool[i % n_pool])
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    phases = PhaseLog() if trace else None
    fwd = phases.wrap(forward, "forward") if trace else forward
    setup_s = clock() - t_start

    kept, batch_s = {}, []

    def loop():
        sync()
        t0 = clock()
        i = 0
        while True:
            ta = clock()
            logits = fwd(arch, params, pool[i % n_pool])
            sync()
            tb = clock()
            batch_s.append(tb - ta)
            if i < n_pool and i in pick:
                kept[i] = logits[rows].clone()
            del logits
            i += 1
            if tb - t0 >= seconds:
                return t0, tb, i

    if trace:
        with profiled() as prof:
            t0, t1, n = loop()
        stop_s = clock() - t1
    else:
        prof = None
        t0, t1, n = loop()
    rec = {"tokens": n * B * L, "window_s": t1 - t0, "setup_s": setup_s,
           "batch_s": batch_s, "dense_flops": n * flops_per_batch(cfg, B, L),
           "attempted": n, "failed": 0,
           "peak_bytes": (torch.cuda.max_memory_allocated()
                          if torch.cuda.is_available() else 0)}
    if trace:
        t = clock()
        rec["trace"] = summarize(prof, phases.spans)
        rec["trace"].update(profiler_stop_s=stop_s, reading_s=clock() - t)
    del prof
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    rec["check"] = (check_fn or check)(cfg, params, pool, kept, rows, limits)
    return rec


# a position whose logits lie within this share of the reference's largest
# logit of the reference's is on it up to float32 rounding (sound runs read
# 0 there, bit for bit, where the plans agree)
POSITION_OFF = 1e-3


def reference_errors(cfg, params, pool, kept, rows,
                     precision: str = "fp32") -> List[torch.Tensor]:
    """Per kept batch, :func:`reference.bert.position_errors` of the
    program's logits (or, with ``precision``, of the reference in that
    precision put in the program's place) against the float32 reference."""
    from perfbench.reference.bert import Bert, position_errors
    ref = Bert(cfg, params)
    judge = Bert(cfg, params, precision) if precision != "fp32" else None
    return [position_errors(got if judge is None
                            else judge.logits(pool[i], rows),
                            ref.logits(pool[i], rows))
            for i, got in sorted(kept.items())]


def error_numbers(errs: List[torch.Tensor]) -> dict:
    """The numbers the cell may compare, over the kept batches' position
    errors: ``batches_off_pct``, the share of batches with a position more
    than ``POSITION_OFF`` off; ``logit_error``, the largest position error;
    ``positions_off_pct``, the share of positions more than
    ``POSITION_OFF`` off.  A batch is planned whole (its quantization
    scales span it), so a last-bit difference that moves one of its plan's
    scales moves every position of that batch, and of no other."""
    e = torch.cat(errs).double()
    off = [float(b.max()) > POSITION_OFF for b in errs]
    return {"batches_off_pct": 100.0 * sum(off) / len(off),
            "logit_error": float(e.max()),
            "positions_off_pct": 100.0 * float((e > POSITION_OFF).double()
                                               .mean())}


def check(cfg, params, pool, kept, rows, limits) -> dict:
    """Each number compared, beside its limit: those that the cell's
    limits file names."""
    out = {"batches_checked": {"value": len(kept), "limit": 1,
                               "at_least": True}}
    if kept:
        got = error_numbers(reference_errors(cfg, params, pool, kept, rows))
        for name, v in got.items():
            if name in limits:
                out[name] = {"value": v, "limit": limits[name]}
    return out
