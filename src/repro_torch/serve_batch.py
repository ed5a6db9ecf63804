"""Serve a small model with batched requests through the port's
continuous-batching engines: the dense fixed-slot baseline or the
block-pool paged engine (chunked prefill, admission on free pages, SPLS
page pruning, packed compute, the vote horizon), with the telemetry
report::

    PYTHONPATH=src python -m repro_torch.serve_batch [--paged] [--spls] \\
        [--device cpu] [--bench-json BENCH_serving.json]
    PYTHONPATH=src python -m repro_torch.observability BENCH_serving.json \\
        --require-nonzero-flops

The flags, the ``serve-demo`` model (4 layers x 128, 8 heads, 4 KV heads)
and the printed lines are those of the reference's
``examples/serve_batch.py``.  ``--device`` picks the device (default: the
card).  Prompts come from numpy generators seeded per request and weights
from ``init_params(cfg, seed=0)``, so the tokens differ from the reference
CLI's, whose prompts and weights come from JAX's PRNG.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, BlockCfg
from repro_torch.core.spls import SPLSConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import (PagedServingEngine, Request, ServeConfig,
                                 ServingEngine)

__all__ = ["demo_config", "demo_prompts", "main"]


def demo_config(spls: bool, k_ratio: float = 0.25,
                s_threshold: float = 0.6) -> ArchConfig:
    """The reference CLI's ``serve-demo`` model (causal, float32)."""
    return ArchConfig(
        name="serve-demo", n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
        head_dim=16, d_ff=512, vocab_size=512,
        period=(BlockCfg(mixer="attn"),), remat=False,
        spls=SPLSConfig(enabled=spls, k_ratio=k_ratio,
                        s_threshold=s_threshold, f_threshold=3, window=8,
                        causal=True))


def demo_prompts(n: int, prompt_len: int, vocab: int,
                 repeat: int = None) -> list:
    """``n`` int32 prompts, request ``i`` from ``default_rng(100 + i)``;
    with ``repeat`` N, runs of N equal tokens (a motif resampled every N
    positions)."""
    prompts = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        if repeat:
            motifs = rng.integers(0, vocab, size=prompt_len // repeat + 1)
            toks = np.repeat(motifs, repeat)[:prompt_len]
        else:
            toks = rng.integers(0, vocab, size=prompt_len)
        prompts.append(toks.astype(np.int32))
    return prompts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--spls", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="block-pool paged KV cache engine")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--compute-backend", default=None,
                    choices=["dense", "packed_xla", "packed_pallas", "auto",
                             "packed_torch", "packed_cuda"],
                    help="end-to-end sparse compute on the SPLS chunked "
                         "prefill path (repro_torch.sparse_compute; the "
                         "reference's names are aliases of the port's)")
    ap.add_argument("--s-threshold", type=float, default=0.6,
                    help="SPLS similarity threshold (higher -> more rows "
                         "similar -> more packed-compute savings)")
    ap.add_argument("--vote-horizon", type=int, default=None,
                    help="finalize the SPLS column prune vote after this "
                         "many chunks instead of end-of-prefill "
                         "(core.planner; 1 packs the K/V projection)")
    ap.add_argument("--prune-vote", type=float, default=0.5,
                    help="cross-head agreement fraction a column must win "
                         "to keep its page slot (and, under a finite "
                         "--vote-horizon, to keep its K/V projection)")
    ap.add_argument("--k-ratio", type=float, default=0.25,
                    help="SPLS row-wise top-k ratio (smaller -> sparser "
                         "column votes -> more K/V pruning)")
    ap.add_argument("--capacity-margin", type=float, default=1.25,
                    help="capacity-controller safety margin over the EMA "
                         "estimate (1.0 = tightest buckets)")
    ap.add_argument("--prompt-repeat", type=int, default=None,
                    metavar="N",
                    help="make prompts repetitive: runs of N equal tokens "
                         "(adjacent rows become locally similar, so the "
                         "SPLS packed path actually sparsifies -- random "
                         "prompts barely do)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable the serving telemetry (no-op sinks; "
                         "the stats counters keep working)")
    ap.add_argument("--bench-json", default=None, metavar="PATH",
                    help="write the telemetry-derived BENCH_serving.json "
                         "report to PATH (requires telemetry)")
    ap.add_argument("--trace-json", default=None, metavar="PATH",
                    help="write the Chrome trace (open in "
                         "https://ui.perfetto.dev) to PATH")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; pass "
                         "'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    if args.bench_json and args.no_telemetry:
        ap.error("--bench-json needs telemetry (drop --no-telemetry)")
    device = resolve_device(args.device)

    cfg = demo_config(args.spls, args.k_ratio, args.s_threshold)
    params = init_params(cfg, seed=0, device=device)
    scfg = ServeConfig(n_slots=args.slots,
                       max_len=args.prompt_len + args.max_new + 8,
                       page_size=args.page_size,
                       prefill_chunk=args.prefill_chunk,
                       compute_backend=args.compute_backend,
                       vote_horizon=args.vote_horizon,
                       spls_prune_vote=args.prune_vote,
                       capacity_margin=args.capacity_margin,
                       telemetry=not args.no_telemetry)
    eng = (PagedServingEngine if args.paged else ServingEngine)(
        cfg, params, scfg, device=device)

    reqs = [Request(rid=i, prompt=p, max_new_tokens=args.max_new)
            for i, p in enumerate(demo_prompts(
                args.requests, args.prompt_len, cfg.vocab_size,
                args.prompt_repeat))]
    for r in reqs:
        eng.submit(r)

    t0 = time.perf_counter()
    done = eng.run_until_drained(max_ticks=2000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in reqs)
    print(f"requests={len(reqs)} slots={args.slots} paged={args.paged} "
          f"spls={args.spls} retired={len(done)}")
    print(f"decoded {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s on {device})")
    if args.paged:
        print(f"pool: peak_pages={eng.stats['peak_pages']} "
              f"preemptions={eng.stats['preemptions']} "
              f"prefill_chunks={eng.stats['prefill_chunks']}")
        fs = eng.stats["flops_saved_pct"]
        print(f"compute: backend={eng.stats['compute_backend']} "
              f"flops_saved qkv={fs['qkv']:.1f}% attn={fs['attn']:.1f}% "
              f"ffn={fs['ffn']:.1f}% kv={fs.get('kv', 0.0):.1f}%")
    if not all(r.done for r in reqs) or len(done) != len(reqs):
        raise SystemExit("queue did not drain")
    if args.bench_json:
        from repro_torch.observability import serving_report, write_report

        report = serving_report(eng, wall_s=dt, extra={
            "workload": {"requests": args.requests,
                         "prompt_len": args.prompt_len,
                         "max_new": args.max_new,
                         "prompt_repeat": args.prompt_repeat,
                         "device": str(device)}})
        write_report(args.bench_json, report)
        lat = report["latency"]
        print(f"wrote {args.bench_json} "
              f"(ttft_p50={lat['ttft_ms']['p50']:.1f}ms "
              f"tpot_p50={lat['tpot_ms']['p50']:.2f}ms)")
    if args.trace_json:
        eng.telemetry.trace.validate()
        eng.telemetry.trace.write(args.trace_json)
        print(f"wrote {args.trace_json} "
              f"({len(eng.telemetry.trace.events)} events; open in "
              f"https://ui.perfetto.dev)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
