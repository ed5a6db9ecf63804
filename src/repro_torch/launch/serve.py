"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Spins up a continuous-batching engine on the smoke form of an
architecture of the registry and drives a synthetic request stream
through it (batched prefill + decode).  ``--paged`` selects the block-pool
paged engine (chunked prefill, admission keyed on free pages, SPLS page
pruning); the default is the dense fixed-slot engine.  Paged serving
requires attention-only periods (SSM state is O(1) per slot and is not
paged).  ``--device`` picks the device (default: the card).

The flags, defaults, skip messages and printed JSON are those of the
reference's ``repro.launch.serve``.  Prompts (request ``i`` from
``torch.Generator().manual_seed(i)``) and weights (``init_params(cfg,
seed=0)``) come from torch generators, since JAX's PRNG cannot be
reproduced here, so the tokens differ from the reference launcher's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--spls", action="store_true")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; pass "
                         "'cpu' to run on the CPU)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serving import (PagedServingEngine, Request,
                                     ServeConfig, ServingEngine)

    cfg = get_config(args.arch).smoke()
    cfg = dataclasses.replace(cfg, remat=False)
    if args.spls and cfg.has_attn:
        from repro_torch.core.spls import SPLSConfig
        cfg = dataclasses.replace(cfg, spls=SPLSConfig(
            enabled=True, k_ratio=0.25, s_threshold=0.6, f_threshold=2,
            window=4, causal=cfg.causal))
    if cfg.input_mode != "tokens":
        print(f"{cfg.name}: embeddings-input arch; engine demo uses tokens "
              "-- skipping")
        return 0
    if args.paged and cfg.has_mamba:
        print(f"{cfg.name}: hybrid/SSM arch; paged engine is attention-only "
              "-- skipping")
        return 0

    device = resolve_device(args.device)
    params = init_params(cfg, seed=0, device=device)
    scfg = ServeConfig(n_slots=args.slots,
                       max_len=args.prompt_len + args.max_new + 8,
                       page_size=args.page_size)
    eng = (PagedServingEngine if args.paged else ServingEngine)(
        cfg, params, scfg, device=device)
    reqs = []
    for i in range(args.requests):
        prompt = torch.randint(0, cfg.vocab_size, (args.prompt_len,),
                               generator=torch.Generator().manual_seed(i),
                               dtype=torch.int32)
        r = Request(rid=i, prompt=prompt, max_new_tokens=args.max_new)
        reqs.append(r)
        eng.submit(r)
    done = eng.run_until_drained(max_ticks=1000)
    out = {"requests": len(reqs), "retired": len(done),
           "all_done": all(r.done for r in reqs),
           "outputs": {r.rid: r.output[:8] for r in reqs[:4]}}
    if args.paged:
        out["pool"] = {k: eng.stats[k] for k in
                       ("peak_pages", "preemptions", "prefill_chunks")}
    print(json.dumps(out, indent=1))
    return 0 if out["all_done"] else 1


if __name__ == "__main__":
    sys.exit(main())
