"""Readings that set a cell's limits: the program's number over many seeds,
and the control's.

    python3 -m perfbench.harness.calibrate --workload <name> \\
        --seeds 1,2,3 --seconds 20 [--control tf32] [--out file.jsonl]

For each seed, in one process: the cell's set-up and window, then every
number the check can compare, for the program (``serve.gap_numbers``, or
``encode.error_numbers``) and, with ``--control``, for the control:
the reference computed in that lower precision put in the program's place,
read at each position as the gap of the token it puts first (or as its
logit error).  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time


def readings(kind: str, args: tuple, control):
    """``(program's numbers, control's numbers)`` of one run's sample."""
    from perfbench.harness import encode, serve
    if kind == "encode":
        cfg, params, pool, kept, rows, _ = args
        prog = encode.error_numbers(encode.reference_errors(
            cfg, params, pool, kept, rows))
        ctl = (encode.error_numbers(encode.reference_errors(
            cfg, params, pool, kept, rows, control)) if control else None)
        return prog, ctl
    cfg, params, replays, eng, _, _, device = args
    if not replays:
        return None, None
    prog = serve.gap_numbers(serve.reference_gaps(cfg, params, replays, eng,
                                                  device))
    ctl = (serve.gap_numbers(serve.reference_gaps(cfg, params, replays, eng,
                                                  device, control))
           if control else None)
    return prog, ctl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from perfbench import run as bench
    bench._env()
    import torch
    _, cell, cfg, traffic, limits = bench.load_cell(args.workload)
    runner = importlib.import_module(f"perfbench.harness.{traffic['kind']}")
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        got = {}

        def both(*a):
            t = time.monotonic()
            got["program"], got["control"] = readings(traffic["kind"], a,
                                                      args.control)
            got["check_s"] = time.monotonic() - t
            return {}

        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        rec = runner.run(cfg, traffic, seed, args.seconds, False,
                         torch.device("cuda"), limits, t0, check_fn=both)
        row = {"workload": args.workload, "seed": seed,
               "program": got.get("program"), "control": got.get("control"),
               "check_s": got.get("check_s"),
               "tokens": rec["tokens"], "window_s": rec["window_s"],
               "setup_s": rec["setup_s"], "run_s": time.monotonic() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
