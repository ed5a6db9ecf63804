"""Drive the dry-run sweep: every (arch x shape) cell on the single-pod
mesh and the multi-pod mesh (the reference's ``repro.launch.dryrun_all``).

Each cell runs in a fresh subprocess (``python -m
repro_torch.launch.dryrun``: each joins its own ``fake`` process group,
and one cell's failure or timeout is not the sweep's) and results append
to a JSON-lines file, so the sweep is resumable.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all \\
      [--out results/dryrun_torch.jsonl] [--meshes 16x16,2x16x16] \\
      [--only arch:shape ...] [--spls] [--timeout 3600]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["run_one", "main"]


def _done_keys(path: Path):
    done = set()
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"],
                          r.get("spls", False)))
            except (ValueError, KeyError):
                pass
    return done


def run_one(arch: str, shape: str, multi_pod: bool, spls: bool,
            timeout: int = 3600) -> dict:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape]
    if multi_pod:
        cmd.append("--multi-pod")
    if spls:
        cmd.append("--spls")
    mesh = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    # a cell computes on fake tensors: one intra-op thread, so that cells
    # run side by side do not spin idle threads against each other
    env = dict(os.environ, OMP_NUM_THREADS="1")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return {"arch": arch, "shape": shape, "mesh": mesh, "spls": spls,
                "error": f"timeout {timeout}s", "wall_s": time.time() - t0}
    if proc.returncode == 0:
        return json.loads(proc.stdout)
    return {"arch": arch, "shape": shape, "mesh": mesh, "spls": spls,
            "error": proc.stderr[-2000:], "wall_s": time.time() - t0}


def main(argv=None) -> int:
    from repro_torch.configs.registry import all_cells

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--meshes", default="16x16,2x16x16")
    ap.add_argument("--only", nargs="*", default=None,
                    help="arch:shape filters")
    ap.add_argument("--spls", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    done = _done_keys(out)

    cells = list(all_cells(include_skipped=True))
    if args.only:
        want = {tuple(x.split(":")) for x in args.only}
        cells = [c for c in cells if c in want]

    meshes = args.meshes.split(",")
    total = len(cells) * len(meshes)
    i = 0
    for mesh in meshes:
        multi = mesh == "2x16x16"
        for arch, shape in cells:
            i += 1
            if (arch, shape, mesh, args.spls) in done:
                continue
            print(f"[{i}/{total}] {arch} x {shape} on {mesh}"
                  f"{' +spls' if args.spls else ''} ...", flush=True)
            res = run_one(arch, shape, multi, args.spls, args.timeout)
            with out.open("a") as f:
                f.write(json.dumps(res, default=str) + "\n")
            status = ("SKIP" if res.get("skipped")
                      else "ERR" if "error" in res else
                      f"ok trace={res.get('trace_s')}s "
                      f"dom={res.get('roofline', {}).get('dominant')}")
            print(f"    -> {status}", flush=True)
    print("sweep complete:", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
