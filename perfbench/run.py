"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; it names a
configuration (its file under ``perfbench/configs/``) and a traffic mix
(``perfbench/traffic/<traffic>.json``, whose ``kind`` names the runner in
``perfbench/harness/``).  The numbers a run prints are read by one module
per metric, ``perfbench/metrics/<metric>.py``; the limits of the
correctness check are ``perfbench/limits/<workload>.json``.  A later cell,
mix or metric is added as files and entries, without editing these.

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from the window under
``torch.profiler``.  Every run checks what the timed path produced
against the plain reference once the window has closed; the numbers
compared and their limits close standard error and the result line.
Exits non-zero, with no result line, without enough CUDA cards, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name: str) -> tuple:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    limits = json.loads(
        (ROOT / "perfbench" / "limits" / f"{name}.json").read_text())
    return spec, cell, cfg, traffic, limits


def metric_names(spec: dict, cell: str, trace: bool) -> list:
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, rec: dict):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(rec)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def passed(c: dict) -> bool:
    return (c["value"] >= c["limit"] if c.get("at_least")
            else c["value"] <= c["limit"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    spec, cell, cfg, traffic, limits = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats()
    runner = importlib.import_module(f"perfbench.harness.{traffic['kind']}")
    rec = runner.run(cfg, traffic, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda"), limits, T_START)

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"] for m in
             spec["end_to_end"] + spec["per_layer"]}
    metrics = {}
    for m in metric_names(spec, args.workload, bool(args.trace)):
        v = read_metric(m["name"], rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": all(passed(c) for c in rec["check"].values()),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    if args.trace:
        t = rec["trace"]
        device.update(busy_s=t["busy_s"], window_s=rec["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
        print("trace: busy %.6f s of %.6f s; profiler stop %.3f s, reading "
              "%.3f s; device time inside the recorded phases %s" % (
                  t["busy_s"], rec["window_s"], t.get("profiler_stop_s", 0),
                  t.get("reading_s", 0), t.get("device_in_phases")),
              file=sys.stderr)
    out["card"] = power_limit()
    out["check"] = rec["check"]
    for name, c in rec["check"].items():
        word = "at least" if c.get("at_least") else "limit"
        print(f"check {name} {c['value']!r} {word} {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
