"""Aggregate telemetry into the schema-versioned ``BENCH_serving.json``.

A copy of the reference package's report module (the port never imports
the reference): TTFT / TPOT / end-to-end latency p50 / p99, goodput,
preemption and requeue rates, per-component ``flops_saved_*``, pool and
predictor-cache bytes, and capacity-controller occupancy, from a drained
engine's telemetry.  ``python -m repro_torch.serve_batch --bench-json``
writes one per serving run; this module's CLI validates it::

    python -m repro_torch.observability BENCH_serving.json \
        [--require-nonzero-flops]

Schema (version 1, the reference's) -- required keys checked by
:func:`validate_report`:

* ``schema_version``: int
* ``latency.ttft_ms`` / ``latency.tpot_ms``: ``{p50, p99, mean, n}``
* ``requests``: ``{submitted, retired, aborted, preemptions, requeues,
  preemption_rate, requeue_rate}``
* ``throughput``: ``{tokens, wall_s, tok_s, goodput_tok_s}``
* ``sparsity.flops_saved_{qkv,kv,attn,ffn}_pct``: floats

Extra keys (``pool``, ``capacity``, ``counters``, workload descriptors)
are allowed and ignored by validation.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

__all__ = ["SCHEMA_VERSION", "latency_ms", "serving_report",
           "validate_report", "write_report"]

SCHEMA_VERSION = 1

_FLOPS_COMPONENTS = ("qkv", "kv", "attn", "ffn")


def latency_ms(hist) -> dict:
    """p50/p99/mean summary of a seconds histogram, in milliseconds."""
    if hist is None or getattr(hist, "count", 0) == 0:
        return {"p50": None, "p99": None, "mean": None, "n": 0}
    return {"p50": hist.percentile(50.0) * 1e3,
            "p99": hist.percentile(99.0) * 1e3,
            "mean": hist.mean * 1e3, "n": hist.count}


def serving_report(engine, wall_s: Optional[float] = None,
                   extra: Optional[dict] = None) -> dict:
    """Build the schema-v1 report from a drained serving engine.

    ``wall_s`` overrides the wall-clock denominator (defaults to time
    since the engine's telemetry started); ``extra`` is merged in at the
    top level (benchmark rows, workload descriptors).
    """
    tel = engine.telemetry
    m = tel.metrics
    if wall_s is None:
        wall_s = max(tel.now() - tel.started_ts, 1e-9)

    recs = list(tel.requests.values())
    retired = [r for r in recs if r.outcome == "retired"]
    aborted = [r for r in recs if r.outcome == "aborted"]
    tokens = sum(r.n_tokens for r in recs)
    good_tokens = sum(r.n_tokens for r in retired)
    preempts = sum(r.n_preempts for r in recs)
    admits = max(len([r for r in recs if r.admit_ts is not None]), 1)

    stats = engine.stats
    saved = stats.get("flops_saved_pct", {})
    sparsity = {f"flops_saved_{c}_pct": float(saved.get(c, 0.0))
                for c in _FLOPS_COMPONENTS}
    kept = m.get("spls/kept_ratio")
    if kept is not None and kept.count:
        sparsity["kept_ratio"] = kept.summary()
    for name in ("spls/horizon_finalized_cols",
                 "spls/horizon_kv_capacity_drops"):
        inst = m.get(name)
        if inst is not None:
            sparsity[name.split("/", 1)[1]] = inst.value

    report = {
        "schema_version": SCHEMA_VERSION,
        "engine": {
            "kind": type(engine).__name__,
            "compute_backend": stats.get("compute_backend"),
            "telemetry": tel.enabled,
        },
        "requests": {
            "submitted": len(recs),
            "retired": len(retired),
            "aborted": len(aborted),
            "preemptions": preempts,
            "requeues": preempts,       # preemption-by-eviction requeues
            "preemption_rate": preempts / admits,
            "requeue_rate": preempts / admits,
        },
        "latency": {
            "ttft_ms": latency_ms(m.get("latency/ttft_s")),
            "tpot_ms": latency_ms(m.get("latency/tpot_s")),
            "e2e_ms": latency_ms(m.get("latency/e2e_s")),
        },
        "throughput": {
            "tokens": tokens,
            "wall_s": wall_s,
            "tok_s": tokens / wall_s,
            # goodput: tokens of requests that actually retired (aborted
            # work is wasted throughput)
            "goodput_tok_s": good_tokens / wall_s,
        },
        "sparsity": sparsity,
        "counters": m.snapshot(),
    }

    pool = getattr(engine, "pool", None)
    if pool is not None:
        pool_info = {"n_pages": pool.n_pages, "page_size": pool.page_size,
                     "peak_pages": pool.peak_in_use,
                     "pages_in_use": pool.pages_in_use,
                     "guard_trips": pool.guard_trips}
        for name in ("pool/kv_bytes", "pool/pred_cache_bytes"):
            g = m.get(name)
            if g is not None:
                pool_info[name.split("/", 1)[1]] = g.value
        report["pool"] = pool_info
    caps = {}
    for key in ("capacity_q", "capacity_ffn", "capacity_kv"):
        if key in stats:
            caps[key[len("capacity_"):]] = stats[key]
    if caps:
        report["capacity"] = caps
    if extra:
        report.update(extra)
    return report


def validate_report(report: dict,
                    require_nonzero_flops: bool = False) -> None:
    """Raise ValueError naming every schema violation at once."""
    problems = []

    def need(path, typ=None):
        node = report
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                problems.append(f"missing key: {path}")
                return None
            node = node[part]
        if typ is not None and not isinstance(node, typ):
            problems.append(
                f"{path}: expected {typ}, got {type(node).__name__}")
        return node

    ver = need("schema_version", int)
    if ver is not None and ver != SCHEMA_VERSION:
        problems.append(f"schema_version {ver} != {SCHEMA_VERSION}")
    for lat in ("ttft_ms", "tpot_ms"):
        for q in ("p50", "p99", "mean", "n"):
            need(f"latency.{lat}.{q}")
    for k in ("submitted", "retired", "aborted", "preemptions",
              "requeues"):
        need(f"requests.{k}", int)
    for k in ("preemption_rate", "requeue_rate"):
        need(f"requests.{k}", (int, float))
    for k in ("tokens", "wall_s", "tok_s", "goodput_tok_s"):
        need(f"throughput.{k}", (int, float))
    for c in _FLOPS_COMPONENTS:
        v = need(f"sparsity.flops_saved_{c}_pct", (int, float))
        if require_nonzero_flops and v is not None and not v > 0.0:
            problems.append(
                f"sparsity.flops_saved_{c}_pct must be > 0, got {v}")
    if problems:
        raise ValueError("invalid BENCH_serving.json:\n  "
                         + "\n  ".join(problems))


def write_report(path: str, report: dict) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True, default=str)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate a BENCH_serving.json against schema "
                    f"version {SCHEMA_VERSION}")
    ap.add_argument("path")
    ap.add_argument("--require-nonzero-flops", action="store_true",
                    help="additionally require every "
                         "sparsity.flops_saved_*_pct > 0")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        report = json.load(f)
    try:
        validate_report(report,
                        require_nonzero_flops=args.require_nonzero_flops)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    lat = report["latency"]
    print(f"{args.path}: valid (schema v{report['schema_version']}); "
          f"ttft_p50={lat['ttft_ms']['p50']}ms "
          f"tpot_p50={lat['tpot_ms']['p50']}ms "
          f"tok_s={report['throughput']['tok_s']:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
