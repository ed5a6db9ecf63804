"""The port's ``BENCH_serving.json`` report and its two command lines.

``serving_report`` of the port's engine passes the port's and the
reference's ``validate_report`` (with nonzero FLOPs saved in all four
components) and has the reference report's keys and sparsity entries on the
same workload; the validator names every problem; ``python -m
repro_torch.serve_batch --device cpu`` runs each of the six ``serve_batch``
lines of ``.github/workflows/ci.yml``, and the telemetry job's report passes
``python -m repro_torch.observability ... --require-nonzero-flops`` (and the
reference's CLI).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.observability import validate_report as j_validate_report
from repro_torch.observability import (SCHEMA_VERSION, Histogram, latency_ms,
                                       serving_report, validate_report,
                                       write_report)
from repro_torch.observability.report import main as report_main
from repro_torch.serve_batch import main as serve_batch_main

from repro_torch.serve_batch import demo_prompts

from _torch_parity import demo_pair, serve_both

ROOT = Path(__file__).resolve().parents[1]

# ci.yml's six serve_batch command lines (:42-44, :49-51, :56-58, :83-86,
# :112-116, :143-149), without the report outputs
CI_LINES = [
    "--requests 4 --slots 2 --prompt-len 20 --max-new 4 --paged "
    "--page-size 4 --prefill-chunk 8",
    "--requests 3 --slots 2 --prompt-len 16 --max-new 4 --paged "
    "--page-size 4 --spls",
    "--requests 3 --slots 2 --prompt-len 96 --max-new 4 --paged "
    "--page-size 8 --prefill-chunk 16 --spls",
    "--requests 3 --slots 2 --prompt-len 96 --max-new 4 --paged "
    "--page-size 8 --prefill-chunk 16 --spls --compute-backend packed_xla "
    "--s-threshold 0.9",
    "--requests 3 --slots 2 --prompt-len 96 --max-new 4 --paged "
    "--page-size 8 --prefill-chunk 16 --spls --compute-backend packed_xla "
    "--s-threshold 0.9 --vote-horizon 1 --prune-vote 1.0 --k-ratio 0.05",
    "--requests 3 --slots 2 --prompt-len 96 --max-new 4 --paged "
    "--page-size 8 --prefill-chunk 16 --spls --compute-backend packed_xla "
    "--s-threshold 0.9 --vote-horizon 1 --prune-vote 1.0 --k-ratio 0.05 "
    "--capacity-margin 1.0 --prompt-repeat 16",
]


@pytest.fixture(scope="module")
def reports():
    """Both packages' engines on the telemetry job's workload (ci.yml
    :143-149): ``(reference report, port report)``."""
    jc, tc, jp, tp = demo_pair(True, 0.05, 0.9)
    prompts = demo_prompts(3, 96, tc.vocab_size, repeat=16)
    (jeng, _), (teng, _) = serve_both(jc, tc, jp, tp, prompts, dict(
        n_slots=2, max_len=96 + 12, page_size=8, prefill_chunk=16,
        compute_backend="packed_xla", vote_horizon=1, spls_prune_vote=1.0,
        capacity_margin=1.0))
    from repro.observability import serving_report as j_serving_report

    return (j_serving_report(jeng, wall_s=1.0),
            serving_report(teng, wall_s=1.0))


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + str(k))
        if isinstance(v, dict) and k != "counters":
            out |= _keys(v, f"{prefix}{k}.")
    return out


def test_report_passes_both_validators_and_matches_reference(reports):
    jr, tr = reports
    validate_report(tr, require_nonzero_flops=True)
    j_validate_report(tr, require_nonzero_flops=True)
    assert tr["schema_version"] == SCHEMA_VERSION == jr["schema_version"]
    assert _keys(tr) == _keys(jr)
    assert tr["counters"].keys() == jr["counters"].keys()
    assert tr["sparsity"].keys() == jr["sparsity"].keys()
    for k, v in jr["sparsity"].items():
        assert tr["sparsity"][k] == pytest.approx(v, rel=1e-12), k
    for part in ("requests", "pool", "capacity"):
        assert tr[part] == jr[part], part
    assert tr["throughput"]["tokens"] == jr["throughput"]["tokens"]
    for lat in ("ttft_ms", "tpot_ms", "e2e_ms"):
        assert tr["latency"][lat]["n"] == jr["latency"][lat]["n"] > 0
        assert tr["latency"][lat]["p50"] > 0
    assert tr["engine"]["kind"] == jr["engine"]["kind"]
    assert tr["engine"]["compute_backend"] == "packed_torch"


def test_validator_names_all_problems(reports):
    report = json.loads(json.dumps(reports[1]))
    del report["latency"]["ttft_ms"]
    report["schema_version"] = 99
    report["sparsity"]["flops_saved_kv_pct"] = 0.0
    with pytest.raises(ValueError) as ei:
        validate_report(report, require_nonzero_flops=True)
    msg = str(ei.value)
    assert "ttft_ms" in msg and "schema_version 99" in msg
    assert "flops_saved_kv_pct must be > 0" in msg
    report["schema_version"] = SCHEMA_VERSION
    with pytest.raises(ValueError, match="ttft_ms"):
        validate_report(report)


def test_latency_summary():
    assert latency_ms(None) == {"p50": None, "p99": None, "mean": None,
                                "n": 0}
    h = Histogram("t")
    for s in (0.001, 0.002, 0.003):
        h.observe(s)
    got = latency_ms(h)
    assert got["n"] == 3
    assert got["p50"] == pytest.approx(2.0)
    assert got["mean"] == pytest.approx(2.0)


def test_report_cli(reports, tmp_path, capsys):
    path = tmp_path / "r.json"
    write_report(str(path), reports[1])
    assert report_main([str(path), "--require-nonzero-flops"]) == 0
    assert "valid (schema v1)" in capsys.readouterr().out
    dense = json.loads(path.read_text())
    dense["sparsity"]["flops_saved_attn_pct"] = 0.0
    write_report(str(path), dense)
    assert report_main([str(path)]) == 0
    assert report_main([str(path), "--require-nonzero-flops"]) == 1


@pytest.mark.parametrize("line", CI_LINES,
                         ids=[f"ci{i}" for i in range(len(CI_LINES))])
def test_serve_batch_runs_ci_line(line, capsys):
    assert serve_batch_main(line.split() + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    n_req = int(line.split()[1])
    assert out[0].endswith(f"retired={n_req}")
    assert out[2].startswith("pool: peak_pages=")
    assert out[3].startswith("compute: backend=")
    if "--vote-horizon" in line:
        assert "backend=packed_torch" in out[3]


def test_serve_batch_dense_engine(capsys):
    """Without ``--paged`` the dense fixed-slot engine serves."""
    assert serve_batch_main("--requests 2 --slots 2 --prompt-len 12 "
                            "--max-new 3 --device cpu".split()) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "requests=2 slots=2 paged=False spls=False retired=2"


def test_telemetry_job_command_lines(tmp_path):
    """The telemetry job as ci.yml runs it, in subprocesses: the port's
    serve_batch writes the report and the trace, then the port's report
    CLI (and the reference's) accepts it with ``--require-nonzero-flops``.
    """
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    bench, trace = tmp_path / "BENCH_serving.json", tmp_path / "trace.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve_batch", "--device", "cpu"]
        + CI_LINES[-1].split()
        + ["--bench-json", str(bench), "--trace-json", str(trace)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert f"wrote {bench}" in run.stdout
    assert json.loads(trace.read_text())
    for pkg in ("repro_torch.observability", "repro.observability"):
        check = subprocess.run(
            [sys.executable, "-m", pkg, str(bench),
             "--require-nonzero-flops"], cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=300)
        assert check.returncode == 0, (pkg, check.stderr)
        assert "valid (schema v1)" in check.stdout
