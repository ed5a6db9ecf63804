"""Dry-run cells of the multi-pod and ``--spls`` sweeps against the
reference (``repro_torch.launch.dryrun.run_cell`` beside
``repro.launch.dryrun.run_cell``): h2o-danube3-4b ``decode_32k`` on 2 x 16
x 16, and qwen3-0.6b ``prefill_32k --spls`` on 16 x 16 -- a planning cell,
whose chunked plan runs 64 row blocks a layer, counted by trip count.

Tolerances: argument and alias bytes, model FLOPs, chips, mesh, kind and
``spls`` exact; dot FLOPs per device within 10 % of the reference's (the
sweep's bar; measured 1.0000 and 1.0000).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]

# (arch, shape, multi_pod, spls)
CELLS = (("h2o-danube3-4b", "decode_32k", True, False),
         ("qwen3-0.6b", "prefill_32k", False, True))


@pytest.fixture(scope="module")
def reference():
    """The reference's results of :data:`CELLS`, from one subprocess (where
    it gets its 512 placeholder devices)."""
    code = ("import json; from repro.launch.dryrun import run_cell; "
            "print(json.dumps([run_cell(a, s, multi_pod=m, spls=p) "
            f"for a, s, m, p in {CELLS!r}]))")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=600)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {c: r for c, r in zip(CELLS, res)}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}"
                         f"{'-multi_pod' if c[2] else ''}"
                         f"{'-spls' if c[3] else ''}")
def test_sweep_cell_matches_reference(reference, cell):
    """Argument and alias bytes, model FLOPs, chips, mesh, kind and
    ``spls`` equal to the reference's dry run of the same cell; dot FLOPs
    per device within 10 % (for the SPLS cell: the predictor's products
    on each device's heads, C8)."""
    arch, shape, multi_pod, spls = cell
    ref = reference[cell]
    got = dryrun.run_cell(arch, shape, multi_pod=multi_pod, spls=spls)
    for k in ("argument_bytes_per_device", "alias_bytes_per_device"):
        assert got["memory"][k] == ref["memory"][k], k
    for k in ("model_flops_total", "chips", "mesh", "kind", "spls"):
        assert got[k] == ref[k], k
    assert got["hlo_flops_per_device"] == pytest.approx(
        ref["hlo_flops_per_device"], rel=0.1)
