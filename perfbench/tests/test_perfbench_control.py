"""The control has to come out not correct: the plain reference in the
program's place, computed in TF32 (the precision below the float32 the
configurations state), on three seeds at each cell's own size, held to the
cell's committed limit.  Needs the card; run there with

    python3 -m pytest -q -m cuda perfbench/tests/test_perfbench_control.py
"""

import importlib
import time

import pytest
import torch

from perfbench.tests._tiny import CELLS, limits

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    from perfbench import run as bench
    bench._env()
    return torch.device("cuda")


def _control_reading(workload, seed, device):
    """The control's numbers on one seed, at the cell's own size and
    window (``perfbench.harness.calibrate.readings``)."""
    from perfbench import run as bench
    from perfbench.harness import calibrate
    spec, _, cfg, traffic, lim = bench.load_cell(workload)
    runner = importlib.import_module(f"perfbench.harness.{traffic['kind']}")
    got = {}

    def ctl(*a):
        got.update(calibrate.readings(traffic["kind"], a, "tf32")[1])
        return {}
    runner.run(cfg, traffic, seed, spec["run_seconds"], False, device, lim,
               time.monotonic(), check_fn=ctl)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_the_limit(workload, seed, card):
    got = _control_reading(workload, seed, card)
    lim = limits(workload)
    assert any(got[n] > lim[n] for n in lim if n in got)
