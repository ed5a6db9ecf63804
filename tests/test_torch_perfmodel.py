"""The port's copy of the ESACT performance model against the reference's:
every function and constant on a grid of layer shapes and reductions,
exactly (the same Python arithmetic), ``reductions_from_report`` on a
reference ``reduction_report``, and no import of torch or of either
package.
"""

from __future__ import annotations

import ast
import dataclasses
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro import perfmodel as jpm
from repro.core import SPLSConfig, build_plan, reduction_report
from repro.perfmodel import energy as jenergy
from repro_torch import perfmodel as tpm

SHAPES = [(128, 256, 8, 1024), (384, 768, 12, 3072), (4096, 1024, 16, 3072)]
REDUCTIONS = [{"qkv": 0.0, "attention": 0.0, "ffn": 0.0},
              {"qkv": 0.65, "attention": 0.94, "ffn": 0.5},
              {"qkv": 0.36, "attention": 0.961, "ffn": 0.0},
              {"attention": 0.2}]
CONFIGS = [None, dict(util_before_dynamic=0.7, progressive_overlap=0.5)]


def test_constants_equal_reference():
    assert tpm.ESACT_AREA_POWER == jpm.ESACT_AREA_POWER
    assert tpm.BASELINES == jpm.BASELINES
    assert tpm.total_power_w() == jenergy.total_power_w()
    assert tpm.total_area_mm2() == jenergy.total_area_mm2()
    assert dataclasses.asdict(tpm.ESACTConfig()) == \
        dataclasses.asdict(jpm.ESACTConfig())
    assert tpm.ESACTConfig().macs_per_cycle == jpm.ESACTConfig().macs_per_cycle


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("over", CONFIGS)
def test_model_equals_reference(shape, over):
    L, D, H, d_ff = shape
    tc, jc = tpm.ESACTConfig(**(over or {})), jpm.ESACTConfig(**(over or {}))
    for red, prog, dyn in itertools.product(REDUCTIONS + [None],
                                            (False, True), (False, True)):
        assert tpm.stage_cycles(tc, L, D, H, d_ff, red, prog, dyn) == \
            jpm.stage_cycles(jc, L, D, H, d_ff, red, prog, dyn)
    for red in REDUCTIONS:
        sb = tpm.speedup_breakdown(L, D, H, d_ff, red, tc)
        assert sb == jpm.speedup_breakdown(L, D, H, d_ff, red, jc)
        assert sb["end_to_end_speedup"] == pytest.approx(
            sb["spls_speedup"] * sb["progressive_speedup"]
            * sb["dynamic_speedup"], rel=1e-12)
        assert tpm.energy_efficiency(L, D, H, d_ff, red, tc) == \
            jpm.energy_efficiency(L, D, H, d_ff, red, jc)
        a = red.get("attention", 0.0)
        assert tpm.attention_level_comparison(L, D, H, a, tc) == \
            jpm.attention_level_comparison(L, D, H, a, jc)


def test_reductions_from_report():
    """A reference ``reduction_report`` fed through the glue gives the
    model's keys and the same speedups as the hand mapping of the
    reference's throughput benchmark."""
    r = np.random.default_rng(0)
    x = r.normal(size=(1, 64, 64)).astype(np.float32)
    w = [r.normal(size=(64, 64)).astype(np.float32) * 0.125
         for _ in range(2)]
    plan = build_plan(jnp.asarray(x), *map(jnp.asarray, w), 4, SPLSConfig())
    rep = reduction_report(plan, 64, 256, causal=True)
    red = tpm.reductions_from_report(rep)
    hand = {"qkv": float(rep["qkv_reduction"]),
            "attention": float(rep["attention_reduction"]),
            "ffn": float(rep["ffn_reduction"])}
    assert red == hand
    assert tpm.speedup_breakdown(64, 64, 4, 256, red) == \
        jpm.speedup_breakdown(64, 64, 4, 256, hand)


def test_imports_nothing_but_the_standard_library():
    root = Path(tpm.__file__).parent
    for f in root.glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in ("__future__", "dataclasses",
                                              "typing"), (f.name, name)
