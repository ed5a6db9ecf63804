"""The port's two examples of the SPLS pipeline: ``repro_torch.quickstart``
against the reference's ``build_plan`` / ``plan_stats`` /
``reduction_report`` and ``spls_attention`` on the same numpy inputs, and
both examples' ``main`` on the CPU (``spls_ablation`` for 5 steps).

Tolerances: plan masks exact, plan stats and the FLOPs report 1e-6
relative (the port counts in float64), the attention deviation 1e-5.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import SPLSConfig as JSPLSConfig
from repro.core import (build_plan, plan_stats, reduction_report,
                        spls_attention)
from repro_torch import quickstart, spls_ablation

from _torch_parity import n, t


def _inputs(seed=0):
    """The quickstart's AR(1) activations and projections, from numpy."""
    B, L, D = quickstart.B, quickstart.L, quickstart.D
    r = np.random.default_rng(seed)
    eps = r.normal(size=(B, L, D)).astype(np.float32)
    x = np.empty_like(eps)
    x[:, 0] = eps[:, 0]
    for i in range(1, L):
        x[:, i] = 0.9 * x[:, i - 1] + np.float32(0.19 ** 0.5) * eps[:, i]
    ws = [(r.normal(size=(D, D)) * D ** -0.5).astype(np.float32)
          for _ in range(3)]
    return [x] + ws


def test_quickstart_equals_reference():
    x, wq, wk, wv = _inputs()
    B, L, D, H = quickstart.B, quickstart.L, quickstart.D, quickstart.H
    cfg = JSPLSConfig(**dataclasses.asdict(quickstart.SPLS))
    plan = build_plan(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(wk), H,
                      cfg)
    got = quickstart.run(t(x), t(wq), t(wk), t(wv))
    for f, a, b in zip(plan._fields, got["plan"], plan):
        np.testing.assert_array_equal(n(a), np.asarray(b), err_msg=f)
    ref_stats = plan_stats(plan)
    ref_red = reduction_report(plan, D, quickstart.D_FF, causal=False)
    for ref, out in ((ref_stats, got["stats"]), (ref_red, got["reduction"])):
        assert out.keys() == ref.keys()
        for k in ref:
            assert out[k] == pytest.approx(float(ref[k]), rel=1e-6), k
    Dh = D // H
    split = lambda a: jnp.asarray(a).reshape(B, L, H, Dh).swapaxes(1, 2)
    q, k, v = split(x @ wq), split(x @ wk), split(x @ wv)
    a = np.asarray(jnp.exp(jnp.einsum("bhqd,bhkd->bhqk", q, k) * Dh ** -0.5))
    dense = np.einsum("bhqk,bhkd->bhqd", a / a.sum(-1, keepdims=True),
                      np.asarray(v))
    sparse = np.asarray(spls_attention(q, k, v, plan))
    dev = np.linalg.norm(sparse - dense) / np.linalg.norm(dense)
    assert got["deviation"] == pytest.approx(float(dev), abs=1e-5)


def test_quickstart_main(capsys):
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "exact FLOPs reduction" in text and "relative L2 deviation" in text
    assert 0.0 < out["reduction"]["overall_reduction"] < 1.0


def test_spls_ablation_main(capsys):
    out = spls_ablation.main(["--steps", "5", "--device", "cpu"])
    text = capsys.readouterr().out
    rows = out["eval_accuracy"]
    assert len(rows) == 1 + len(spls_ablation.K_GRID) * len(
        spls_ablation.S_GRID)
    assert all(0.0 <= a <= 1.0 for a in rows.values())
    assert "spls k=0.12 s=0.8" in text
