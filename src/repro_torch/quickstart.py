"""Quickstart: the SPLS mechanism on one attention layer, end to end (the
reference's ``examples/quickstart.py`` on the port).

Runs the paper's pipeline -- HLog prediction -> PAM -> top-k -> SPA ->
local similarity -> MFI -- prints the plan's sparsity and the exact FLOPs
reduction the accelerator would realise, then executes attention dense and
under the plan and reports the output deviation.

  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

``--device`` defaults to the card.  The inputs come from a
``torch.Generator`` with the fixed seed 0; the reference's ``jax.random``
draws cannot be reproduced, so the numbers differ from its run.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import (SPLSConfig, build_plan, plan_stats,
                              reduction_report, spls_attention)
from repro_torch.device import resolve_device

B, L, D, H, D_FF = 2, 128, 256, 8, 1024
SPLS = SPLSConfig(enabled=True, k_ratio=0.12, s_threshold=0.6,
                  f_threshold=5, window=8, causal=False)


def inputs(device) -> tuple:
    """Language-like activations ``x (B, L, D)`` -- neighbouring tokens
    correlate (an AR(1) recursion with coefficient 0.9: the paper's premise
    that local similarity comes from local semantics) -- and projections
    ``wq, wk, wv (D, D)`` scaled by ``D ** -0.5``."""
    gen = torch.Generator(device=device).manual_seed(0)
    draw = lambda *s: torch.randn(s, generator=gen, device=device)
    eps = draw(B, L, D)
    xs = [eps[:, 0]]
    for t in range(1, L):
        xs.append(0.9 * xs[-1] + (1 - 0.81) ** 0.5 * eps[:, t])
    x = torch.stack(xs, dim=1)
    wq, wk, wv = (draw(D, D) * D ** -0.5 for _ in range(3))
    return x, wq, wk, wv


def run(x, wq, wk, wv) -> dict:
    """The plan of ``x`` under :data:`SPLS`, its stats and FLOPs reduction,
    and the relative L2 deviation of attention under the plan from dense
    attention (q / k / v from the activations the plan was predicted
    from, as in the model)."""
    plan = build_plan(x, wq, wk, H, SPLS)
    Dh = D // H
    split = lambda t: t.reshape(B, L, H, Dh).transpose(1, 2)
    q, k, v = split(x @ wq), split(x @ wk), split(x @ wv)
    a = torch.softmax(q @ k.transpose(-1, -2) * Dh ** -0.5, dim=-1)
    dense = a @ v
    sparse = spls_attention(q, k, v, plan)
    return {"plan": plan, "stats": plan_stats(plan),
            "reduction": reduction_report(plan, D, D_FF, causal=False),
            "deviation": float(torch.linalg.norm(sparse - dense)
                               / torch.linalg.norm(dense))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; pass "
                         "'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    out = run(*inputs(resolve_device(args.device)))
    print("== SPLS plan (HLog -> top-k -> local similarity -> MFI) ==")
    for k, v in out["stats"].items():
        print(f"  {k:22s} {float(v):.3f}")
    print("== exact FLOPs reduction (Fig. 15 accounting) ==")
    for k, v in out["reduction"].items():
        print(f"  {k:22s} {float(v):.3f}")
    print(f"== sparse vs dense attention: relative L2 deviation "
          f"{out['deviation']:.3f} ==")
    print("   (bounded deviation at >50% compute removed is the trade the "
          "paper tunes with (k, s, f))")
    return out


if __name__ == "__main__":
    main()
