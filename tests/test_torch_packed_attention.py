"""Capacity-mode SPLS attention of the port against the reference on the
same numpy inputs: ``spls_attention_packed`` (values and the gradients of
q, k and v), the ``xla_packed`` / ``torch_packed`` backend on the
planner's head layout (GQA G 2, a window, a softcap), and ``forward`` at
the reference's SPLS training capacities (q 0.5, kv 0.75 of L) under
shared plans.  Each case runs once with capacities below the plan's
critical-row and kept-column counts (rows past the capacity fall back as
``pack_by_mask`` says) and once with capacities that hold them all.

Tolerances: rtol = atol = 1e-5 for one attention (float32 sums in another
order), 1e-4 for logits after every layer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import planner as jplanner
from repro.core.sparse_exec import spls_attention_packed as jpacked
from repro.core.spls import SPLSConfig as JSPLSConfig
from repro.core.spls import build_plan as jbuild_plan
from repro.models import model as jm
from repro.models.attn_backend import get_backend as jget_backend
from repro_torch.core import spls_attention_packed as tpacked
from repro_torch.core.spls import SparsityPlan
from repro_torch.models import model as tm
from repro_torch.models.attn_backend import get_backend, resolve_backend

from _torch_parity import (cfg_pair, feed_reference_plans, n, params_pair,
                           record_port_plans, t)

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
B, L, D, H = 2, 24, 32, 4


def _plan_to_torch(plan) -> SparsityPlan:
    return SparsityPlan(*(t(np.asarray(f)) for f in plan))


@functools.lru_cache(maxsize=None)
def _build_plan(causal: bool):
    """``build_plan``'s plan of random activations (shared by the cases
    that differ only in softcap and capacities)."""
    r = np.random.default_rng(3)
    x = r.normal(size=(B, L, D)).astype(np.float32)
    wq, wk = (r.normal(size=(D, D)).astype(np.float32) * D ** -0.5
              for _ in range(2))
    return jbuild_plan(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(wk), H,
                       JSPLSConfig(enabled=True, k_ratio=0.3,
                                   s_threshold=0.6, f_threshold=2, window=4,
                                   causal=causal))


@functools.lru_cache(maxsize=None)
def _block_plan(kind: str, causal: bool):
    """The progressive planner's plan of block 0 on random activations, in
    the (B, KV, G, L) layout."""
    jc, _ = cfg_pair(kind, spls=dict(causal=causal), causal=causal)
    jp, _ = params_pair(jc)
    pj = jax.tree.map(lambda a: a[0], jp["periods"][0])
    xn = np.random.default_rng(4).normal(size=(B, L, jc.d_model)).astype(
        np.float32)
    return jplanner.build_block_plan_progressive(jc, pj, jnp.asarray(xn))


def _capacities(plan, fits: bool) -> tuple:
    """(q, kv) capacities: every row's critical / kept count, or fewer
    than the largest (asserted)."""
    crit = np.asarray(plan.q_critical).sum(-1)
    kept = np.asarray(plan.kv_keep).sum(-1)
    if fits:
        return int(crit.max()), int(kept.max())
    qc, kc = int(crit.max()) // 2, int(kept.max()) - 3
    assert (crit > qc).any() and (kept > kc).any()
    return qc, kc


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("fits", [False, True])
def test_spls_attention_packed(causal, softcap, fits):
    """One (B, H, L, Dh) attention under ``build_plan``'s plan; the
    gradients of q, k and v against ``jax.grad`` (repeated gather indices
    of the leader map must accumulate)."""
    plan = _build_plan(causal)
    qc, kc = _capacities(plan, fits)
    r = np.random.default_rng(5)
    q, k, v = (r.normal(size=(B, H, L, D // H)).astype(np.float32)
               for _ in range(3))
    w = r.normal(size=q.shape).astype(np.float32)
    kw = dict(softcap=softcap)
    ref = jpacked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), plan, qc,
                  kc, **kw)
    jgrads = jax.grad(lambda a, b, c: (jpacked(a, b, c, plan, qc, kc, **kw)
                                       * w).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    got = tpacked(*leaves, _plan_to_torch(plan), qc, kc, **kw)
    np.testing.assert_allclose(n(got), np.asarray(ref), **TOL)
    (got * t(w)).sum().backward()
    for leaf, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(n(leaf.grad), np.asarray(jg), **TOL)


@pytest.mark.parametrize("kind,causal", [
    ("mha", True), ("gqa_qknorm", True), ("gqa_window_softcap", False)])
@pytest.mark.parametrize("fits", [False, True])
def test_packed_backend(kind, causal, fits):
    """The backend on the planner's (B, KV, G, L) layout: K / V broadcast
    over G, the block's window intersected into the plan, the softcap."""
    jc, tc = cfg_pair(kind, spls=dict(causal=causal), causal=causal)
    plan = _block_plan(kind, causal)
    qc, kc = _capacities(plan, fits)
    r = np.random.default_rng(6)
    KV, G = jc.n_kv_heads, jc.n_heads // jc.n_kv_heads
    Dh = jc.head_dim
    q = r.normal(size=(B, KV, G, L, Dh)).astype(np.float32)
    k, v = (r.normal(size=(B, KV, L, Dh)).astype(np.float32)
            for _ in range(2))
    window = jc.period[0].window
    ref = jget_backend("xla_packed")(
        jc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        plan=plan, q_capacity=qc, kv_capacity=kc)
    got = get_backend("xla_packed")(tc, t(q), t(k), t(v), window=window,
                                    plan=_plan_to_torch(plan), q_capacity=qc,
                                    kv_capacity=kc)
    np.testing.assert_allclose(n(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["mha", "gqa_qknorm"])
def test_forward_at_reduced_capacity(kind, monkeypatch):
    """``forward`` logits at q 0.5 / kv 0.75 of L, both packages naming
    ``xla_packed``, under the port's plans."""
    spls = dict(q_capacity_ratio=0.5, kv_capacity_ratio=0.75)
    jc, tc = cfg_pair(kind, spls=spls, attn_backend="xla_packed")
    jp, tp = params_pair(jc)
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 24)
                                             ).astype(np.int32)
    plans = record_port_plans(monkeypatch)
    got = tm.forward(tc, tp, t(toks))
    assert len(plans) == tc.n_layers
    feed_reference_plans(monkeypatch, plans)
    ref = jm.forward(jc, jp, jnp.asarray(toks))
    np.testing.assert_allclose(n(got), np.asarray(ref), **LOGIT_TOL)


def test_reduced_capacity_resolves_to_torch_packed():
    """The reference's CPU rule on either device: a plan at a reduced q
    capacity -> ``torch_packed``, which ``xla_packed`` names."""
    for dev in ("cpu", "cuda"):
        assert resolve_backend("auto", dev, "forward", platform="cpu",
                               plan=object(), L=64, q_capacity=32) == \
            "torch_packed"
        assert resolve_backend("xla_packed", dev, "forward") == \
            "torch_packed"
    assert get_backend("xla_packed") is get_backend("torch_packed")
    assert resolve_backend("auto", "cuda", "forward") == "cuda_flash"
    assert resolve_backend("auto", "cpu", "forward", plan=object(), L=64,
                           q_capacity=32) == "torch_flash"
