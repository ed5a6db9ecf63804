"""The port's progressive SPLS planner against the reference's on bridged
weights: the full-sequence plan (one block and window-aligned row blocks
with a padded tail), the plan modes, the layer-0 prune votes of a
whole-prompt prefill and ``scatter_prefill``.  All exact.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planner as jplanner
from repro.serving import pager as jpager
from repro.serving import paged_model as jpm
from repro_torch.core import planner as tplanner
from repro_torch.core.spls import SparsityPlan
from repro_torch.models import model as tm
from repro_torch.serving import pager as tpager
from repro_torch.serving import paged_model as tpm

from _torch_parity import cfg_pair, n, params_pair, t

# (config kind, causal): the non-causal MHA encoder of the paper, a causal
# GQA model with qk-norm, and a non-causal GQA model with a symmetric window
# and a softcap
CASES = [("mha", False), ("gqa_qknorm", True),
         ("gqa_window_softcap", False)]


def _pair(kind, causal, **kw):
    return cfg_pair(kind, spls=dict(causal=causal), causal=causal, **kw)


def _block0(jc, jp, tp):
    pj = jax.tree.map(lambda a: a[0], jp["periods"][0])
    pt = tm.period_params(tp, 0, torch.float32)[0]
    return pj, pt


def _xn(jc, pj, L=28, B=2, seed=0):
    """Normalized block input of random activations."""
    x = np.random.default_rng(seed).normal(
        size=(B, L, jc.d_model)).astype(np.float32)
    from repro.models.common import rms_norm as jrms
    return np.asarray(jrms(jnp.asarray(x), pj["ln1"], jc.norm_eps))


@pytest.mark.parametrize("kind,causal,row_block", [
    ("mha", False, None), ("gqa_qknorm", True, 8),
    ("gqa_window_softcap", False, 8)])
def test_plan_progressive(kind, causal, row_block):
    """Masks, critical rows, leaders, kv_keep and the FFN plan exact, as
    one block and over window-aligned row blocks with a padded tail."""
    jc, tc = _pair(kind, causal)
    jp, tp = params_pair(jc)
    pj, pt = _block0(jc, jp, tp)
    xn = _xn(jc, pj)
    jplan = jplanner.build_block_plan_progressive(jc, pj, jnp.asarray(xn),
                                                  row_block)
    tplan = tplanner.build_block_plan_progressive(tc, pt, t(xn), row_block)
    for field in SparsityPlan._fields:
        np.testing.assert_array_equal(n(getattr(tplan, field)),
                                      np.asarray(getattr(jplan, field)),
                                      err_msg=field)
    assert tplan.q_critical.any()


def test_plan_modes():
    jc, tc = _pair("mha", False)
    jp, tp = params_pair(jc)
    _, pt = _block0(jc, jp, tp)
    x = torch.zeros(1, 8, tc.d_model)
    assert tplanner.build_block_plan_progressive(
        dataclasses.replace(tc, spls=dataclasses.replace(tc.spls,
                                                         enabled=False)),
        pt, x) is None
    from repro_torch.models.blocks import block_forward
    # plan_mode="auto" builds the exact plan (its parity against the
    # reference: test_torch_exact_plan.py); an unknown mode raises
    out = block_forward(tc, tc.period[0], pt, x)
    assert out.shape == x.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="unknown plan_mode"):
        block_forward(tc, tc.period[0], pt, x, plan_mode="exact")


@pytest.mark.parametrize("kind,causal", CASES[:2])
def test_spls_token_votes(kind, causal):
    jc, tc = _pair(kind, causal)
    jp, tp = params_pair(jc)
    prompt = np.random.default_rng(3).integers(0, jc.vocab_size, 30
                                               ).astype(np.int32)
    ref = jpager.spls_token_votes(jc, jp, jnp.asarray(prompt))
    got = tpager.spls_token_votes(tc, tp, t(prompt))
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    np.testing.assert_array_equal(
        tpager.spls_token_keep(tc, tp, t(prompt), vote=0.5),
        jpager.spls_token_keep(jc, jp, jnp.asarray(prompt), vote=0.5))


def test_scatter_prefill():
    jc, tc = _pair("gqa_qknorm", False)
    jp, tp = params_pair(jc)
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (1, 10)
                                             ).astype(np.int32)
    _, tcache = tm.prefill(tc, tp, t(toks), plan_mode="progressive")
    dense = tuple(jax.tree.map(lambda a: jnp.asarray(n(a)), c)
                  for c in tcache)
    N, ps = 6, 4
    r = np.random.default_rng(5)
    shape = (jc.n_periods, jc.n_kv_heads, N, ps, jc.resolved_head_dim)
    k0 = r.normal(size=shape).astype(np.float32)
    v0 = r.normal(size=shape).astype(np.float32)
    pos0 = np.full((N, ps), 1 << 30, np.int32)
    keep_idx = np.array([0, 2, 3, 7, 9], np.int32)
    flat = np.array([4, 5, 6, 7, 12], np.int32)      # pages 1 and 3
    jcache, jpos = jpm.scatter_prefill(
        (jpager.PagedKVCache(jnp.asarray(k0), jnp.asarray(v0)),),
        jnp.asarray(pos0), dense, jnp.asarray(keep_idx), jnp.asarray(flat))
    tcache_p = (tpager.PagedKVCache(t(k0), t(v0)),)
    tpos = t(pos0)
    tpm.scatter_prefill(tcache_p, tpos, tcache, t(keep_idx), t(flat))
    np.testing.assert_array_equal(n(tpos), np.asarray(jpos))
    np.testing.assert_array_equal(n(tcache_p[0].k_pages),
                                  np.asarray(jcache[0].k_pages))
    np.testing.assert_array_equal(n(tcache_p[0].v_pages),
                                  np.asarray(jcache[0].v_pages))
