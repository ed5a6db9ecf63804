"""Whole-sequence attention of the port against the reference on bridged
weights: ``attention_forward`` on every forward backend (with and without
the reference's SPLS plan), the flash backends' oracle
``spls_attention_chunked``, and ``forward`` logits without SPLS.

Tolerances: single attention layers rtol = atol = 1e-5; logits after
every layer rtol = atol = 1e-4 (XLA and torch order matmul sums
differently on the CPU).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planner as jplanner
from repro.core.sparse_exec import spls_attention_chunked as jchunked
from repro.models import attention as ja
from repro.models import model as jm
from repro_torch.core.sparse_exec import spls_attention_chunked as tchunked
from repro_torch.core.spls import SparsityPlan
from repro_torch.models import attention as ta
from repro_torch.models import model as tm

from _torch_parity import cfg_pair, n, params_pair, t

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
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


def _plan_to_torch(plan) -> SparsityPlan:
    return SparsityPlan(*(t(np.asarray(f)) for f in plan))


FORWARD_BACKENDS = [("torch_flash", "pallas_flash"),
                    ("torch_dense", "xla_dense"),
                    ("torch_chunked", "xla_chunked")]


@pytest.mark.parametrize("kind,causal,tname,jname,with_plan", [
    (kind, causal, tname, jname, with_plan)
    for (kind, causal), (tname, jname), with_plan in [
        (CASES[0], FORWARD_BACKENDS[0], True),
        (CASES[1], FORWARD_BACKENDS[0], True),
        (CASES[2], FORWARD_BACKENDS[0], True),
        (CASES[0], FORWARD_BACKENDS[1], True),
        (CASES[2], FORWARD_BACKENDS[1], True),
        (CASES[1], FORWARD_BACKENDS[1], False),
        (CASES[0], FORWARD_BACKENDS[2], True),
        (CASES[1], FORWARD_BACKENDS[2], True),
        (CASES[2], FORWARD_BACKENDS[2], False)]])
def test_attention_forward(kind, causal, tname, jname, with_plan):
    """One attention layer on each forward backend against its reference
    counterpart, given the reference's plan; the prefill cache too."""
    jc, tc = _pair(kind, causal)
    jp, tp = params_pair(jc)
    pj, pt = _block0(jc, jp, tp)
    xn = _xn(jc, pj, L=20)
    window = jc.period[0].window
    jplan = (jplanner.build_block_plan_progressive(jc, pj, jnp.asarray(xn))
             if with_plan else None)
    tplan = _plan_to_torch(jplan) if with_plan else None
    jout, jcache = ja.attention_forward(jc, pj["attn"], jnp.asarray(xn),
                                        window=window, plan=jplan,
                                        cache_len=24, backend=jname)
    tout, tcache = ta.attention_forward(tc, pt["attn"], t(xn), window=window,
                                        plan=tplan, cache_len=24,
                                        backend=tname)
    np.testing.assert_allclose(n(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(n(tcache.k), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(n(tcache.v), np.asarray(jcache.v), **TOL)
    # the kernel route gives the same function on CPU tensors
    if tname == "torch_flash":
        alias = ta.attention_forward(tc, pt["attn"], t(xn), window=window,
                                     plan=tplan, backend="pallas_flash")
        np.testing.assert_array_equal(n(alias), n(tout))


@pytest.mark.parametrize("kind,causal", CASES[::2])
def test_spls_attention_chunked(kind, causal):
    """The flash backends' oracle under a plan, at a capacity that
    truncates the packed rows and a KV chunk that leaves a ragged tail."""
    jc, tc = _pair(kind, causal)
    jp, tp = params_pair(jc)
    pj, pt = _block0(jc, jp, tp)
    xn = _xn(jc, pj, L=20)
    plan = jplanner.build_block_plan_progressive(jc, pj, jnp.asarray(xn))
    pos = jnp.broadcast_to(jnp.arange(20), (2, 20))
    q, k, v = ja.project_qkv(jc, pj["attn"], jnp.asarray(xn), pos)
    kw = dict(q_capacity=16, kv_capacity=20, softcap=jc.attn_softcap,
              kv_chunk=8, causal=causal, window=jc.period[0].window)
    ref = jchunked(q, k, v, plan, **kw)
    got = tchunked(t(q), t(k), t(v), _plan_to_torch(plan), **kw)
    np.testing.assert_allclose(n(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind,causal", CASES)
def test_attention_forward_packed(kind, causal):
    """``xla_packed`` (the port's ``torch_packed``) through
    ``attention_forward`` at q 0.5 / kv 0.75 of L, given the reference's
    plan; without a plan it is the dense scores."""
    jc, tc = _pair(kind, causal)
    jp, tp = params_pair(jc)
    pj, pt = _block0(jc, jp, tp)
    xn = _xn(jc, pj, L=20)
    window = jc.period[0].window
    jplan = jplanner.build_block_plan_progressive(jc, pj, jnp.asarray(xn))
    for jpl, tpl in ((jplan, _plan_to_torch(jplan)), (None, None)):
        kw = dict(window=window, q_capacity=10, kv_capacity=15)
        jout, _ = ja.attention_forward(jc, pj["attn"], jnp.asarray(xn),
                                       plan=jpl, backend="xla_packed", **kw)
        tout, _ = ta.attention_forward(tc, pt["attn"], t(xn), plan=tpl,
                                       backend="xla_packed", **kw)
        np.testing.assert_allclose(n(tout), np.asarray(jout), **TOL)
        own, _ = ta.attention_forward(tc, pt["attn"], t(xn), plan=tpl,
                                      backend="torch_packed", **kw)
        np.testing.assert_array_equal(n(own), n(tout))


@pytest.mark.parametrize("kind,causal", CASES[1:])
def test_forward_without_spls(kind, causal):
    jc, tc = _pair(kind, causal)
    jc = dataclasses.replace(jc, spls=dataclasses.replace(jc.spls,
                                                          enabled=False))
    tc = dataclasses.replace(tc, spls=dataclasses.replace(tc.spls,
                                                          enabled=False))
    jp, tp = params_pair(jc)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 16)
                                             ).astype(np.int32)
    ref = jm.forward(dataclasses.replace(jc, attn_backend="xla_dense"), jp,
                     jnp.asarray(toks))
    got = tm.forward(tc, tp, t(toks))          # auto: torch_flash on the CPU
    np.testing.assert_allclose(n(got), np.asarray(ref), **LOGIT_TOL)




def test_backend_resolution():
    """Site routing of reference names, of a ServeConfig name beside the
    model config's, and "auto" by device."""
    from repro_torch.models import attn_backend as ab
    from repro_torch.serving.engine import ServeConfig, _site_cfg
    assert ab.resolve_backend("auto", "cpu", "forward") == "torch_flash"
    assert ab.resolve_backend(None, "cuda", "forward") == "cuda_flash"
    assert ab.resolve_backend("auto", "cuda", "decode") == \
        "cuda_flash_decode"
    assert ab.resolve_backend("xla_dense", "cuda", "forward") == \
        "torch_dense"
    assert ab.site_backend("pallas_flash", "paged_decode") == "auto"
    # the ServeConfig pins the site it names, the model config the others
    cfg = dataclasses.replace(cfg_pair(causal=False)[1],
                              attn_backend="torch_flash")
    scfg = ServeConfig(attn_backend="xla_paged_decode")
    assert _site_cfg(cfg, scfg, "forward").attn_backend == "torch_flash"
    assert _site_cfg(cfg, scfg, "paged_decode").attn_backend == \
        "torch_paged_decode"
    assert _site_cfg(cfg, scfg, "decode").attn_backend == "auto"
    assert _site_cfg(cfg, ServeConfig(attn_backend="xla_dense"),
                     "forward").attn_backend == "torch_dense"
    with pytest.warns(RuntimeWarning, match="paged_decode backend"):
        assert ab.resolve_backend("cuda_paged_decode", "cpu",
                                  "forward") == "torch_flash"
    with pytest.raises(ValueError, match="unknown attention backend"):
        ab.site_backend("no_such_backend", "forward")
