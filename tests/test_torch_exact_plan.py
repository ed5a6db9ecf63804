"""The port's exact SPLS plan path against the reference on the same numpy
inputs and bridged weights: row top-k (ties), the SPA, K/V keep, the full
PAM, the one-shot ``build_plan``, ``plan_stats`` and the FLOPs report, the
planner's exact and row-block plans, ``block_forward`` with the default
``plan_mode="auto"`` and ``forward`` logits with SPLS on.

Tolerances: masks, leaders, keeps and FFN plans exact on equal inputs
(the parity rules allow differences only at near-ties of the predicted
scores, and none occurs here; the blocks normalize with the reference's
``rms_norm`` for that reason, see ``_reference_norm``); the PAM rtol =
atol = 1e-5; ``plan_stats`` and the
FLOPs report 1e-6 relative (the port counts in float64, exactly; the
reference in float32); block outputs and logits rtol = atol = 1e-4 (XLA
and torch order matmul sums differently on the CPU).  Both sides name the
forward backend, because the two packages' "auto" differ on a CPU.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flops as jflops
from repro.core import planner as jplanner
from repro.core import predict as jpredict
from repro.core import spls as jspls
from repro.core import topk as jtopk
from repro.models import blocks as jblocks
from repro.models import model as jm
from repro.models.common import rms_norm as jrms
from repro_torch import core as tcore
from repro_torch.core import planner as tplanner
from repro_torch.core import spls_chunked as tchunked
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as tm

from _torch_parity import cfg_pair, n, params_pair, t

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


def _x(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _xn(jc, pj, L=32, B=2, seed=0) -> np.ndarray:
    """Normalized block input of random activations."""
    x = _x((B, L, jc.d_model), seed)
    return np.asarray(jrms(jnp.asarray(x), pj["ln1"], jc.norm_eps))


def _same(got, want, fields) -> None:
    for f in fields:
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# top-k, SPA, PAM, build_plan
# ---------------------------------------------------------------------------

def test_row_topk_mask_ties():
    """Rows of equal values, and rows with ties across the k-th place: the
    earlier index wins, as jax.lax.top_k breaks ties."""
    rows = np.array([[1.0] * 7,
                     [0.0, 2.0, 1.0, 1.0, 1.0, 2.0, 1.0],
                     [3.0, 1.0, 3.0, 1.0, 3.0, 1.0, 3.0],
                     [-1.0, -1.0, 5.0, -1.0, -1.0, -1.0, -1.0]],
                    np.float32)
    for k in (1, 2, 3, 6, 7, 9):
        got = n(tcore.row_topk_mask(t(rows), k))
        np.testing.assert_array_equal(
            got, np.asarray(jtopk.row_topk_mask(jnp.asarray(rows), k)))
        assert (got.sum(-1) == min(k, 7)).all()
    np.testing.assert_array_equal(n(tcore.row_topk_mask(t(rows), 3))[0],
                                  [True, True, True] + [False] * 4)
    # many tied rows on a multi-dim tensor, ties quantized like a bf16 PAM
    r = np.round(_x((3, 4, 20, 40), 1) * 2) / 2
    np.testing.assert_array_equal(
        n(tcore.row_topk_mask(t(r), 5)),
        np.asarray(jtopk.row_topk_mask(jnp.asarray(r), 5)))


@pytest.mark.parametrize("causal", [False, True])
def test_sparsify_pam_and_kv_keep(causal):
    pam = _x((2, 3, 24, 24), 2)
    if causal:
        pam = np.where(np.tril(np.ones((24, 24), bool)), pam,
                       np.finfo(np.float32).min / 2)
    jspa, jmask = jtopk.sparsify_pam(jnp.asarray(pam), 0.12)
    tspa, tmask = tcore.sparsify_pam(t(pam), 0.12)
    np.testing.assert_array_equal(n(tmask), np.asarray(jmask))
    np.testing.assert_array_equal(n(tspa), np.asarray(jspa))
    np.testing.assert_array_equal(
        n(tcore.kv_keep_from_mask(tmask)),
        np.asarray(jtopk.kv_keep_from_mask(jmask)))


def _build_inputs(seed=6, L=32):
    x = _x((2, L, 64), seed)
    return x, _x((64, 64), seed + 1) / 8, _x((64, 64), seed + 2) / 8


@pytest.mark.parametrize("n_kv", [4, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_predicted_attention(n_kv, causal):
    """MHA and GQA (K heads broadcast over their query group), with and
    without the causal fill."""
    x, wq, _ = _build_inputs(seed=3)
    wk = _x((64, 16 * n_kv), 5) / 8
    ref = jpredict.predicted_attention(jnp.asarray(x), jnp.asarray(wq),
                                       jnp.asarray(wk), 4, causal=causal,
                                       n_kv_heads=n_kv)
    got = tcore.predicted_attention(t(x), t(wq), t(wk), 4, causal=causal,
                                    n_kv_heads=n_kv)
    assert got.shape == (2, 4, 32, 32)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


BUILD_CASES = {
    "encoder": dict(causal=False),
    "causal_valid_len": dict(causal=True, valid_len=27),
    "no_qkv_sparsity": dict(causal=False, qkv_sparsity=False),
    "no_ffn_sparsity": dict(causal=True, ffn_sparsity=False),
    "disabled": dict(causal=True, enabled=False),
}


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_plan(case):
    kw = dict(BUILD_CASES[case])
    valid_len = kw.pop("valid_len", None)
    scfg = dict(k_ratio=0.12, s_threshold=0.6, f_threshold=2, window=4,
                **kw)
    x, wq, wk = _build_inputs()
    ref = jspls.build_plan(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(wk),
                           4, jspls.SPLSConfig(**scfg), valid_len=valid_len)
    got = tcore.build_plan(t(x), t(wq), t(wk), 4, tcore.SPLSConfig(**scfg),
                           valid_len=valid_len)
    _same(got, ref, tcore.SparsityPlan._fields)
    if case == "encoder":
        assert 0 < n(got.q_critical).mean() < 1      # real sparsity


def _rel_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key], float(v), rtol=1e-6, atol=1e-7,
                                   err_msg=key)


@pytest.mark.parametrize("causal", [False, True])
def test_plan_stats_and_reduction_report(causal):
    """On the reference's own plan (the same masks on both sides), a (B, H)
    plan from ``build_plan``."""
    x, wq, wk = _build_inputs(seed=9)
    scfg = dict(k_ratio=0.12, s_threshold=0.6, f_threshold=2, window=4,
                causal=causal)
    jplan = jspls.build_plan(jnp.asarray(x), jnp.asarray(wq),
                             jnp.asarray(wk), 4, jspls.SPLSConfig(**scfg))
    tplan = tcore.SparsityPlan(*(t(np.asarray(f)) for f in jplan))
    _rel_close(tcore.plan_stats(tplan), jspls.plan_stats(jplan))
    _rel_close(tcore.reduction_report(tplan, 64, 128, causal=causal),
               jflops.reduction_report(jplan, 64, 128, causal=causal))
    for got, want in ((tcore.spls_flops(tplan, 64, 128),
                       jflops.spls_flops(jplan, 64, 128)),
                      (tcore.dense_flops(2, 32, 64, 4, 128, causal),
                       jflops.dense_flops(2, 32, 64, 4, 128, causal))):
        np.testing.assert_allclose(list(got) + [got.total],
                                   [float(v) for v in want]
                                   + [float(want.total)], rtol=1e-6)


def test_quickstart_names_resolve():
    """The names ``examples/quickstart.py`` imports resolve from
    ``repro_torch.core``, and its pipeline (plan, stats, FLOPs report)
    gives the reference's results."""
    from repro_torch.core import (SPLSConfig, build_plan, plan_stats,  # noqa
                                  reduction_report, spls_attention)
    x, wq, wk = _build_inputs(seed=12)
    scfg = dict(enabled=True, k_ratio=0.12, s_threshold=0.6, f_threshold=2,
                window=4, causal=False)
    jplan = jspls.build_plan(jnp.asarray(x), jnp.asarray(wq),
                             jnp.asarray(wk), 4, jspls.SPLSConfig(**scfg))
    tplan = build_plan(t(x), t(wq), t(wk), 4, SPLSConfig(**scfg))
    _same(tplan, jplan, tcore.SparsityPlan._fields)
    _rel_close(plan_stats(tplan), jspls.plan_stats(jplan))
    _rel_close(reduction_report(tplan, 64, 256, causal=False),
               jflops.reduction_report(jplan, 64, 256, causal=False))
    assert callable(spls_attention)


# ---------------------------------------------------------------------------
# the planner's exact and row-block plans on bridged weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,causal", CASES)
def test_plan_exact(kind, causal):
    jc, tc = _pair(kind, causal)
    jp, tp = params_pair(jc)
    pj, pt = _block0(jc, jp, tp)
    xn = _xn(jc, pj)
    ref = jplanner.build_block_plan(jc, pj, jnp.asarray(xn))
    got = tplanner.build_block_plan(tc, pt, t(xn))
    _same(got, ref, tcore.SparsityPlan._fields)
    assert got.attn_mask.shape == (2, tc.n_kv_heads,
                                   tc.n_heads // tc.n_kv_heads, 32, 32)


def test_plan_scan():
    """``plan_scan`` over four row blocks, and ``chunked_plan_scan`` on the
    reference's heads, against the reference's ``plan_scan`` (its
    ``lax.scan`` over ``chunked_plan_scan``); ``build_block_plan_chunked``
    is ``plan_scan`` at ``min(512, L)`` rows.  (Its parity at a causal GQA
    model: ``test_block_forward_auto_long``.)"""
    jc, tc = _pair("mha", False)
    jp, tp = params_pair(jc)
    pj, pt = _block0(jc, jp, tp)
    xn = _xn(jc, pj)
    jctx = jplanner.PlanContext.for_config(jc)
    tctx = tplanner.PlanContext.for_config(tc)
    fields = tchunked.ChunkedPlan._fields
    ref = jctx.plan_scan(pj["attn"], jnp.asarray(xn), row_block=8)
    _same(tctx.plan_scan(pt["attn"], t(xn), row_block=8), ref, fields)
    qh, kh = jctx.predict_heads(pj["attn"], jnp.asarray(xn), act_axis=None)
    kw = dict(k_ratio=0.12, s_threshold=0.6, window=4, f_threshold=2,
              row_block=8, causal=False)
    _same(tchunked.chunked_plan_scan(t(qh), t(kh), **kw), ref, fields)
    whole = tctx.plan_scan(pt["attn"], t(xn), row_block=32)
    for a, b in zip(tplanner.build_block_plan_chunked(tc, pt, t(xn)), whole):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="multiple of row_block"):
        tchunked.chunked_plan_scan(t(qh), t(kh), **dict(kw, row_block=12))


# ---------------------------------------------------------------------------
# block_forward and forward with the default plan_mode
# ---------------------------------------------------------------------------

def _reference_norm(monkeypatch) -> None:
    """Normalize with the reference's ``rms_norm`` inside the port's
    blocks, so both plans see bit-identical inputs: the quantized PAM is
    full of exact-integer ties that float rounding breaks by an ulp, so a
    last-bit difference in the norm can flip one top-k choice -- a near-tie,
    which the parity rules allow but a tolerance on outputs cannot."""
    def norm(x, scale, eps):
        return t(np.asarray(jrms(jnp.asarray(n(x)), jnp.asarray(n(scale)),
                                 eps)))
    monkeypatch.setattr(tblocks, "rms_norm", norm)


@pytest.mark.parametrize("kind,causal,tname,jname", [
    ("mha", False, "torch_dense", "xla_dense"),
    ("gqa_qknorm", True, "torch_chunked", "xla_chunked"),
    ("gqa_window_softcap", False, "torch_dense", "xla_dense")])
def test_block_forward_auto(kind, causal, tname, jname, monkeypatch):
    """``plan_mode="auto"`` below the row-block threshold: the exact plan
    (and the prefill cache)."""
    _reference_norm(monkeypatch)
    jc, tc = _pair(kind, causal)
    jp, tp = params_pair(jc)
    pj, pt = _block0(jc, jp, tp)
    x = _x((2, 32, jc.d_model), 8)
    blk_j, blk_t = jc.period[0], tc.period[0]
    ref, jcache = jblocks.block_forward(jc, blk_j, pj, jnp.asarray(x),
                                        cache_len=36, attn_backend=jname)
    got, tcache = tblocks.block_forward(tc, blk_t, pt, t(x), cache_len=36,
                                        attn_backend=tname)
    np.testing.assert_allclose(n(got), np.asarray(ref), **LOGIT_TOL)
    np.testing.assert_allclose(n(tcache.k), np.asarray(jcache.k),
                               **LOGIT_TOL)


@pytest.mark.parametrize("kind,causal", CASES[1:2])
def test_block_forward_auto_long(kind, causal, monkeypatch):
    """At and above the row-block threshold (lowered to 16 tokens in both
    packages) "auto" plans with the ChunkedPlan, and the forward site's
    "auto" sends it to the chunked backend on either device."""
    monkeypatch.setattr(jblocks, "_SPLS_CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(tblocks, "_SPLS_CHUNK_THRESHOLD", 16)
    _reference_norm(monkeypatch)
    jc, tc = _pair(kind, causal)
    jp, tp = params_pair(jc)
    pj, pt = _block0(jc, jp, tp)
    x = _x((2, 32, jc.d_model), 10)
    ref = jblocks.block_forward(jc, jc.period[0], pj, jnp.asarray(x))
    got = tblocks.block_forward(tc, tc.period[0], pt, t(x))
    np.testing.assert_allclose(n(got), np.asarray(ref), **LOGIT_TOL)
    from repro_torch.models.attn_backend import resolve_backend
    plan = tplanner.build_block_plan_chunked(tc, pt, t(x))
    assert isinstance(plan, tchunked.ChunkedPlan)
    for dev in ("cpu", "cuda"):
        assert resolve_backend("auto", dev, "forward", plan) == \
            "torch_chunked"
    assert resolve_backend("cuda_flash", "cuda", "forward", plan) == \
        "cuda_flash"


@pytest.mark.parametrize("kind,causal,tname,jname", [
    ("mha", False, "torch_flash", "pallas_flash"),
    ("gqa_qknorm", True, "torch_dense", "xla_dense"),
    ("gqa_window_softcap", False, "torch_flash", "pallas_flash")])
def test_forward_spls_logits(kind, causal, tname, jname):
    """``forward`` with SPLS on runs the exact plan in every layer (it
    raised before this path was ported)."""
    jc, tc = _pair(kind, causal)
    jp, tp = params_pair(jc)
    toks = np.random.default_rng(11).integers(0, jc.vocab_size, (2, 32)
                                              ).astype(np.int32)
    ref = jm.forward(dataclasses.replace(jc, attn_backend=jname), jp,
                     jnp.asarray(toks))
    got = tm.forward(dataclasses.replace(tc, attn_backend=tname), tp,
                     t(toks))
    np.testing.assert_allclose(n(got), np.asarray(ref), **LOGIT_TOL)
    logits, _ = tm.prefill(dataclasses.replace(tc, attn_backend=tname), tp,
                           t(toks))
    np.testing.assert_array_equal(n(logits), n(got))
