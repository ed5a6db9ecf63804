"""SPLS core of the port against the reference on the same inputs.

Integer and boolean outputs (codes, masks, leaders, perms, slots, votes)
must be equal; float outputs of one module agree to rtol = atol = 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planner as jplanner
from repro.core import predict as jpredict
from repro.core import quantizers as jq
from repro.core import sparse_exec as jse
from repro.core import spls_chunked as jsc
from repro_torch.core import planner as tplanner
from repro_torch.core import predict as tpredict
from repro_torch.core import quantizers as tq
from repro_torch.core import sparse_exec as tse
from repro_torch.core import spls_chunked as tsc

from _torch_parity import cfg_pair, n, params_pair, t

METHODS = ["hlog", "hlog_bitlevel", "pot", "apot", "none"]


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, -1, 0])
def test_symmetric_quantize(axis):
    x = _rng(1).normal(size=(12, 40)).astype(np.float32) * 3
    jqv, js = jq.symmetric_quantize(jnp.asarray(x), bits=8, axis=axis)
    tqv, ts = tq.symmetric_quantize(t(x), bits=8, axis=axis)
    np.testing.assert_array_equal(n(tqv), np.asarray(jqv))
    np.testing.assert_array_equal(n(ts), np.asarray(js))


@pytest.mark.parametrize("method", METHODS)
def test_projectors_on_all_int8_codes(method):
    x = np.arange(-127, 128, dtype=np.float32)
    np.testing.assert_array_equal(
        n(tq.PROJECTORS[method](t(x), 8)),
        np.asarray(jq._PROJECTORS[method](jnp.asarray(x), 8)))


@pytest.mark.parametrize("levels", ["hlog", "pot", "apot"])
def test_project_to_levels_midpoint_ties_go_up(levels):
    lv = {"hlog": jq.hlog_levels, "pot": jq.pot_levels,
          "apot": jq.apot_levels}[levels](8)
    mids = ((lv[:-1] + lv[1:]) / 2).astype(np.float32)
    mag = np.concatenate([mids, mids - 0.25, mids + 0.25, [0.0, 300.0]]
                         ).astype(np.float32)
    got = n(tq.project_to_levels(t(mag), lv))
    np.testing.assert_array_equal(
        got, np.asarray(jq.project_to_levels(jnp.asarray(mag), lv)))
    np.testing.assert_array_equal(got[:len(mids)], lv[1:])   # tie -> up


def test_hlog_bitlevel_encode_codes_and_projection():
    x = np.arange(-255, 256, dtype=np.float32)
    np.testing.assert_array_equal(
        n(tq.hlog_bitlevel_encode(t(x))),
        np.asarray(jq.hlog_bitlevel_encode(jnp.asarray(x))))
    small = np.arange(-127, 128, dtype=np.float32)
    np.testing.assert_array_equal(n(tq.hlog_bitlevel_project(t(small))),
                                  n(tq.hlog_project(t(small))))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("axis", [None, -1])
def test_quantize_dequantize(method, axis):
    x = _rng(2).normal(size=(6, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        n(tq.quantize_dequantize(t(x), method, 8, axis=axis)),
        np.asarray(jq.quantize_dequantize(jnp.asarray(x), method, 8,
                                          axis=axis)))


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["hlog", "pot"])
def test_predict_qk_pre(method):
    r = _rng(3)
    x = r.normal(size=(1, 16, 64)).astype(np.float32)
    wq = (r.normal(size=(64, 64)) / 8).astype(np.float32)
    wk = (r.normal(size=(64, 32)) / 8).astype(np.float32)
    jqp, jkp = jpredict.predict_qk_pre(jnp.asarray(x), jnp.asarray(wq),
                                       jnp.asarray(wk), method, 8, -1)
    tqp, tkp = tpredict.predict_qk_pre(t(x), t(wq), t(wk), method, 8, -1)
    np.testing.assert_allclose(n(tkp), np.asarray(jkp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tqp), np.asarray(jqp), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["mha", "gqa_qknorm"])
def test_encode_decode_pred_qk(kind):
    jc, tc = cfg_pair(kind)
    jp, tp = params_pair(jc)
    x = _rng(4).normal(size=(1, 16, jc.d_model)).astype(np.float32)
    pj = jax.tree.map(lambda a: a[0], jp["periods"][0]["attn"])
    pt = {k: v[0] for k, v in tp["periods"][0]["attn"].items()}
    jctx = jplanner.PlanContext.for_config(jc, mode="structured")
    tctx = tplanner.PlanContext.for_config(tc, mode="structured")
    jqh, jcodes, jscale = jctx.encode_pred_qk(pj, jnp.asarray(x))
    tqh, tcodes, tscale = tctx.encode_pred_qk(pt, t(x))
    np.testing.assert_array_equal(n(tcodes), np.asarray(jcodes))
    np.testing.assert_allclose(n(tscale), np.asarray(jscale), rtol=1e-6)
    np.testing.assert_allclose(n(tqh), np.asarray(jqh), rtol=1e-5, atol=1e-5)
    # decoding the same codes is exact in both packages
    np.testing.assert_array_equal(
        n(tctx.decode_pred_k(tcodes, tscale, dtype=torch.float32)),
        np.asarray(jctx.decode_pred_k(jcodes, jscale, dtype=jnp.float32)))


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------

def test_bisect_topk_mask_exact():
    r = _rng(5)
    pam = r.normal(size=(2, 3, 8, 40)).astype(np.float32)
    pam[..., 30:] = jsc.CAUSAL_FILL
    for k in (1, 3, 7, 30):
        np.testing.assert_array_equal(
            n(tsc.bisect_topk_mask(t(pam), k)),
            np.asarray(jsc.bisect_topk_mask(jnp.asarray(pam), k)))


def _pred_heads(kind, L, seed):
    """The reference predictor's heads for a random input (both planners
    then see identical predicted heads)."""
    jc, _ = cfg_pair(kind)
    jp, _ = params_pair(jc)
    pj = jax.tree.map(lambda a: a[0], jp["periods"][0]["attn"])
    x = _rng(seed).normal(size=(1, L, jc.d_model)).astype(np.float32)
    ctx = jplanner.PlanContext.for_config(jc, mode="structured")
    qh, kh = ctx.predict_heads(pj, jnp.asarray(x), act_axis=-1)
    return np.asarray(qh), np.asarray(kh)


@pytest.mark.parametrize("kind", ["mha", "gqa_qknorm"])
def test_plan_chunk_over_consecutive_chunks(kind):
    jc, tc = cfg_pair(kind)
    L, CS, S = 40, 16, 48          # 3 chunks, the last one ragged
    qh, kh = _pred_heads(kind, L, seed=6)
    kh = np.pad(kh, ((0, 0), (0, 0), (0, S - L), (0, 0)))
    jctx = jplanner.PlanContext.for_config(jc, mode="structured")
    tctx = tplanner.PlanContext.for_config(tc, mode="structured")
    k = 5
    votes_j = votes_t = None
    for start in range(0, L, CS):
        valid = min(CS, L - start)
        q_blk = np.pad(qh[..., start:start + valid, :],
                       ((0, 0),) * 3 + ((0, CS - valid), (0, 0)))
        kw = dict(k=k, row0=start, n_valid_rows=valid, n_cols=start + valid)
        jb = jctx.plan_block(jnp.asarray(q_blk), jnp.asarray(kh), **kw)
        tb = tctx.plan_block(t(q_blk), t(kh), **kw)
        for field in jb._fields:
            np.testing.assert_array_equal(n(getattr(tb, field)),
                                          np.asarray(getattr(jb, field)),
                                          err_msg=f"{field} @ {start}")
        votes_j = jb.kv_any if votes_j is None else votes_j | jb.kv_any
        votes_t = tb.kv_any if votes_t is None else votes_t | tb.kv_any
    np.testing.assert_array_equal(n(tsc.votes_from_kv_any(votes_t)),
                                  np.asarray(jsc.votes_from_kv_any(votes_j)))


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [3, 8, 20])
def test_pack_by_mask(cap):
    mask = _rng(7).random((2, 3, 16)) < 0.4
    jperm, jslot = jse.pack_by_mask(jnp.asarray(mask), cap)
    tperm, tslot = tse.pack_by_mask(t(mask), cap)
    np.testing.assert_array_equal(n(tperm), np.asarray(jperm))
    np.testing.assert_array_equal(n(tslot), np.asarray(jslot))


@pytest.mark.parametrize("cap", [2, 5, 16])       # 2 and 5 overflow
@pytest.mark.parametrize("per_head", [False, True])
def test_compact_rows_with_overflow(cap, per_head):
    r = _rng(8)
    L, w = 16, 4
    crit = r.random((1, L)) < 0.5
    crit[:, ::w] = True                      # window heads are critical
    shape = (1, 2, 2, L) if per_head else (1, L)
    base = (np.arange(L) // w) * w
    lead = np.where(r.random(shape) < 0.5, base, np.arange(L))
    lead = np.where(np.broadcast_to(crit, shape) if not per_head
                    else crit[:, None, None, :], np.arange(L), lead)
    lead = lead.astype(np.int32)
    jc = jse.compact_rows(jnp.asarray(crit), cap, leader=jnp.asarray(lead),
                          window=w)
    tc = tse.compact_rows(t(crit), cap, leader=t(lead), window=w)
    for field in ("perm", "src_slot", "n_critical"):
        np.testing.assert_array_equal(n(getattr(tc, field)),
                                      np.asarray(getattr(jc, field)),
                                      err_msg=field)
    # without a window: the legacy last-slot clamp
    jc0 = jse.compact_rows(jnp.asarray(crit), cap)
    tc0 = tse.compact_rows(t(crit), cap)
    np.testing.assert_array_equal(n(tc0.src_slot), np.asarray(jc0.src_slot))


def test_masked_softmax():
    r = _rng(9)
    s = r.normal(size=(2, 5, 12)).astype(np.float32)
    m = r.random((2, 5, 12)) < 0.5
    m[0, 0] = False                          # an all-masked row
    np.testing.assert_allclose(
        n(tse.masked_softmax(t(s), t(m))),
        np.asarray(jse._masked_softmax(jnp.asarray(s), jnp.asarray(m))),
        rtol=1e-5, atol=1e-5)
