"""Paged model execution of the port (packed_torch) against the reference
(packed_xla): the SPLS chunk step over consecutive chunks, the prune
compaction, and the decode tick.

Tolerances: logits after several layers 1e-4 (XLA and torch sum matmuls
in different orders); caches 1e-5; predictor codes, pos ids, column votes
and critical-row counts exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.topk import topk_count
from repro.serving import paged_model as jpm
from repro.serving import pager as jpg
from repro_torch.serving import paged_model as tpm
from repro_torch.serving import pager as tpg

from _torch_parity import cfg_pair, n, params_pair, t

N_PAGES, PS, P = 12, 4, 8
TABLE = [3, 7, 1, 9, 5, 11, 0, 0]      # 6 pages allocated, 2 null entries
LOGITS = dict(rtol=1e-4, atol=1e-4)
CACHE = dict(rtol=1e-5, atol=1e-5)


def _caches(jc, tc):
    jcache = jpg.init_paged_cache(jc, N_PAGES, PS)
    jpred = jpg.init_pred_cache(jc, N_PAGES, PS)
    jpos = jpg.init_pos_pages(N_PAGES, PS)
    tcache = tpg.init_paged_cache(tc, N_PAGES, PS, "cpu")
    tpred = tpg.init_pred_cache(tc, N_PAGES, PS, "cpu")
    tpos = tpg.init_pos_pages(N_PAGES, PS, "cpu")
    return (jcache, jpred, jpos), (tcache, tpred, tpos)


def _assert_state(j, tt, exact_pred=True):
    (jcache, jpred, jpos), (tcache, tpred, tpos) = j, tt
    np.testing.assert_array_equal(n(tpos), np.asarray(jpos))
    for jb, tb in zip(jcache, tcache):
        np.testing.assert_allclose(n(tb.k_pages), np.asarray(jb.k_pages),
                                   **CACHE)
        np.testing.assert_allclose(n(tb.v_pages), np.asarray(jb.v_pages),
                                   **CACHE)
    if jpred is not None and exact_pred:
        for jb, tb in zip(jpred, tpred):
            np.testing.assert_array_equal(n(tb.codes), np.asarray(jb.codes))
            np.testing.assert_allclose(n(tb.scale), np.asarray(jb.scale),
                                       rtol=1e-6)


def _prefill(kind, Lp=20, CS=8, cap=None, seed=0):
    """Chunk a prompt through both packages; returns everything needed by
    the later steps."""
    jc, tc = cfg_pair(kind)
    jp, tp = params_pair(jc)
    j, tt = _caches(jc, tc)
    toks = np.random.default_rng(seed).integers(0, jc.vocab_size, Lp)
    table = np.asarray(TABLE, np.int32)
    k = topk_count(Lp, jc.spls.k_ratio)
    step = jax.jit(functools.partial(
        jpm.paged_prefill_chunk_spls, jc, q_capacity=cap, ffn_capacity=cap,
        compute_backend="packed_xla"))
    jcache, jpred, jpos = j
    tcache, tpred, tpos = tt
    jvotes = tvotes = None
    for start in range(0, Lp, CS):
        valid = min(CS, Lp - start)
        chunk = np.zeros((1, CS), np.int32)
        chunk[0, :valid] = toks[start:start + valid]
        (jl, jcache, jpred, jpos, jkv, jcnt) = step(
            jp, jcache, jpred, jpos, jnp.asarray(table),
            jnp.asarray(start, jnp.int32), jnp.asarray(chunk),
            jnp.asarray(valid, jnp.int32), jnp.asarray(k, jnp.int32))
        tl, tkv, tcnt = tpm.paged_prefill_chunk_spls(
            tc, tp, tcache, tpred, tpos, t(table), start, t(chunk), valid,
            k, q_capacity=cap, ffn_capacity=cap,
            compute_backend="packed_torch")
        np.testing.assert_allclose(n(tl), np.asarray(jl), **LOGITS)
        np.testing.assert_array_equal(n(tkv), np.asarray(jkv))
        np.testing.assert_array_equal(n(tcnt), np.asarray(jcnt))
        jvotes = jkv if jvotes is None else jvotes | jkv
        tvotes = tkv if tvotes is None else tvotes | tkv
        _assert_state((jcache, jpred, jpos), (tcache, tpred, tpos))
    return (jc, tc, jp, tp, (jcache, jpred, jpos), (tcache, tpred, tpos),
            np.asarray(jvotes), n(tvotes))


@pytest.mark.parametrize("kind,cap", [("mha", None), ("gqa_qknorm", 4),
                                      ("gqa_window_softcap", 8)])
def test_chunk_step_compaction_and_decode(kind, cap):
    (jc, tc, jp, tp, j, tt, jvotes, tvotes) = _prefill(kind, cap=cap)
    np.testing.assert_array_equal(tvotes, jvotes)

    # end-of-prefill prune compaction
    Lp, S = 20, P * PS
    votes = jvotes.reshape(jc.n_heads, -1).sum(0)
    keep = np.zeros((S,), bool)
    keep[:Lp] = jpg.keep_from_votes(votes[:Lp], jc.n_heads, 0.5)
    n_kept = int(keep.sum())
    assert 0 < n_kept < Lp              # the vote really pruned columns
    table = np.asarray(TABLE, np.int32)
    jcache, jpos = jpm.compact_slots(j[0], j[2], jnp.asarray(table),
                                     jnp.asarray(keep))
    tpm.compact_slots(tt[0], tt[2], t(table), t(keep))
    _assert_state((jcache, None, jpos), (tt[0], None, tt[2]))

    # decode ticks: row 0 continues the sequence, row 1 is inactive
    tables = np.stack([table, np.zeros_like(table)])
    jcache_d, jpos_d = jcache, jpos
    for i in range(3):
        kv_len = np.asarray([n_kept + i, 0], np.int32)
        cur = np.asarray([Lp + i, 0], np.int32)
        tok = np.asarray([[5 + i], [0]], np.int32)
        jl, jcache_d, jpos_d = jpm.paged_decode_step(
            jc, jp, jcache_d, jpos_d, jnp.asarray(tables),
            jnp.asarray(kv_len), jnp.asarray(cur), jnp.asarray(tok),
            backend="xla_paged_decode")
        tl = tpm.paged_decode_step(tc, tp, tt[0], tt[2], t(tables),
                                   t(kv_len), t(cur), t(tok),
                                   backend="torch_paged_decode")
        np.testing.assert_allclose(n(tl)[0], np.asarray(jl)[0], **LOGITS)
        # the inactive row wrote into the null page: compare real pages
        np.testing.assert_array_equal(n(tt[2])[1:], np.asarray(jpos_d)[1:])
        for jb, tb in zip(jcache_d, tt[0]):
            np.testing.assert_allclose(n(tb.k_pages)[:, :, 1:],
                                       np.asarray(jb.k_pages)[:, :, 1:],
                                       **CACHE)


def test_decode_backends_agree_on_cpu():
    """``cuda_paged_decode`` on CPU tensors takes the plain version, so
    both paged-decode backends give the same tick on the CPU."""
    jc, tc = cfg_pair("gqa_qknorm")
    _, tp = params_pair(jc)
    outs = []
    for backend in ("torch_paged_decode", "cuda_paged_decode"):
        cache = tpg.init_paged_cache(tc, N_PAGES, PS, "cpu")
        pos = tpg.init_pos_pages(N_PAGES, PS, "cpu")
        tables = t(np.asarray([TABLE, [2, 4, 0, 0, 0, 0, 0, 0]], np.int32))
        logits = None
        for i in range(5):
            logits = tpm.paged_decode_step(
                tc, tp, cache, pos, tables,
                t(np.asarray([i, i], np.int32)),
                t(np.asarray([i, i], np.int32)),
                t(np.asarray([[i + 1], [i + 2]], np.int32)), backend=backend)
        outs.append(n(logits))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_chunk_step_validates_inputs():
    _, tc = cfg_pair("mha")
    _, tp = params_pair(cfg_pair("mha")[0])
    cache = tpg.init_paged_cache(tc, N_PAGES, PS, "cpu")
    pred = tpg.init_pred_cache(tc, N_PAGES, PS, "cpu")
    pos = tpg.init_pos_pages(N_PAGES, PS, "cpu")
    table = t(np.asarray(TABLE, np.int32))
    with pytest.raises(ValueError, match="multiple of the SPLS"):
        tpm.paged_prefill_chunk_spls(tc, tp, cache, pred, pos, table, 0,
                                     torch.zeros(1, 6, dtype=torch.int32),
                                     6, 2)
    with pytest.raises(ValueError, match="packed compute backend"):
        tpm.paged_prefill_chunk_spls(tc, tp, cache, pred, pos, table, 0,
                                     torch.zeros(1, 8, dtype=torch.int32),
                                     8, 2, kv_capacity=4,
                                     compute_backend="dense",
                                     live=torch.ones(P * PS, dtype=torch.bool),
                                     last_keep=7)
    with pytest.raises(ValueError, match="liveness mask"):
        tpm.paged_prefill_chunk_spls(tc, tp, cache, pred, pos, table, 0,
                                     torch.zeros(1, 8, dtype=torch.int32),
                                     8, 2, kv_capacity=4,
                                     compute_backend="packed_torch")
