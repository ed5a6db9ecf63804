"""The port's remaining paged-serving modes against the reference, module by
module on the same numpy inputs and bridged weights: the non-SPLS chunk
step, the simulation-mode ("dense") SPLS chunk step with and without a
liveness mask, the ``vote_horizon == 1`` chunk step with its packed K/V
projection, the three horizon planner functions, and ``packed_project_kv``.
Then, in the port's engine, the host's liveness mask against the columns
the device actually wrote.

Tolerances (PERF.md's table): logits after several layers 1e-4; caches and
single float32 modules 1e-5; pos ids, predictor codes, column votes,
critical-row counts and planner decisions exact.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planner as jpl
from repro.core.topk import topk_count
from repro.models.attention import project_kv as j_project_kv
from repro.serving import paged_model as jpm
from repro.serving import pager as jpg
from repro.sparse_compute.packed import packed_project_kv as j_packed_kv
from repro_torch.core import planner as tpl
from repro_torch.models.attention import project_kv as t_project_kv
from repro_torch.observability import MetricsRegistry
from repro_torch.serving import PagedServingEngine, Request, ServeConfig
from repro_torch.serving import paged_model as tpm
from repro_torch.serving import pager as tpg
from repro_torch.sparse_compute import packed_project_kv as t_packed_kv

from _torch_parity import cfg_pair, n, params_pair, t

N_PAGES, PS, P = 12, 4, 8
TABLE = [3, 7, 1, 9, 5, 11, 0, 0]      # 6 pages allocated, 2 null entries
S = P * PS
LOGITS = dict(rtol=1e-4, atol=1e-4)
CACHE = dict(rtol=1e-5, atol=1e-5)


def _pools(jc, tc, pred=True):
    j = (jpg.init_paged_cache(jc, N_PAGES, PS),
         jpg.init_pred_cache(jc, N_PAGES, PS) if pred else None,
         jpg.init_pos_pages(N_PAGES, PS))
    tt = (tpg.init_paged_cache(tc, N_PAGES, PS, "cpu"),
          tpg.init_pred_cache(tc, N_PAGES, PS, "cpu") if pred else None,
          tpg.init_pos_pages(N_PAGES, PS, "cpu"))
    return j, tt


def _assert_pools(j, tt, skip_null=False):
    """pos ids exact; K/V pages 1e-5; predictor codes exact.  With
    ``skip_null`` the null page 0 (where padded rows and dropped K/V pack
    slots scatter, in an unspecified order) is left out of the K/V check."""
    (jcache, jpred, jpos), (tcache, tpred, tpos) = j, tt
    np.testing.assert_array_equal(n(tpos), np.asarray(jpos))
    lo = 1 if skip_null else 0
    for jb, tb in zip(jcache, tcache):
        for a, b in ((tb.k_pages, jb.k_pages), (tb.v_pages, jb.v_pages)):
            np.testing.assert_allclose(n(a)[:, :, lo:],
                                       np.asarray(b)[:, :, lo:], **CACHE)
    if jpred is not None:
        for jb, tb in zip(jpred, tpred):
            np.testing.assert_array_equal(n(tb.codes), np.asarray(jb.codes))
            np.testing.assert_allclose(n(tb.scale), np.asarray(jb.scale),
                                       rtol=1e-6)


def _chunks(Lp, CS, vocab, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, Lp)
    for start in range(0, Lp, CS):
        valid = min(CS, Lp - start)
        chunk = np.zeros((1, CS), np.int32)
        chunk[0, :valid] = toks[start:start + valid]
        yield start, valid, chunk


@pytest.mark.parametrize("kind", ["mha", "gqa_window_softcap"])
def test_chunk_step_without_spls(kind):
    """``paged_prefill_chunk`` over three chunks (the last one partial):
    cross-chunk causal attention by original position, the block's window
    and soft-cap, the LM head on the last valid row."""
    jc, tc = cfg_pair(kind, spls=dict(enabled=False))
    jp, tp = params_pair(jc)
    j, tt = _pools(jc, tc, pred=False)
    table = np.asarray(TABLE, np.int32)
    step = jax.jit(functools.partial(jpm.paged_prefill_chunk, jc))
    jcache, _, jpos = j
    for start, valid, chunk in _chunks(20, 8, jc.vocab_size, seed=4):
        jl, jcache, jpos = step(jp, jcache, jpos, jnp.asarray(table),
                                jnp.asarray(start, jnp.int32),
                                jnp.asarray(chunk),
                                jnp.asarray(valid, jnp.int32))
        tl = tpm.paged_prefill_chunk(tc, tp, tt[0], tt[2], t(table), start,
                                     t(chunk), valid)
        assert tl.shape == (1, 1, jc.vocab_size)
        np.testing.assert_allclose(n(tl), np.asarray(jl), **LOGITS)
        _assert_pools((jcache, None, jpos), tt)


def _spls_chunks(kind, compute, Lp=20, CS=8, live_fn=None, kv_cap=None,
                 vote_need=1, spls=None, seed=0):
    """Chunk a prompt through both packages' SPLS chunk step with the same
    liveness mask (``live_fn(start)`` -> (S,) bool or None); every chunk's
    logits, column votes, counts and pools are compared."""
    jc, tc = cfg_pair(kind, spls=spls)
    jp, tp = params_pair(jc)
    j, tt = _pools(jc, tc)
    table = np.asarray(TABLE, np.int32)
    k = topk_count(Lp, jc.spls.k_ratio)
    jcompute = {"packed_torch": "packed_xla"}.get(compute, compute)
    step = jax.jit(functools.partial(
        jpm.paged_prefill_chunk_spls, jc, kv_capacity=kv_cap,
        compute_backend=jcompute, kv_vote_need=vote_need))
    jcache, jpred, jpos = j
    for start, valid, chunk in _chunks(Lp, CS, jc.vocab_size, seed):
        live = live_fn(start) if live_fn else None
        extra = {}
        if live is not None:
            extra = dict(live=jnp.asarray(live),
                         last_keep=jnp.asarray(Lp - 1, jnp.int32))
        jl, jcache, jpred, jpos, jkv, jcnt = step(
            jp, jcache, jpred, jpos, jnp.asarray(table),
            jnp.asarray(start, jnp.int32), jnp.asarray(chunk),
            jnp.asarray(valid, jnp.int32), jnp.asarray(k, jnp.int32),
            **extra)
        tl, tkv, tcnt = tpm.paged_prefill_chunk_spls(
            tc, tp, tt[0], tt[1], tt[2], t(table), start, t(chunk), valid,
            k, kv_capacity=kv_cap, compute_backend=compute,
            live=None if live is None else t(live),
            last_keep=None if live is None else Lp - 1,
            kv_vote_need=vote_need)
        np.testing.assert_allclose(n(tl), np.asarray(jl), **LOGITS)
        np.testing.assert_array_equal(n(tkv), np.asarray(jkv))
        np.testing.assert_array_equal(n(tcnt), np.asarray(jcnt))
        _assert_pools((jcache, jpred, jpos), tt,
                      skip_null=kv_cap is not None)
    return n(tcnt)


def _every_other_column_dead(start):
    """A liveness mask as a finite horizon leaves it: some columns of
    earlier chunks finalized as pruned."""
    live = np.ones((S,), bool)
    live[1:start:3] = False
    return live


@pytest.mark.parametrize("kind,live_fn", [
    ("mha", None), ("gqa_window_softcap", None),
    ("gqa_qknorm", _every_other_column_dead)])
def test_dense_spls_chunk_step(kind, live_fn):
    """The simulation-mode branch: Q, K, V for every row, similar rows read
    their leader's Q row, mask row and FFN output; with a liveness mask the
    finalized columns are denied attention."""
    counts = _spls_chunks(kind, "dense", live_fn=live_fn)
    assert (counts[:, 2] == 0).all()     # no K/V pack without kv_capacity


@pytest.mark.parametrize("kv_cap", [8, 3])
def test_horizon_chunk_step_packs_kv(kv_cap):
    """``vote_horizon == 1`` on packed compute: layer 0 decides which of the
    chunk's own columns win ``vote_need`` heads, packs them to
    ``kv_capacity`` with the last prompt position's slot reserved, and only
    those are projected and written; capacity 3 overflows."""
    def live_fn(start):
        return _every_other_column_dead(start)

    counts = _spls_chunks("gqa_qknorm", "packed_torch", live_fn=live_fn,
                          kv_cap=kv_cap, vote_need=2,
                          spls=dict(k_ratio=0.25))
    assert counts[:, 2].max() > 0
    if kv_cap == 3:
        assert counts[:, 2].max() > kv_cap   # the pack really overflowed


# ---------------------------------------------------------------------------
# the horizon planner functions
# ---------------------------------------------------------------------------

def test_own_column_keep_and_pack_match_reference():
    """Exact, for chunks at the start, the middle and past the table's end,
    with the anchor inside and outside the chunk and every capacity from
    overflow to none."""
    rng = np.random.default_rng(0)
    CS, last = 8, 29
    for start, valid in ((0, 8), (8, 8), (24, 6), (28, 4)):
        kv_any = rng.random((1, 2, 2, 32)) < 0.3
        for need in (1, 2, 4):
            jk = np.asarray(jpl.own_column_keep(
                jnp.asarray(kv_any), start=jnp.int32(start), chunk=CS,
                valid=jnp.int32(valid), last_keep=jnp.int32(last),
                vote_need=need))
            tk = tpl.own_column_keep(t(kv_any), start=start, chunk=CS,
                                     valid=valid, last_keep=last,
                                     vote_need=need)
            np.testing.assert_array_equal(n(tk), jk)
            anchor = start + np.arange(CS) == last
            for cap in (1, 2, 3, 8):
                for anc in (None, anchor):
                    jw = np.asarray(jpl.pack_within_capacity(
                        jnp.asarray(jk), cap,
                        anchor=None if anc is None else jnp.asarray(anc)))
                    tw = tpl.pack_within_capacity(
                        t(jk), cap, anchor=None if anc is None else t(anc))
                    np.testing.assert_array_equal(n(tw), jw)


def test_anchor_survives_overflow():
    """Every column kept, capacity 3, the anchor at the chunk's end: it
    keeps its reserved slot, the other two slots go to the first kept
    columns; without an anchor the cap is the plain prefix rule."""
    keep = torch.ones(8, dtype=torch.bool)
    anchor = torch.arange(8) == 7
    w = n(tpl.pack_within_capacity(keep, 3, anchor=anchor))
    np.testing.assert_array_equal(w, [1, 1, 0, 0, 0, 0, 0, 1])
    none = torch.zeros(8, dtype=torch.bool)
    np.testing.assert_array_equal(
        n(tpl.pack_within_capacity(keep, 3, anchor=none)),
        n(tpl.pack_within_capacity(keep, 3)))


@pytest.mark.parametrize("horizon,kv_cap", [(1, 3), (1, None), (2, None),
                                            (3, None)])
def test_horizon_update_live_matches_reference(horizon, kv_cap):
    """Exact liveness and counters over a streamed prompt (the port keeps a
    copy of the reference's numpy function; the counters go to the port's
    own registry)."""
    from repro.observability import MetricsRegistry as JMetrics

    rng = np.random.default_rng(horizon)
    CS, Lp = 8, 30
    jm, tm = JMetrics(), MetricsRegistry()
    jlive = tlive = np.ones((S,), bool)
    votes = np.zeros((S,), np.int32)
    for start in range(0, Lp, CS):
        valid = min(CS, Lp - start)
        votes[:start + valid] += rng.integers(0, 2, start + valid)
        kw = dict(start=start, valid=valid, chunk=CS, horizon=horizon,
                  last_keep=Lp - 1, vote_need=2, kv_capacity=kv_cap)
        jlive = jpl.horizon_update_live(jlive, votes, metrics=jm, **kw)
        tlive = tpl.horizon_update_live(tlive, votes, metrics=tm, **kw)
        np.testing.assert_array_equal(tlive, jlive)
    assert tlive[Lp - 1]
    assert not tlive[:Lp].all()
    for name in ("spls/horizon_finalized_cols",
                 "spls/horizon_kv_capacity_drops"):
        a, b = jm.get(name), tm.get(name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.value == a.value, name


# ---------------------------------------------------------------------------
# packed K/V projection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mha", "gqa_qknorm"])
def test_packed_project_kv(kind):
    """Slot ``c`` is row ``perm[c]`` of the dense projection: exact through
    the ``dense`` backend (rows of the same product), within 1e-5 of the
    reference's ``packed_xla`` and of the dense rows through
    ``packed_torch`` (float64 sums, rounded once, as the kernel does);
    ``project_kv``'s ``perm`` seam is the same function."""
    jc, tc = cfg_pair(kind)
    jp, tp = params_pair(jc)
    r = np.random.default_rng(5)
    L = 16
    xn = r.standard_normal((1, L, jc.d_model)).astype(np.float32)
    pos = (np.arange(L) * 3 + 2).astype(np.int32)
    perm = np.asarray([0, 3, 4, 9, 15, 2], np.int32)
    jl = jax.tree.map(lambda a: a[0], jp["periods"][0]["attn"])
    tl = {k: v[0] for k, v in tp["periods"][0]["attn"].items()}
    jk, jv = j_packed_kv(jc, jl, jnp.asarray(xn), jnp.asarray(pos),
                         jnp.asarray(perm), "packed_xla")
    dk, dv = t_project_kv(tc, tl, t(xn), t(pos)[None, :])
    for backend in ("dense", "packed_torch", "packed_cuda"):
        tk, tv = t_packed_kv(tc, tl, t(xn), t(pos), t(perm), backend)
        sk, sv = t_project_kv(tc, tl, t(xn), t(pos)[None, :], perm=t(perm),
                              compute_backend=backend)
        np.testing.assert_array_equal(n(sk), n(tk))
        np.testing.assert_array_equal(n(sv), n(tv))
        np.testing.assert_allclose(n(tk), np.asarray(jk), **CACHE)
        np.testing.assert_allclose(n(tv), np.asarray(jv), **CACHE)
        rows_k, rows_v = n(dk)[:, :, perm], n(dv)[:, :, perm]
        if backend == "dense":
            np.testing.assert_array_equal(n(tk), rows_k)
            np.testing.assert_array_equal(n(tv), rows_v)
        else:
            np.testing.assert_allclose(n(tk), rows_k, **CACHE)
            np.testing.assert_allclose(n(tv), rows_v, **CACHE)
    # the reference's own dense rows, for the bridge
    rk, _ = j_project_kv(jc, jl, jnp.asarray(xn), jnp.asarray(pos)[None, :])
    np.testing.assert_allclose(n(dk), np.asarray(rk), **CACHE)


# ---------------------------------------------------------------------------
# the engine's liveness mask against what the device wrote
# ---------------------------------------------------------------------------

POISON = 1e30     # finite, so a masked-out slot still contributes 0 * v


class _LiveChecker(PagedServingEngine):
    """Before each SPLS chunk, fills the chunk's own K/V slots with
    ``POISON`` in every layer; after it, holds ``st.live`` over those slots
    against the slots whose K/V the device actually wrote and against
    ``pos_pages`` (each slot names its original position)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.checked = 0
        self.anchors = []

    def _slots(self, st, start, valid):
        return torch.as_tensor(self._dest_slots(st, start + valid)[start:])

    def _spls_chunk(self, st, start, valid, table, toks):
        flat = self._slots(st, start, valid)
        for pc in self.cache:
            for pages in (pc.k_pages, pc.v_pages):
                nP, KV, N, ps, Dh = pages.shape
                pages.view(nP, KV, N * ps, Dh)[:, :, flat] = POISON
        logits = super()._spls_chunk(st, start, valid, table, toks)
        written = np.ones((valid,), bool)
        for pc in self.cache:
            for pages in (pc.k_pages, pc.v_pages):
                nP, KV, N, ps, Dh = pages.shape
                rows = pages.view(nP, KV, N * ps, Dh)[:, :, flat]
                old = (rows == POISON).all(-1).all(1).all(0).numpy()
                new = (rows.abs() < 1e6).all(-1).all(1).all(0).numpy()
                assert (old | new).all()      # a column is written whole
                written &= new
        np.testing.assert_array_equal(written,
                                      st.live[start:start + valid])
        np.testing.assert_array_equal(
            n(self.pos_pages.view(-1)[flat]),
            np.arange(start, start + valid))
        if start + valid == st.prompt_len:
            self.anchors.append(bool(st.live[st.prompt_len - 1]))
        self.checked += 1
        return logits


@pytest.mark.parametrize("cap", [None, 2])
def test_engine_live_mask_matches_written_columns(cap):
    """``vote_horizon=1`` with packed compute (every head must agree: prune
    vote 1.0) on random and repeated-token prompts: after every chunk the
    host's ``st.live`` equals the columns whose K/V the device wrote; the
    last prompt position stays live, decode runs on it, and the engine
    drains.  ``cap`` 2 pins the K/V capacity below the kept columns, so
    every chunk overflows and the anchor's reserved slot is what keeps it."""
    _, tc = cfg_pair("gqa_qknorm")
    _, tp = params_pair(cfg_pair("gqa_qknorm")[0])
    scfg = ServeConfig(n_slots=2, max_len=64, page_size=4, prefill_chunk=8,
                       compute_backend="packed_torch",
                       attn_backend="torch_paged_decode", vote_horizon=1,
                       spls_prune_vote=1.0, capacity_margin=1.0)
    eng = _LiveChecker(tc, tp, scfg, device="cpu")
    if cap is not None:
        eng._cap_kv.capacity = lambda: cap
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tc.vocab_size, 30),
               np.repeat(rng.integers(0, tc.vocab_size, 8), 4)[:29],
               rng.integers(0, tc.vocab_size, 21)]
    reqs = [Request(rid=i, prompt=p.astype(np.int32), max_new_tokens=4)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_ticks=500)
    assert all(r.done and len(r.output) == 4 for r in reqs)
    assert eng.checked == sum(math.ceil(len(p) / 8) for p in prompts)
    assert eng.anchors == [True] * 3
    m = eng.telemetry.metrics
    assert m.get("spls/horizon_finalized_cols").value > 0
    if cap is not None:
        assert eng.stats["capacity_kv"]["overflows"] > 0
        assert m.get("spls/horizon_kv_capacity_drops").value > 0
