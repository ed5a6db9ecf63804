"""The port's kernels: plain versions against the reference's Pallas
kernels (interpret mode on the CPU), routing by device, and -- on a card
only -- the CUDA kernels against their plain versions.

Tolerances: gathers are exact; the gathered matmul and the paged decode
agree to rtol = atol = 1e-5 (float32 sums in another order), and so does
the float32 emulation of the paged decode kernel's split-and-merge order;
on the card the gathered matmul agrees with its plain version to 1e-6 x
max(1, max |plain|) (both round a float64 sum once), and a bf16 decode to
one bf16 ulp of the plain output or 1e-5, whichever is larger (float32
sums in another order move an element by about 1e-6 before it is rounded);
the float64 emulation of the kernel's split-K order equals the plain
version bit for bit.  The bf16 smoke model, kernels against plain
backends on the card: logits within 5e-2 x max |plain logits| (bf16
rounds the two routes' float32 sums at other places); on the CPU, the
port's kernel backends against the reference's Pallas routes: logits
within 4 bf16 eps x max |reference|, one layer's packed ops within 1 eps.

The machine with the card has no JAX, so this file also imports without
it: the ``cuda`` tests run there (``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels.py``) and the reference-parity tests skip.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.gathered_matmul import (GMM_BK, GMM_MAX_SPLITS,
                                                 GMM_MIN_SLICES, gmm_tiling)
from repro_torch.kernels.paged_decode import (paged_split_count,
                                              paged_split_ranges)

try:
    import jax  # noqa: F401
    import jax.numpy as jnp
    from repro.kernels.gathered_matmul import (gather_rows_kernel,
                                               gathered_matmul as jax_gmm)
    from repro.kernels.paged_decode import paged_flash_decode as jax_paged
except ImportError:          # the card's machine: only the cuda tests run
    jnp = None

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def reference():
    """The reference package's Pallas kernels (interpret mode)."""
    if jnp is None:
        pytest.skip("needs the reference JAX package")


def _gmm_inputs(L, D, F, C, seed, M=None):
    r = np.random.default_rng(seed)
    x = r.normal(size=(L, D)).astype(np.float32)
    w = (r.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)
    perm = r.integers(0, L, size=C).astype(np.int32)
    perm[C // 2:] = perm[:C - C // 2]                  # repeated rows
    slot = None if M is None else r.integers(0, C, size=M).astype(np.int32)
    return x, w, perm, slot


GMM_SHAPES = [(16, 32, 48, 8, None),     # ragged F vs the 128 tile
              (24, 64, 100, 13, None),   # ragged C and F
              (20, 32, 64, 40, None),    # C > L
              (16, 32, 72, 12, 16)]      # fused leader scatter


@pytest.mark.parametrize("L,D,F,C,M", GMM_SHAPES)
def test_gathered_matmul_plain_vs_pallas(reference, L, D, F, C, M):
    x, w, perm, slot = _gmm_inputs(L, D, F, C, seed=L + F, M=M)
    ref = jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(perm),
                  src_slot=None if slot is None else jnp.asarray(slot),
                  bm=8, bn=32, interpret=True)
    got = K.gathered_matmul_plain(t(x), t(w), t(perm),
                                  None if slot is None else t(slot))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("C,F,M", [(8, 16, 20), (5, 33, 7)])
def test_gather_rows_plain_vs_pallas(reference, C, F, M):
    r = np.random.default_rng(C)
    src = r.normal(size=(C, F)).astype(np.float32)
    idx = r.integers(0, C, size=M).astype(np.int32)
    ref = gather_rows_kernel(jnp.asarray(src), jnp.asarray(idx),
                             interpret=True)
    np.testing.assert_array_equal(n(K.gather_rows_plain(t(src), t(idx))),
                                  np.asarray(ref))


def _paged_inputs(B, KV, G, Dh, N, ps, P, lens, seed, compact=False):
    """Pool with garbage in the null page and in unwritten slots; with
    ``compact`` the written ids skip like an SPLS-compacted layout."""
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, KV, G, Dh)).astype(np.float32)
    kp = r.normal(size=(KV, N, ps, Dh)).astype(np.float32)
    vp = r.normal(size=(KV, N, ps, Dh)).astype(np.float32)
    kp[:, 0] = 1e3
    vp[:, 0] = -1e3
    pos_pages = np.full((N, ps), 1 << 30, np.int32)
    tables = np.zeros((B, P), np.int32)
    pos = np.zeros((B,), np.int32)
    free = list(r.permutation(np.arange(1, N)))
    for b, L in enumerate(lens):
        pages = [free.pop() for _ in range(-(-L // ps))]
        tables[b, :len(pages)] = pages
        ids = np.arange(L) * (2 if compact else 1) + (b if compact else 0)
        for s in range(L):
            pos_pages[pages[s // ps], s % ps] = ids[s]
        pos[b] = ids[-1] + 1 if L else 0
    return (q, kp, vp, pos_pages, tables, np.asarray(lens, np.int32), pos)


PAGED_CASES = {
    "ragged": dict(G=1, lens=[5, 15, 1], compact=False),
    "compacted_window": dict(G=1, lens=[9, 14, 3], compact=True, window=6),
    "softcap": dict(G=1, lens=[12, 7, 16], softcap=5.0),
    "gqa_window_softcap": dict(G=3, lens=[11, 2, 16], compact=True,
                               window=9, softcap=8.0),
    "kv_len_0": dict(G=2, lens=[0, 6, 16]),
    # two passes of 8 query rows in the kernel
    "gqa_g16": dict(G=16, lens=[10, 0, 16], compact=True, window=7,
                    softcap=6.0),
}


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_decode_plain_vs_pallas(reference, case):
    c = PAGED_CASES[case]
    inp = _paged_inputs(3, 2, c["G"], 8, 12, 4, 4, c["lens"], seed=len(case),
                        compact=c.get("compact", False))
    kw = dict(softcap=c.get("softcap"), window=c.get("window"))
    ref = jax_paged(*(jnp.asarray(a) for a in inp), interpret=True, **kw)
    got = K.paged_decode_plain(*(t(a) for a in inp), **kw)
    assert np.isfinite(n(got)).all()
    np.testing.assert_allclose(n(got), np.asarray(ref), **TOL)
    if 0 in c["lens"]:
        assert not n(got)[c["lens"].index(0)].any()    # nothing to attend


@pytest.mark.parametrize("pairs,P,ps,window,want", [
    (48, 32, 16, None, 8), (768, 32, 16, None, 2), (4096, 32, 16, None, 1),
    (48, 32, 16, 40, 3), (48, 32, 16, 5, 1), (48, 2, 16, None, 2),
    (6, 4, 4, None, 1), (6, 1, 16, None, 1), (6, 8, 16, None, 8)])
def test_paged_split_count(pairs, P, ps, window, want):
    """From the shapes alone (kv_len lies on the card): about 8 blocks per
    SM, at most 8 splits, none under 16 live slots, no more than P."""
    assert paged_split_count(pairs, P, ps, window) == want


@pytest.mark.parametrize("ps", [1, 4, 16])
@pytest.mark.parametrize("nsplit", range(1, 9))
def test_paged_split_ranges_cover_the_written_slots_once(ps, nsplit):
    """Every written slot exactly once, in order, in shares of whole pages
    (every boundary but the last on a page edge); empty shares last."""
    P = 6
    for kv_len in range(0, P * ps + 1):
        ranges = paged_split_ranges(kv_len, ps, nsplit)
        assert len(ranges) == nsplit
        assert [j for a, b in ranges for j in range(a, b)] == \
            list(range(kv_len))
        assert all(b0 == a1 for (_, b0), (a1, _) in zip(ranges, ranges[1:]))
        for a, b in ranges:
            assert a % ps == 0 or a == kv_len
            assert b % ps == 0 or b == kv_len
        sizes = [b - a for a, b in ranges]
        full = [x for x in sizes if x]
        assert sizes == full + [0] * (nsplit - len(full))
        assert all(x == sizes[0] for x in full[:-1])    # equal whole pages
        assert not full or full[-1] <= full[0]


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def _online_merge(ms, ls, accs):
    """Merge partial softmax states along axis 0 in order (the kernel's
    fmaf chain is a float32 sum in the same order)."""
    M = ms.max(0)
    w = np.where(ms == -np.inf, 0.0,
                 np.exp(ms - np.where(M == -np.inf, 0.0, M)))
    w = w.astype(np.float32)
    return M, (ls * w).sum(0), (accs * w[..., None]).sum(0)


def _paged_split_merge_emulation(q, kp, vp, pos_pages, tables, kv_len, pos,
                                 softcap=None, window=None, nsplit=None):
    """The paged decode kernel's order in float32: per (b, kv head) the
    written slots cut into shares of whole pages by
    :func:`paged_split_ranges`; in each share (tiles of up to 128 table
    entries), 128 / R row groups take the slots in turn, U at a time, each
    with its own online softmax, a slot out of the window masked by its
    original id; the groups merge in group order, the splits in split
    order."""
    q, kp, vp = (np.asarray(a, np.float32) for a in (q, kp, vp))
    B, KV, G, Dh = q.shape
    N, ps = kp.shape[1], kp.shape[2]
    P = tables.shape[1]
    if nsplit is None:
        nsplit = paged_split_count(B * KV, P, ps, window)
    lanes = Dh // 4 if Dh % 4 == 0 else Dh
    R = min(32, _pow2_at_least(lanes))
    E = (4 if Dh % 4 == 0 else 1) * _pow2_at_least(-(-lanes // R))
    NG, U = 128 // R, (1 if G > 1 or Dh % 4 else 2) if E >= 8 else 4
    scale = np.float32(Dh ** -0.5)
    out = np.zeros_like(q)
    slots = np.arange(P * ps)
    for b in range(B):
        n = min(max(int(kv_len[b]), 0), P * ps)
        page = np.clip(tables[b], 0, N - 1)[slots // ps]
        live = np.ones(P * ps, bool) if window is None else \
            int(pos[b]) - pos_pages[page, slots % ps] < window
        for h in range(KV):
            krow, vrow = kp[h, page, slots % ps], vp[h, page, slots % ps]
            parts = []
            for s0, s1 in paged_split_ranges(n, ps, nsplit):
                m = np.full((NG, G), -np.inf, np.float32)
                l = np.zeros((NG, G), np.float32)
                acc = np.zeros((NG, G, Dh), np.float32)
                for t0 in range(s0, s1, 128 * ps):
                    t1 = min(s1, t0 + 128 * ps)
                    for it in range(-(-(t1 - t0) // (NG * U))):
                        j = (t0 + it * NG * U + np.arange(NG)[:, None]
                             + np.arange(U)[None, :] * NG)     # (NG, U)
                        jj = np.where(j < t1, j, 0)
                        ok = (j < t1) & live[jj]
                        sc = np.einsum("gd,rud->rgu", q[b, h], krow[jj])
                        sc = sc * scale
                        if softcap is not None:
                            sc = np.tanh(sc / softcap) * softcap
                        sc = np.where(ok[:, None, :], sc, -np.inf)
                        mx = np.maximum(m, sc.max(-1))
                        on = mx != -np.inf
                        mxs = np.where(on, mx, 0.0)
                        c = np.where(on, np.exp(m - mxs), 1.0)
                        pr = np.exp(sc - mxs[..., None])
                        l = np.where(on, l * c + pr.sum(-1), l)
                        acc = np.where(on[..., None], acc * c[..., None]
                                       + np.einsum("rgu,rud->rgd", pr,
                                                   vrow[jj]), acc)
                        m = np.where(on, mx, m)
                parts.append(_online_merge(m, l, acc))
            M, L, A = _online_merge(*(np.stack(x) for x in zip(*parts)))
            out[b, h] = np.where(L[:, None] > 0, A / np.where(
                L[:, None] > 0, L[:, None], 1.0), 0.0)
    return out


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_split_merge_emulation(case):
    """The kernel's split-and-merge order in float32 against the plain
    version, within 1e-5, at the split count of the shapes."""
    c = PAGED_CASES[case]
    inp = _paged_inputs(3, 2, c["G"], 8, 12, 4, 4, c["lens"], seed=len(case),
                        compact=c.get("compact", False))
    kw = dict(softcap=c.get("softcap"), window=c.get("window"))
    got = _paged_split_merge_emulation(*inp, **kw)
    want = n(K.paged_decode_plain(*(t(a) for a in inp), **kw))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("nsplit", range(1, 9))
@pytest.mark.parametrize("G,Dh,window", [(1, 64, None), (16, 20, 45),
                                         (1, 250, 30)])
def test_paged_split_merge_emulation_splits(nsplit, G, Dh, window):
    """Each split count the kernel can take, at G 1 (float4 rows) and G 16
    (two passes, scalar rows), with kv_len 0, a full table and a last page
    written in part."""
    inp = _paged_inputs(4, 2, G, Dh, 40, 8, 8, [0, 64, 29, 57],
                        seed=nsplit, compact=True)
    kw = dict(softcap=None, window=window)
    got = _paged_split_merge_emulation(*inp, nsplit=nsplit, **kw)
    want = n(K.paged_decode_plain(*(t(a) for a in inp), **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[0].any()                         # kv_len 0: zeros


def _bf16_smoke(device, kernels: bool):
    """The bf16 smoke form of the paper's BERT-Base: ``forward``, a
    ``prefill`` then two ``decode_step`` calls, and two paged decode ticks,
    through the kernel backends or the plain ones."""
    from repro_torch.configs.bert_base_esact import CONFIG
    from repro_torch.models import model as tm
    from repro_torch.serving import paged_model as tpm
    from repro_torch.serving import pager as tpg

    cfg = dataclasses.replace(CONFIG.smoke(), compute_dtype="bfloat16",
                              attn_backend="cuda_flash" if kernels
                              else "torch_flash")
    dec = dataclasses.replace(cfg, attn_backend="cuda_flash_decode"
                              if kernels else "torch_flash_decode")
    params = tm.init_params(cfg, seed=0, device=device)
    r = np.random.default_rng(3)
    toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (2, 24))
                            .astype(np.int32)).to(device)
    out = {"forward": tm.forward(cfg, params, toks)}
    logits, cache = tm.prefill(cfg, params, toks, max_len=32,
                               plan_mode="progressive")
    pos = torch.tensor([24, 24], dtype=torch.int32, device=device)
    nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    for i in range(2):
        out[f"decode_{i}"], cache = tm.decode_step(dec, params, cache, nxt,
                                                   pos + i)
    N, ps = 12, 4
    pcache = tpg.init_paged_cache(cfg, N, ps, device)
    ppos = tpg.init_pos_pages(N, ps, device)
    tables = torch.tensor([[3, 7, 1, 0], [2, 4, 0, 0]], dtype=torch.int32,
                          device=device)
    for i in range(2):
        out[f"paged_tick_{i}"] = tpm.paged_decode_step(
            cfg, params, pcache, ppos, tables,
            torch.tensor([i, i + 3], dtype=torch.int32, device=device),
            torch.tensor([i, i + 3], dtype=torch.int32, device=device),
            toks[:, i:i + 1].contiguous(),
            backend="cuda_paged_decode" if kernels else "torch_paged_decode")
    return out


BF16_EPS = 2.0 ** -7            # torch.finfo(torch.bfloat16).eps


def _bf16_pair():
    """(reference config, port config, reference params, port params): the
    bf16 smoke form of the paper's BERT-Base, SPLS off, on bridged weights.
    SPLS is off because a bf16 rounding that differs between XLA's and
    torch's float32 sums flips a top-k near-tie of the plan (float32 ones
    do too, on these inputs), and a flipped plan is another computation."""
    import jax
    from repro.configs.bert_base_esact import CONFIG as JCONFIG
    from repro.models import init_params as jax_init_params
    from repro_torch.configs.bert_base_esact import CONFIG
    from repro_torch.weights import params_from_jax

    jc, tc = (dataclasses.replace(
        c.smoke(), compute_dtype="bfloat16",
        spls=dataclasses.replace(c.smoke().spls, enabled=False))
        for c in (JCONFIG, CONFIG))
    jp = jax_init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _bf16_model_entry(entry, jc, tc, jp, tp):
    """The same bf16 call through the reference (its Pallas kernels,
    interpret mode) and the port (the kernel backends' names, which take
    the plain versions on the CPU): ``[(name, reference out, port out)]``."""
    from repro.models import model as jm
    from repro.serving import paged_model as jpm
    from repro.serving import pager as jpg
    from repro_torch.models import model as tm
    from repro_torch.serving import paged_model as tpm
    from repro_torch.serving import pager as tpg

    jc = dataclasses.replace(jc, attn_backend="pallas_flash")
    tc = dataclasses.replace(tc, attn_backend="cuda_flash")
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 24)
                                             ).astype(np.int32)
    out = []
    if entry == "forward":
        out.append(("forward", jm.forward(jc, jp, jnp.asarray(toks)),
                    tm.forward(tc, tp, t(toks))))
    elif entry == "prefill_decode":
        jl, jcache = jm.prefill(jc, jp, jnp.asarray(toks), max_len=32,
                                plan_mode="progressive")
        tl, tcache = tm.prefill(tc, tp, t(toks), max_len=32,
                                plan_mode="progressive")
        out.append(("prefill", jl, tl))
        jdc = dataclasses.replace(jc, attn_backend="pallas_flash_decode")
        tdc = dataclasses.replace(tc, attn_backend="cuda_flash_decode")
        pos = np.array([24, 24], np.int32)
        nxt = toks[:, -1:]
        for i in range(2):
            jd, jcache = jm.decode_step(jdc, jp, jcache, jnp.asarray(nxt),
                                        jnp.asarray(pos + i))
            td, tcache = tm.decode_step(tdc, tp, tcache, t(nxt), t(pos + i))
            out.append((f"decode_{i}", jd, td))
            nxt = toks[:, i:i + 1]
    else:                                   # three paged decode ticks
        N, ps = 12, 4
        jpc, jpp = jpg.init_paged_cache(jc, N, ps), jpg.init_pos_pages(N, ps)
        tpc = tpg.init_paged_cache(tc, N, ps, "cpu")
        tpp = tpg.init_pos_pages(N, ps, "cpu")
        tables = np.array([[3, 7, 1, 0], [2, 4, 0, 0]], np.int32)
        for i in range(3):
            kl = np.array([i, i + 3], np.int32)
            jo, jpc, jpp = jpm.paged_decode_step(
                jc, jp, jpc, jpp, jnp.asarray(tables), jnp.asarray(kl),
                jnp.asarray(kl), jnp.asarray(toks[:, i:i + 1]),
                backend="pallas_paged_decode")
            to = tpm.paged_decode_step(
                tc, tp, tpc, tpp, t(tables), t(kl), t(kl),
                t(toks[:, i:i + 1]), backend="cuda_paged_decode")
            out.append((f"paged_tick_{i}", jo, to))
    return out


def _bf16_packed_entry(entry, jc, tc, jp, tp):
    """Layer 0's packed Q projection or packed MLP on the same bf16 rows,
    ``packed_pallas`` (the reference's Pallas kernels) against
    ``packed_cuda`` (the port's float32 casts around the kernels' plain
    versions): ``[(name, reference out, port out)]``."""
    import jax
    from repro.core.sparse_exec import Compaction as JCompaction
    from repro.sparse_compute import packed as jpk
    from repro_torch.core.sparse_exec import Compaction as TCompaction
    from repro_torch.sparse_compute import packed as tpk

    r = np.random.default_rng(4)
    L, C = 24, 10
    x = r.normal(size=(1, L, jc.d_model)).astype(np.float32)
    perm = r.choice(L, C, replace=False).astype(np.int32)
    part = "attn" if entry == "packed_q" else "ffn"
    jl0 = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16),
                       jp["periods"][0][part])
    tl0 = {k: v[0].bfloat16() for k, v in tp["periods"][0][part].items()}
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), t(x).bfloat16()
    if entry == "packed_q":
        pos = np.arange(L, dtype=np.int32) * 2 + 1
        return [("packed_q",
                 jpk.packed_project_q(jc, jl0, jx, jnp.asarray(pos),
                                      jnp.asarray(perm), "packed_pallas"),
                 tpk.packed_project_q(tc, tl0, tx, t(pos), t(perm),
                                      "packed_cuda"))]
    slot = r.integers(0, C, size=(1, L)).astype(np.int32)
    crit = np.array([C], np.int32)
    return [("packed_mlp",
             jpk.packed_mlp(jc, jl0, jx, JCompaction(
                 jnp.asarray(perm[None]), jnp.asarray(slot),
                 jnp.asarray(crit)), "packed_pallas"),
             tpk.packed_mlp(tc, tl0, tx, TCompaction(
                 t(perm[None]), t(slot), t(crit)), "packed_cuda"))]


@pytest.mark.parametrize("entry", ["forward", "prefill_decode",
                                   "paged_tick", "packed_q", "packed_mlp"])
def test_bf16_smoke_model_on_the_cpu(reference, entry):
    """bf16 through every entry point of the smoke model on the CPU, the
    port's kernel backends (the bf16 casts of ``cuda_flash`` and
    ``packed_cuda``, the decode wrappers' bf16) against the reference's
    Pallas routes on the same tokens and bridged weights: the same dtype,
    and values within bf16's rounding -- one eps x max |reference| for
    one layer's packed op (a float32 sum in another order crosses at most
    one bf16 rounding), 4 eps x max for the logits (one more such rounding
    in each of the two layers' attention and FFN residuals)."""
    pair = _bf16_pair()
    if entry.startswith("packed"):
        got, tol = _bf16_packed_entry(entry, *pair), BF16_EPS
    else:
        got, tol = _bf16_model_entry(entry, *pair), 4 * BF16_EPS
    for name, want, have in got:
        assert str(want.dtype) == "bfloat16", name
        assert have.dtype == torch.bfloat16, name
        want = np.asarray(want.astype(jnp.float32))
        have = n(have.float())
        assert have.shape == want.shape and np.isfinite(have).all(), name
        err = float(np.abs(have - want).max())
        assert err <= tol * float(np.abs(want).max()), (name, err)


def test_cpu_tensors_take_the_plain_version():
    K.reset_launch_counts()
    x, w, perm, slot = _gmm_inputs(16, 32, 48, 8, seed=3, M=16)
    out = K.gathered_matmul(t(x), t(w), t(perm), t(slot))
    np.testing.assert_array_equal(
        n(out), n(K.gathered_matmul_plain(t(x), t(w), t(perm), t(slot))))
    rows = K.gather_rows(t(x), t(perm))
    np.testing.assert_array_equal(n(rows), x[perm])
    inp = [t(a) for a in _paged_inputs(2, 2, 1, 8, 6, 4, 2, [5, 3], 0)]
    np.testing.assert_array_equal(n(K.paged_flash_decode(*inp)),
                                  n(K.paged_decode_plain(*inp)))
    assert K.launch_counts() == {"gathered_matmul": 0, "gather_rows": 0,
                                 "paged_flash_decode": 0,
                                 "flash_attention": 0, "flash_decode": 0,
                                 "hlog_qmatmul": 0,
                                 "local_similarity_dist": 0,
                                 "spls_plan_block": 0, "spls_mfi": 0}


# the tiling of the CUDA gathered_matmul (a pure function of the shape)

@pytest.mark.parametrize("C", [8, 16, 24, 32, 40, 48, 56, 64, 100])
@pytest.mark.parametrize("F,D", [(768, 768), (3072, 768), (100, 200),
                                 (37, 77)])
def test_gmm_tiling(C, F, D):
    bm, splits = gmm_tiling(C, F, D)
    assert bm in (16, 32, 64) and (bm >= C or bm == 64)
    assert bm == 16 or bm // 2 < C                # the least that covers C
    slices = -(-D // GMM_BK)
    per = -(-slices // splits)
    assert 1 <= splits <= GMM_MAX_SPLITS
    assert (splits - 1) * per < slices            # every split has a slice
    assert splits == 1 or per >= GMM_MIN_SLICES
    blocks = -(-C // bm) * -(-F // 64) * splits
    # fills the 132 SMs once, unless the splits are capped
    assert blocks >= 132 or splits == min(GMM_MAX_SPLITS,
                                          slices // GMM_MIN_SLICES) \
        or splits == 1


# one shape for each split factor the helper can choose; D 200 and 77 are
# no multiple of the 32-deep K-slice, and 77 / 37 no multiple of 4
GMM_SPLIT_SHAPES = {1: (13, 37, 77), 2: (8, 64, 128), 3: (40, 100, 200),
                    4: (64, 3072, 768), 5: (8, 100, 320), 6: (16, 64, 384),
                    7: (40, 64, 448), 8: (64, 768, 768)}


@pytest.mark.parametrize("splits", sorted(GMM_SPLIT_SHAPES))
def test_gmm_tiling_split_table(splits):
    assert gmm_tiling(*GMM_SPLIT_SHAPES[splits])[1] == splits


def _split_k_emulation(x, w, perm, D, splits):
    """The kernel's order in float64: within a split, 8-deep steps in
    turn; then the splits' partial tiles summed in split order; one
    rounding to float32."""
    xg = x[np.clip(perm, 0, x.shape[0] - 1)].astype(np.float64)
    wd = w.astype(np.float64)
    slices = -(-D // GMM_BK)
    per = -(-slices // splits)
    total = np.zeros((xg.shape[0], w.shape[1]))
    for s in range(splits):
        part = np.zeros_like(total)
        for k in range(s * per * GMM_BK, min(D, (s + 1) * per * GMM_BK), 8):
            part += xg[:, k:k + 8] @ wd[k:k + 8]
        total = total + part
    return total.astype(np.float32)


@pytest.mark.parametrize("splits", sorted(GMM_SPLIT_SHAPES))
def test_gmm_split_k_order_matches_plain_bitwise(splits):
    """One rounding of a float64 sum: the split-K order the kernel uses
    gives the plain version's bits at the kernel's own tiling."""
    C, F, D = GMM_SPLIT_SHAPES[splits]
    x, w, perm, _ = _gmm_inputs(64, D, F, C, seed=splits)
    got = _split_k_emulation(x, w, perm, D, splits)
    want = n(K.gathered_matmul_plain(t(x), t(w), t(perm)))
    np.testing.assert_array_equal(got, want)


def test_other_devices_raise():
    x = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.gathered_matmul(x, x, torch.zeros(2, dtype=torch.int32,
                                            device="meta"))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("C,F", [(16, 768), (64, 3072), (13, 100)])
@pytest.mark.parametrize("fused", [False, True])
def test_gathered_matmul_kernel_vs_plain(cuda_device, C, F, fused):
    x, w, perm, slot = _gmm_inputs(64, 768, F, C, seed=C, M=64)
    args = [t(a).to(cuda_device) for a in (x, w, perm)]
    s = t(slot).to(cuda_device) if fused else None
    before = K.gathered_matmul.launches
    got = K.gathered_matmul(*args, s)
    torch.cuda.synchronize()
    assert K.gathered_matmul.launches == before + 1
    ref = K.gathered_matmul_plain(*args, s)
    # both accumulate in float64 and round once
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def _gmm_kernel_check(device, L, D, F, C, seed, fused=False):
    x, w, perm, slot = _gmm_inputs(L, D, F, C, seed=seed, M=L)
    args = [t(a).to(device) for a in (x, w, perm)]
    s = t(slot).to(device) if fused else None
    before = K.gathered_matmul.launches
    got = K.gathered_matmul(*args, s)
    torch.cuda.synchronize()
    assert K.gathered_matmul.launches == before + 1
    ref = K.gathered_matmul_plain(*args, s)
    tol = 1e-6 * max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 16, 24, 32, 40, 48, 56, 64])
@pytest.mark.parametrize("F", [768, 3072, 100])
def test_gathered_matmul_kernel_buckets(cuda_device, C, F):
    """Every capacity bucket of a 64-row chunk at the path's widths."""
    _gmm_kernel_check(cuda_device, 64, 768, F, C, seed=C + F)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", sorted(GMM_SPLIT_SHAPES))
def test_gathered_matmul_kernel_splits(cuda_device, splits):
    """Each split-K factor, ragged D included, with the fused scatter."""
    C, F, D = GMM_SPLIT_SHAPES[splits]
    _gmm_kernel_check(cuda_device, 64, D, F, C, seed=splits, fused=True)


@pytest.mark.cuda
def test_gather_rows_kernel_vs_plain(cuda_device):
    r = np.random.default_rng(1)
    src = t(r.normal(size=(48, 768)).astype(np.float32)).to(cuda_device)
    idx = t(r.integers(0, 48, size=64).astype(np.int32)).to(cuda_device)
    got = K.gather_rows(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, K.gather_rows_plain(src, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_decode_kernel_vs_plain(cuda_device, case):
    c = PAGED_CASES[case]
    inp = [t(a).to(cuda_device) for a in _paged_inputs(
        3, 2, c["G"], 8, 12, 4, 4, c["lens"], seed=len(case),
        compact=c.get("compact", False))]
    kw = dict(softcap=c.get("softcap"), window=c.get("window"))
    got = K.paged_flash_decode(*inp, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, K.paged_decode_plain(*inp, **kw),
                               **TOL)


def _bf16_close(got, ref):
    """Within one bf16 ulp of the plain output, or 1e-5 where that ulp is
    smaller."""
    m, e = torch.frexp(ref.float())
    ulp = torch.where(m == 0, torch.zeros_like(m),
                      torch.ldexp(torch.ones_like(m), e - 8))
    err = (got.float() - ref.float()).abs()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert bool((err <= torch.clamp(ulp, min=1e-5)).all()), \
        float((err - ulp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_decode_kernel_bf16(cuda_device, case):
    """bf16 pool and q, cast to float32 on load, stored in bf16."""
    c = PAGED_CASES[case]
    inp = [t(a).to(cuda_device) for a in _paged_inputs(
        3, 2, c["G"], 8, 12, 4, 4, c["lens"], seed=len(case),
        compact=c.get("compact", False))]
    inp[:3] = [a.bfloat16() for a in inp[:3]]
    kw = dict(softcap=c.get("softcap"), window=c.get("window"))
    got = K.paged_flash_decode(*inp, **kw)
    torch.cuda.synchronize()
    _bf16_close(got, K.paged_decode_plain(*inp, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("nsplit", range(1, 9))
@pytest.mark.parametrize("G,Dh", [(1, 64), (16, 20), (3, 128)])
def test_paged_decode_kernel_splits(cuda_device, nsplit, G, Dh):
    """Each split count (a table of nsplit pages of 16 slots gives nsplit
    splits), with kv_len 0, a full table and a last page written in part,
    at G 1, G 16 (two passes) and G 3."""
    P = nsplit
    assert paged_split_count(4 * 2, P, 16) == nsplit
    inp = [t(a).to(cuda_device) for a in _paged_inputs(
        4, 2, G, Dh, 4 * P + 1, 16, P, [0, P * 16, max(1, P * 16 - 5), 7],
        seed=nsplit, compact=True)]
    for kw in (dict(), dict(window=9, softcap=5.0)):
        before = K.paged_flash_decode.launches
        got = K.paged_flash_decode(*inp, **kw)
        torch.cuda.synchronize()
        assert K.paged_flash_decode.launches == before + 1
        torch.testing.assert_close(got, K.paged_decode_plain(*inp, **kw),
                                   **TOL)
        assert not got[0].any()


@pytest.mark.cuda
def test_bf16_smoke_model_kernels_vs_plain(cuda_device):
    """The bf16 smoke model through the kernels and through the plain
    backends on the card: every entry point runs, every kernel of it
    launches, logits agree within 5e-2 x max |plain logits|."""
    K.reset_launch_counts()
    got = _bf16_smoke(cuda_device, True)
    torch.cuda.synchronize()
    launched = K.launch_counts()
    want = _bf16_smoke(cuda_device, False)
    assert all(launched[k] > 0 for k in ("flash_attention", "flash_decode",
                                         "paged_flash_decode")), launched
    for name in want:
        assert got[name].dtype == torch.bfloat16
        ref = want[name].float()
        err = float((got[name].float() - ref).abs().max())
        assert err <= 5e-2 * float(ref.abs().max()), (name, err)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    x = torch.zeros(8, 4, device=cuda_device)
    perm = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        K.gathered_matmul(x.double(), x.double().T.contiguous(), perm)
    with pytest.raises(ValueError, match="contiguous"):
        K.gathered_matmul(x, torch.zeros(8, 4, device=cuda_device).T, perm)
    with pytest.raises(TypeError):
        K.gather_rows(x, perm.long())
    with pytest.raises(ValueError, match="cuda"):
        K.gather_rows(x, perm.cpu())
    inp = [t(a).to(cuda_device)
           for a in _paged_inputs(2, 2, 1, 8, 6, 4, 2, [5, 3], 0)]
    with pytest.raises(TypeError):                 # float64 q and pages
        K.paged_flash_decode(*[a.double() for a in inp[:3]], *inp[3:])
    with pytest.raises(TypeError):                 # bf16 q, float32 pages
        K.paged_flash_decode(inp[0].bfloat16(), *inp[1:])
    with pytest.raises(TypeError):
        K.paged_flash_decode(*inp[:5], inp[5].long(), inp[6])
    with pytest.raises(ValueError, match="shape mismatch"):
        K.paged_flash_decode(*inp[:4], inp[4][:1].contiguous(), *inp[5:])
    strided = inp[1].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        K.paged_flash_decode(inp[0], strided, *inp[2:])
    with pytest.raises(ValueError, match="window"):
        K.paged_flash_decode(*inp, window=0)
    wide = torch.zeros(2, 2, 1, 264, device=cuda_device)
    pages = torch.zeros(2, 6, 4, 264, device=cuda_device)
    with pytest.raises(ValueError, match="Dh <= 256"):
        K.paged_flash_decode(wide, pages, pages, *inp[3:])
