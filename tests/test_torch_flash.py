"""The port's flash kernels: ``flash_attention_plain`` and
``flash_decode_plain`` against the reference's Pallas ``flash_attention``
and ``flash_decode`` (interpret mode on the CPU), the wrappers' routing by
device, and -- on a card only -- the CUDA kernels against their plain
versions.

Tolerances: plain versions vs Pallas rtol = atol = 1e-5 (float64 vs float32
sums in another order); on the card ``flash_attention`` vs its plain
version 1e-6 x max(1, max |plain|) (both accumulate in float64 and round
once), ``flash_decode`` vs its plain version 1e-5 (online vs two-pass
float32 softmax); the float64 emulation of the kernel's tiled online
softmax equals the plain version bit for bit.

The machine with the card has no JAX, so this file also imports without
it: the ``cuda`` tests run there (``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_flash.py``) and the reference-parity tests skip.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels as K

try:
    import jax  # noqa: F401
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as jax_flash
    from repro.kernels.flash_decode import flash_decode as jax_decode
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


# ---------------------------------------------------------------------------
# flash_attention (B4)
# ---------------------------------------------------------------------------

# the path case: non-causal, ~30% of the key columns dead, packed query
# rows carrying their original positions; then each feature on its own
ATTN_CASES = {
    "path": dict(causal=False, keep=0.3, packed=True),
    "causal": dict(causal=True),
    "causal_window": dict(causal=True, window=10, packed=True),
    "symmetric_window": dict(causal=False, window=7, keep=0.2),
    "softcap": dict(causal=False, softcap=5.0, q_scale=4.0),
    "gqa_g4": dict(causal=True, G=4, keep=0.3, packed=True),
    "ragged": dict(causal=True, L=40, keep=0.3, packed=True),
    "dead_row": dict(causal=False, keep=0.3, dead_head=True),
}


def _attn_inputs(c: dict, seed: int, B=2, KV=2, Dh=16, L=48):
    """numpy inputs: q (B, H, L, Dh), k/v (B, KV, L, Dh), kv_keep (B, H,
    L) bool or None, q_pos (B, H, L) int32 or None."""
    r = np.random.default_rng(seed)
    G, L = c.get("G", 1), c.get("L", L)
    H = KV * G
    q = (r.normal(size=(B, H, L, Dh)) * c.get("q_scale", 1.0)
         ).astype(np.float32)
    k = r.normal(size=(B, KV, L, Dh)).astype(np.float32)
    v = r.normal(size=(B, KV, L, Dh)).astype(np.float32)
    keep = None
    if "keep" in c:
        keep = r.random((B, H, L)) >= c["keep"]
        keep[:, :, 16:32] = False              # a whole dead 16-column tile
        if c.get("dead_head"):
            keep[0, 1] = False                 # an all-dead keep row
    q_pos = None
    if c.get("packed"):
        q_pos = np.stack([np.stack([r.permutation(L) for _ in range(H)])
                          for _ in range(B)]).astype(np.int32)
    return q, k, v, keep, q_pos


def _attn_kw(c: dict) -> dict:
    return dict(causal=c["causal"], window=c.get("window"),
                softcap=c.get("softcap"))


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_plain_vs_pallas(reference, case):
    c = ATTN_CASES[case]
    q, k, v, keep, q_pos = _attn_inputs(c, seed=len(case))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    kv_keep=None if keep is None else jnp.asarray(keep),
                    q_pos=None if q_pos is None else jnp.asarray(q_pos),
                    block_q=16, block_k=16, interpret=True, **_attn_kw(c))
    got = K.flash_attention_plain(t(q), t(k), t(v),
                                  kv_keep=None if keep is None else t(keep),
                                  q_pos=None if q_pos is None else t(q_pos),
                                  **_attn_kw(c))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(ref), **TOL)
    if c.get("dead_head"):
        assert not n(got)[0, 1].any()          # nothing to attend -> zeros


def test_flash_attention_cpu_takes_the_plain_version():
    c = ATTN_CASES["gqa_g4"]
    q, k, v, keep, q_pos = (t(a) for a in _attn_inputs(c, seed=0))
    before = K.flash_attention.launches
    out = K.flash_attention(q, k, v, kv_keep=keep, q_pos=q_pos,
                            **_attn_kw(c))
    np.testing.assert_array_equal(
        n(out), n(K.flash_attention_plain(q, k, v, kv_keep=keep,
                                          q_pos=q_pos, **_attn_kw(c))))
    assert K.flash_attention.launches == before


def _tiled_emulation(q, k, v, causal, window, softcap, keep, q_pos, bq,
                     kq):
    """The CUDA kernel's order in float64 (numpy): ``bq``-row q tiles,
    64-column K tiles under the Pallas skip predicates, each tile's ``kq``
    column slices with an online softmax of their own (running max, sum,
    correction; a dead entry's weight exactly 0), the slices scaled to the
    row's common max and summed in order at the end, times the reciprocal
    of the sum, one rounding to float32."""
    B, H, Lq, Dh = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    G, scale, cw = H // KV, Dh ** -0.5, 64 // kq
    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        for h in range(H):
            kk = k[b, h // G].astype(np.float64)
            vv = v[b, h // G].astype(np.float64)
            kp = np.ones(Lk, bool) if keep is None else keep[b, h]
            for q0 in range(0, Lq, bq):
                nq = min(bq, Lq - q0)
                pos = (np.arange(q0, q0 + nq) if q_pos is None
                       else q_pos[b, h, q0:q0 + nq]).astype(np.int64)
                qq = q[b, h, q0:q0 + nq].astype(np.float64)
                m = np.full((kq, nq), -1e30)
                l = np.zeros((kq, nq))
                o = np.zeros((kq, nq, Dh))
                for k0 in range(0, Lk, 64):
                    live = not (causal and k0 > pos.max())
                    if window is not None:
                        live &= k0 + 63 > pos.min() - window
                        if not causal:
                            live &= k0 < pos.max() + window
                    if not (live and kp[k0:k0 + 64].any()):
                        continue
                    for sl in range(kq):
                        cols = np.arange(k0 + cw * sl,
                                         min(k0 + cw * sl + cw, Lk))
                        if not kp[cols].any():
                            continue
                        sc = (qq @ kk[cols].T) * scale
                        if softcap is not None:
                            sc = np.tanh(sc / softcap) * softcap
                        ok = np.broadcast_to(kp[cols], sc.shape).copy()
                        dj = cols[None, :] - pos[:, None]
                        if causal:
                            ok &= dj <= 0
                        if window is not None:
                            ok &= -dj < window
                            if not causal:
                                ok &= dj < window
                        sc = np.where(ok, sc, -np.inf)
                        mn = np.maximum(m[sl], sc.max(-1))
                        corr = np.where(mn == m[sl], 1.0,
                                        np.exp(m[sl] - mn))
                        p = np.exp(sc - mn[:, None])
                        m[sl] = mn
                        l[sl] = l[sl] * corr + p.sum(-1)
                        o[sl] = o[sl] * corr[:, None] + p @ vv[cols]
                mm = m.max(0)
                a = np.where(m == mm, 1.0, np.exp(m - mm))
                lt = (l * a).sum(0)
                lt = np.where(lt > 0, lt, 1.0)
                res = (o * a[..., None]).sum(0) * (1.0 / lt)[:, None]
                out[b, h, q0:q0 + nq] = res.astype(np.float32)
    return out


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("Dh,L,bq,kq", [(16, None, 32, 2), (64, 200, 32, 2),
                                        (128, 200, 32, 4)])
def test_flash_tiled_order_matches_plain_bitwise(case, Dh, L, bq, kq):
    """One rounding of float64 sums: the kernel's tiled online softmax, in
    each of its tilings (32 rows x 2 column slices up to Dh 64, x 4 slices
    at Dh 128), gives the plain version's bits."""
    c = dict(ATTN_CASES[case])
    if L is not None and "L" not in c:
        c["L"] = L
    q, k, v, keep, q_pos = _attn_inputs(c, seed=len(case), Dh=Dh)
    got = _tiled_emulation(q, k, v, keep=keep, q_pos=q_pos, bq=bq, kq=kq,
                           **_attn_kw(c))
    want = K.flash_attention_plain(
        t(q), t(k), t(v), kv_keep=None if keep is None else t(keep),
        q_pos=None if q_pos is None else t(q_pos), **_attn_kw(c))
    np.testing.assert_array_equal(got, n(want))


# ---------------------------------------------------------------------------
# flash_decode (B5)
# ---------------------------------------------------------------------------

DECODE_CASES = {
    "path": dict(pos=[40, 47, 33]),
    "window": dict(pos=[40, 47, 33], window=9),
    "softcap": dict(pos=[40, 12, 33], softcap=5.0, q_scale=4.0),
    "gqa_g4": dict(pos=[40, 47, 33], G=4, window=20),
    "pos_0": dict(pos=[0, 47, 5]),
}


def _decode_inputs(c: dict, seed: int, KV=2, Dh=16, S=48):
    r = np.random.default_rng(seed)
    B, G = len(c["pos"]), c.get("G", 1)
    q = (r.normal(size=(B, KV, G, Dh)) * c.get("q_scale", 1.0)
         ).astype(np.float32)
    k = r.normal(size=(B, KV, S, Dh)).astype(np.float32)
    v = r.normal(size=(B, KV, S, Dh)).astype(np.float32)
    return q, k, v, np.asarray(c["pos"], np.int32)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_flash_decode_plain_vs_pallas(reference, case):
    c = DECODE_CASES[case]
    inp = _decode_inputs(c, seed=len(case))
    kw = dict(softcap=c.get("softcap"), window=c.get("window"))
    ref = jax_decode(*(jnp.asarray(a) for a in inp), block_k=16,
                     interpret=True, **kw)
    got = K.flash_decode_plain(*(t(a) for a in inp), **kw)
    assert np.isfinite(n(got)).all()
    np.testing.assert_allclose(n(got), np.asarray(ref), **TOL)


def test_flash_decode_cpu_takes_the_plain_version():
    inp = [t(a) for a in _decode_inputs(DECODE_CASES["gqa_g4"], seed=1)]
    before = K.flash_decode.launches
    np.testing.assert_array_equal(
        n(K.flash_decode(*inp, window=20)),
        n(K.flash_decode_plain(*inp, window=20)))
    assert K.flash_decode.launches == before


def test_flash_wrappers_reject_other_devices():
    x = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.flash_decode(x, x, x, torch.zeros(1, dtype=torch.int32,
                                            device="meta"))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("Dh,L", [(16, None), (64, 200)])
def test_flash_attention_kernel_vs_plain(cuda_device, case, Dh, L):
    c = dict(ATTN_CASES[case])
    if L is not None and "L" not in c:
        c["L"] = L
    args = [None if a is None else t(a).to(cuda_device)
            for a in _attn_inputs(c, seed=len(case), Dh=Dh)]
    q, k, v, keep, q_pos = args
    before = K.flash_attention.launches
    got = K.flash_attention(q, k, v, kv_keep=keep, q_pos=q_pos,
                            **_attn_kw(c))
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 1
    ref = K.flash_attention_plain(q, k, v, kv_keep=keep, q_pos=q_pos,
                                  **_attn_kw(c))
    tol = 1e-6 * max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= tol


def _flash_kernel_check(device, c, seed, Dh, B=2, KV=2):
    args = [None if a is None else t(a).to(device)
            for a in _attn_inputs(c, seed=seed, B=B, KV=KV, Dh=Dh)]
    q, k, v, keep, q_pos = args
    before = K.flash_attention.launches
    got = K.flash_attention(q, k, v, kv_keep=keep, q_pos=q_pos,
                            **_attn_kw(c))
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 1
    ref = K.flash_attention_plain(q, k, v, kv_keep=keep, q_pos=q_pos,
                                  **_attn_kw(c))
    tol = 1e-6 * max(1.0, float(ref.abs().max()))
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path", "causal_window"])
@pytest.mark.parametrize("Dh", [16, 64, 128])
@pytest.mark.parametrize("L", [31, 32, 33, 200, 384])
def test_flash_attention_kernel_tile_edges(cuda_device, case, Dh, L):
    """Lq = Lk at and around the kernel's 32-row q tile and 64-column K
    tile, at each padded head width."""
    _flash_kernel_check(cuda_device, dict(ATTN_CASES[case], L=L), seed=L,
                        Dh=Dh)


@pytest.mark.cuda
def test_flash_attention_kernel_batch8(cuda_device):
    """Path (d)'s shape: 8 prompts, 12 heads, 384 rows, Dh 64."""
    _flash_kernel_check(cuda_device, dict(ATTN_CASES["path"], L=384),
                        seed=8, Dh=64, B=8, KV=12)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path", "causal_window", "softcap"])
@pytest.mark.parametrize("Dh", [16, 128])
@pytest.mark.parametrize("L", [100, 384])
def test_flash_attention_kernel_wide_grid(cuda_device, case, Dh, L):
    """A grid of several blocks per SM (B 8 x 12 heads) at the narrowest and
    the widest head."""
    _flash_kernel_check(cuda_device, dict(ATTN_CASES[case], L=L), seed=L,
                        Dh=Dh, B=8, KV=12)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_flash_decode_kernel_vs_plain(cuda_device, case):
    c = DECODE_CASES[case]
    inp = [t(a).to(cuda_device) for a in _decode_inputs(c, seed=len(case))]
    kw = dict(softcap=c.get("softcap"), window=c.get("window"))
    before = K.flash_decode.launches
    got = K.flash_decode(*inp, **kw)
    torch.cuda.synchronize()
    assert K.flash_decode.launches == before + 1
    torch.testing.assert_close(got, K.flash_decode_plain(*inp, **kw), **TOL)


@pytest.mark.cuda
def test_flash_wrappers_reject_bad_inputs(cuda_device):
    q = torch.zeros(1, 4, 8, 16, device=cuda_device)
    k = torch.zeros(1, 3, 8, 16, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of KV"):
        K.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        K.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        K.flash_attention(q, q, q, q_pos=torch.zeros(1, 4, 8, dtype=torch.long,
                                                     device=cuda_device))
    with pytest.raises(TypeError):
        K.flash_decode(q, q, q, torch.zeros(1, dtype=torch.long,
                                            device=cuda_device))
