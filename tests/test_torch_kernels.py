"""The port's kernels: plain versions against the reference's Pallas
kernels (interpret mode on the CPU), routing by device, and -- on a card
only -- the CUDA kernels against their plain versions.

Tolerances: gathers are exact; the gathered matmul and the paged decode
agree to rtol = atol = 1e-5 (float32 sums in another order); on the card
the gathered matmul agrees with its plain version to 1e-6 x max(1,
max |plain|) (both round a float64 sum once); the float64 emulation of the
kernel's split-K order equals the plain version bit for bit.

The machine with the card has no JAX, so this file also imports without
it: the ``cuda`` tests run there (``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels.py``) and the reference-parity tests skip.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.gathered_matmul import (GMM_BK, GMM_MAX_SPLITS,
                                                 GMM_MIN_SLICES, gmm_tiling)

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
                                 "local_similarity_dist": 0}


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
