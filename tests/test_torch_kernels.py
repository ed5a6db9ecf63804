"""The port's kernels: plain versions against the reference's Pallas
kernels (interpret mode on the CPU), routing by device, and -- on a card
only -- the CUDA kernels against their plain versions.

Tolerances: gathers are exact; the gathered matmul and the paged decode
agree to rtol = atol = 1e-5 (float32 sums in another order).

The machine with the card has no JAX, so this file also imports without
it: the ``cuda`` tests run there (``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernels.py``) and the reference-parity tests skip.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels as K

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
