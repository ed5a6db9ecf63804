"""The port's ``kernels.ops`` entry point and its two predictor kernels,
``hlog_qmatmul`` (B6) and ``local_similarity_dist`` (B7): plain versions
against the reference's Pallas kernels (interpret mode on the CPU) and its
oracles, the entry points against ``repro.kernels.ops``, routing by device,
and -- on a card only -- the CUDA kernels against their plain versions.

Tolerances: the HLog product is exact (integer levels, float64 or int32
sums rounded once; for K <= 1024 the reference's float32 sums are exact
too; the CUDA kernel's bf16 tensor-core sums are drained into int32 every
256 of K, which the float32 / int64 emulation here repeats); the window
distances agree to ``1e-5 * max(1, max |ref|)`` (float32 sums in another
order); attention to rtol = atol = 1e-5 (the port's plain flash version
sums in float64).

The machine with the card has no JAX, so this file also imports without
it: the ``cuda`` tests run there (``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_ops.py``) and the reference-parity tests skip.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core.quantizers import hlog_project, symmetric_quantize
from repro_torch.kernels import local_similarity as tls
from repro_torch.kernels import ops
from repro_torch.kernels.hlog_qmatmul import HLOG_BM, HLOG_BNS, hlog_tiling

try:
    import jax  # noqa: F401
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.hlog_qmatmul import (_hlog_project_inkernel,
                                            hlog_qmatmul as jax_hlog)
    from repro.kernels.local_similarity import (local_similarity_dist
                                                as jax_lsd)
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


def _codes(shape, seed) -> np.ndarray:
    """Integer-valued float32 in [-127, 127], like int8 prediction codes."""
    x = np.random.default_rng(seed).normal(size=shape) * 35
    return np.clip(np.round(x), -127, 127).astype(np.float32)


def _spa(shape, seed, keep=0.12, zero_rows=16) -> np.ndarray:
    """Random values with about ``keep`` of each row non-zero (a top-k
    SPA), and the first ``zero_rows`` rows all zero (a zero window)."""
    r = np.random.default_rng(seed)
    x = r.normal(size=shape).astype(np.float32)
    x = x * (r.random(size=shape) < keep)
    x[0, 0, :zero_rows] = 0.0
    return x


def _lsd_tol(ref) -> float:
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# plain versions against the reference's Pallas kernels and oracles
# ---------------------------------------------------------------------------

HLOG_SHAPES = [(128, 128, 128), (256, 128, 384), (128, 256, 128),
               (512, 512, 256)]


@pytest.mark.parametrize("M,Kd,N", HLOG_SHAPES)
def test_hlog_qmatmul_plain_vs_pallas(reference, M, Kd, N):
    """Bit for bit: every partial sum is an exact float32 integer (K <=
    1024), so the Pallas kernel, the oracle and the port agree exactly."""
    xq, wq = _codes((M, Kd), M + Kd), _codes((Kd, N), N)
    got = n(K.hlog_qmatmul_plain(t(xq), t(wq)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, np.asarray(jax_hlog(jnp.asarray(xq), jnp.asarray(wq),
                                 interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(jref.hlog_qmatmul_ref(jnp.asarray(xq),
                                              jnp.asarray(wq))))


def test_hlog_projection_on_the_int8_grid(reference):
    """All 255 int8 values through the product with a 1 x 1 identity: the
    reference's in-kernel projection, the port's ``hlog_project``."""
    v = np.arange(-127, 128, dtype=np.float32)[:, None]
    got = n(K.hlog_qmatmul_plain(t(v), torch.ones(1, 1)))
    np.testing.assert_array_equal(
        got, np.asarray(_hlog_project_inkernel(jnp.asarray(v))))
    np.testing.assert_array_equal(got, n(hlog_project(t(v))))


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic, on the CPU: tiles, bit rule, drained sums
# ---------------------------------------------------------------------------

def _worst_codes(kind: str, M: int, Kd: int, N: int):
    """All codes 127 (every product 16384, every sum Kd * 16384), or 127
    with signs alternating by (row + column) and along K in runs of 300, so
    the partial sums climb, fall back and change sign across the drains."""
    x = np.full((M, Kd), 127.0, np.float32)
    w = np.full((Kd, N), 127.0, np.float32)
    if kind == "alternating":
        i, j = np.arange(M)[:, None], np.arange(Kd)[None, :]
        x *= 1 - 2 * ((i + j // 300) % 2)
        w *= 1 - 2 * (np.arange(N)[None, :] % 2)
    return x, w


# Kd 256 sums to 2^22 exactly, 1024 to 2^24, 1025 past it
HLOG_WORST = [("all_127", 128, 256, 192), ("all_127", 128, 1024, 192),
              ("all_127", 130, 1025, 70), ("alternating", 256, 1025, 192),
              ("alternating", 64, 4096, 96), ("all_127", 16, 8200, 8)]


@pytest.mark.parametrize("M,N,bn", [(3072, 768, 192), (384, 768, 64),
                                    (1408, 1536, 128), (200, 300, 64),
                                    (1, 1, 64), (8 * 3072, 768, 192),
                                    (3072, 3072, 192)])
def test_hlog_tiling(M, N, bn):
    """The fewest waves of 128 x BN tiles times the levels a tile reads
    per K; ties to the wider tile."""
    assert hlog_tiling(M, N) == bn

    def cost(b):
        tiles = -(-M // HLOG_BM) * -(-N // b)
        return -(-tiles // 132) * (HLOG_BM + b)

    assert bn in HLOG_BNS
    assert cost(bn) == min(cost(b) for b in HLOG_BNS)
    assert all(cost(b) > cost(bn) for b in HLOG_BNS if b > bn)


def _bf16_bit_rule(v: np.ndarray) -> np.ndarray:
    """The kernel's projection: the top half of the float32 bits (the bf16
    of an integer of magnitude <= 255, exactly), + 0x20, & 0xffc0."""
    hi = (np.asarray(v, np.float32).view(np.uint32) >> 16).astype(np.uint32)
    bits = ((hi + 0x20) & 0xFFC0) << 16
    return bits.astype(np.uint32).view(np.float32)


def test_hlog_bf16_bit_rule_on_the_int8_grid():
    """All 255 codes: the kernel's bit rule gives ``hlog_project``'s level,
    and every level is exact in bf16."""
    v = np.arange(-127, 128, dtype=np.float32)
    want = n(hlog_project(t(v)))
    np.testing.assert_array_equal(_bf16_bit_rule(v), want)
    np.testing.assert_array_equal(
        n(t(want).bfloat16().float()), want)


@pytest.mark.parametrize("kind,M,Kd,N", HLOG_WORST)
def test_hlog_drained_sums_match_plain_bitwise(kind, M, Kd, N):
    """The kernel's order: float32 sums of bf16-exact levels over K chunks
    of 256 (each an exact integer of magnitude <= 2^22), drained into an
    integer sum, converted to float32 once: the plain version's bits."""
    x, w = _worst_codes(kind, M, Kd, N)
    xl, wl = hlog_project(t(x)), hlog_project(t(w))
    assert torch.equal(xl.bfloat16().float(), xl)
    total = torch.zeros(M, N, dtype=torch.int64)
    for k0 in range(0, Kd, 256):
        part = xl[:, k0:k0 + 256] @ wl[k0:k0 + 256]        # float32
        assert float(part.abs().max()) <= 2 ** 22
        assert torch.equal(part, part.round())
        total += part.to(torch.int64)
    got = total.float()
    assert torch.equal(got, K.hlog_qmatmul_plain(t(x), t(w)))
    if kind == "all_127":
        assert float(got.abs().max()) == Kd * 16384


LSD_SHAPES = [(64, 128, 8), (64, 256, 8), (128, 128, 4), (96, 384, 8)]


@pytest.mark.parametrize("L,Lk,w", LSD_SHAPES)
def test_local_similarity_plain_vs_pallas(reference, L, Lk, w):
    spa = _spa((2, 2, L, Lk), L + Lk)
    got = n(K.local_similarity_plain(t(spa), w))
    ref = np.asarray(jax_lsd(jnp.asarray(spa), w=w, bk=128, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_lsd_tol(ref))
    oracle = np.asarray(jref.local_similarity_ref(jnp.asarray(spa), w))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=_lsd_tol(oracle))
    assert not got[0, 0, 0].any()          # the all-zero window


def test_local_similarity_plain_slabs(reference, monkeypatch):
    """A slab budget smaller than one window's intermediate still covers
    every window once."""
    spa = _spa((2, 3, 40, 50), 7)
    whole = n(K.local_similarity_plain(t(spa), 8))
    monkeypatch.setattr(tls, "_SLAB_BYTES", 3 * 8 * 8 * 50 * 4)
    np.testing.assert_allclose(n(K.local_similarity_plain(t(spa), 8)), whole,
                               rtol=1e-6, atol=1e-6)
    ref = np.asarray(jref.local_similarity_ref(jnp.asarray(spa), 8))
    np.testing.assert_allclose(whole, ref, rtol=0, atol=_lsd_tol(ref))


# ---------------------------------------------------------------------------
# the ops entry points against repro.kernels.ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,Kd,N", [(128, 128, 256), (100, 96, 50)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_predict_matmul(reference, M, Kd, N, use_pallas):
    """Tileable (the reference runs its Pallas kernel) and ragged (its
    oracle); exact either way."""
    xq, wq = _codes((M, Kd), 3), _codes((Kd, N), 4)
    ref = jops.predict_matmul(jnp.asarray(xq), jnp.asarray(wq),
                              use_pallas=use_pallas)
    got = ops.predict_matmul(t(xq), t(wq), use_pallas=use_pallas)
    np.testing.assert_array_equal(n(got), np.asarray(ref))


def test_predict_matmul_is_the_predictor_product():
    """Codes x scales reproduce the quantize-dequantize product that
    ``predict_qk_pre`` forms (per-tensor scales)."""
    r = np.random.default_rng(5)
    x = t(r.normal(size=(48, 64)).astype(np.float32))
    w = t((r.normal(size=(64, 32)) * 0.1).astype(np.float32))
    qx, sx = symmetric_quantize(x)
    qw, sw = symmetric_quantize(w)
    got = ops.predict_matmul(qx, qw) * sx * sw
    want = (hlog_project(qx) * sx) @ (hlog_project(qw) * sw)
    np.testing.assert_allclose(n(got), n(want), **TOL)


ATTN_CASES = {
    "tileable_causal": dict(L=128, causal=True),
    "tileable_window_keep": dict(L=128, causal=False, window=24, keep=True),
    "ragged_softcap": dict(L=40, causal=True, softcap=5.0),
    "ragged_keep": dict(L=40, causal=False, keep=True),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("use_pallas", [True, False])
def test_attention(reference, case, use_pallas):
    c = ATTN_CASES[case]
    r = np.random.default_rng(len(case))
    B, H, L, Dh = 1, 2, c["L"], 16
    q, k, v = (r.normal(size=(B, H, L, Dh)).astype(np.float32)
               for _ in range(3))
    keep = (r.random(size=(B, H, L)) < 0.7) if c.get("keep") else None
    kw = dict(causal=c["causal"], window=c.get("window"),
              softcap=c.get("softcap"))
    ref = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         kv_keep=None if keep is None else jnp.asarray(keep),
                         use_pallas=use_pallas, **kw)
    got = ops.attention(t(q), t(k), t(v),
                        kv_keep=None if keep is None else t(keep),
                        use_pallas=use_pallas, **kw)
    np.testing.assert_allclose(n(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("L,Lk,w", [(64, 128, 8), (48, 100, 4)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_window_distances(reference, L, Lk, w, use_pallas):
    spa = _spa((1, 2, L, Lk), Lk)
    ref = np.asarray(jops.window_distances(jnp.asarray(spa), w=w,
                                           use_pallas=use_pallas))
    got = n(ops.window_distances(t(spa), w=w, use_pallas=use_pallas))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_lsd_tol(ref))


def test_cpu_tensors_take_the_plain_version():
    K.reset_launch_counts()
    xq, wq = _codes((20, 12), 1), _codes((12, 9), 2)
    np.testing.assert_array_equal(
        n(ops.predict_matmul(t(xq), t(wq))),
        n(K.hlog_qmatmul_plain(t(xq), t(wq))))
    spa = _spa((1, 1, 16, 10), 3)
    np.testing.assert_array_equal(n(ops.window_distances(t(spa), 4)),
                                  n(K.local_similarity_plain(t(spa), 4)))
    assert K.launch_counts()["hlog_qmatmul"] == 0
    assert K.launch_counts()["local_similarity_dist"] == 0


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="multiple of the window"):
        ops.window_distances(torch.zeros(1, 1, 10, 8), 4)
    with pytest.raises(ValueError, match="multiple of the window"):
        ops.window_distances(torch.zeros(1, 1, 10, 8), 4, use_pallas=False)
    x = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.hlog_qmatmul(x, x)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.local_similarity_dist(torch.zeros(1, 1, 8, 4, device="meta"), 8)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("M,Kd,N", [
    (3072, 768, 768), (200, 768, 300), (256, 4096, 256), (1, 1, 1),
    (67, 33, 65),
    # long K (many drains of the bf16 kernel's sums), ragged M, N and K
    # under one tile, and a shape for each tile width hlog_tiling picks
    (64, 4096, 64), (130, 8200, 70), (127, 31, 191), (37, 19, 45),
    (5, 3, 2), (128, 32, 64), (1408, 64, 1536), (384, 64, 768)])
def test_hlog_qmatmul_kernel_vs_plain(cuda_device, M, Kd, N):
    xq = t(_codes((M, Kd), M)).to(cuda_device)
    wq = t(_codes((Kd, N), N)).to(cuda_device)
    before = K.hlog_qmatmul.launches
    got = K.hlog_qmatmul(xq, wq)
    torch.cuda.synchronize()
    assert K.hlog_qmatmul.launches == before + 1
    # int32 sums and float64 sums round the same exact integer once
    assert torch.equal(got, K.hlog_qmatmul_plain(xq, wq))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,M,Kd,N", HLOG_WORST)
def test_hlog_qmatmul_kernel_worst_sums(cuda_device, kind, M, Kd, N):
    """Sums at, near and past 2^24 and alternating signs: bit-equal to the
    plain version, one launch."""
    x, w = _worst_codes(kind, M, Kd, N)
    xq, wq = t(x).to(cuda_device), t(w).to(cuda_device)
    before = K.hlog_qmatmul.launches
    got = K.hlog_qmatmul(xq, wq)
    torch.cuda.synchronize()
    assert K.hlog_qmatmul.launches == before + 1
    assert torch.equal(got, K.hlog_qmatmul_plain(xq, wq))


@pytest.mark.cuda
def test_hlog_qmatmul_kernel_int8_grid(cuda_device):
    v = torch.arange(-127, 128, dtype=torch.float32,
                     device=cuda_device)[:, None]
    got = K.hlog_qmatmul(v, torch.ones(1, 1, device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got, hlog_project(v))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,w", [((8, 12, 384, 384), 8),
                                     ((2, 4, 64, 300), 8),
                                     ((2, 4, 64, 384), 4),
                                     ((1, 2, 48, 77), 16),
                                     ((1, 1, 9, 33), 3), ((1, 1, 6, 5), 1)])
def test_local_similarity_kernel_vs_plain(cuda_device, shape, w):
    spa = t(_spa(shape, shape[-1], zero_rows=w)).to(cuda_device)
    got = K.local_similarity_dist(spa, w)
    torch.cuda.synchronize()
    ref = K.local_similarity_plain(spa, w)
    assert (got - ref).abs().max() <= 1e-5 * max(1.0, float(ref.abs().max()))
    assert torch.equal(got, got.transpose(-1, -2))       # exactly symmetric
    assert not got[0, 0, 0].any()                         # all-zero window


@pytest.mark.cuda
def test_ops_launch_the_kernels_on_the_card(cuda_device):
    xq = t(_codes((64, 32), 1)).to(cuda_device)
    spa = t(_spa((1, 2, 16, 40), 2)).to(cuda_device)
    K.reset_launch_counts()
    ops.predict_matmul(xq, xq.T.contiguous())
    ops.window_distances(spa, 8)
    ops.predict_matmul(xq, xq.T.contiguous(), use_pallas=False)
    ops.window_distances(spa, 8, use_pallas=False)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["hlog_qmatmul"] == 1
    assert counts["local_similarity_dist"] == 1


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    x = torch.zeros(8, 4, device=cuda_device)
    with pytest.raises(TypeError):
        K.hlog_qmatmul(x.double(), x.double().T.contiguous())
    with pytest.raises(ValueError, match="shape mismatch"):
        K.hlog_qmatmul(x, x)
    with pytest.raises(ValueError, match="contiguous"):
        K.hlog_qmatmul(x, torch.zeros(8, 4, device=cuda_device).T)
    spa = torch.zeros(1, 1, 34, 8, device=cuda_device)
    with pytest.raises(ValueError, match="w <= 16"):
        K.local_similarity_dist(spa, 17)
