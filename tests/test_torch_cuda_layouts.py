"""The kernels at this slice's new shapes and types: ``gather_rows`` (B2)
copying rows by element size (bf16, float32, odd widths and offsets) and
``flash_attention`` (B4) through ``cuda_flash`` in the flat head layout
(G 1 over 16 and 32 heads, with and without an SPLS plan).

The ``cuda`` tests need the card (the kernels have no CPU mode) and skip
elsewhere; this file imports neither JAX nor the reference, so it runs on
the card's machine.  On the CPU it holds what the card's tests compare
against: the plain versions and the backend route.  Tolerances: copies
exact; B4 against its plain version 1e-6 x max(1, max |plain|) (PERF.md's
table: float64-accumulated, rounded once).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs.base import ArchConfig, BlockCfg
from repro_torch.core.planner import PlanContext
from repro_torch.core.spls import SPLSConfig
from repro_torch.models import attn_backend as ab
from repro_torch.sparse_compute import get_compute_backend

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int32]
# row widths: 16-byte multiples in every dtype, then ragged rows
WIDTHS = [768, 6, 3]


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rows(C, F, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(C, F, generator=g).to(dtype)
    return torch.randint(-1000, 1000, (C, F), generator=g, dtype=dtype)


def _idx(C, M, seed):
    g = torch.Generator().manual_seed(seed)
    # out of range both ways: the kernel and the plain version clamp
    return torch.randint(-2, C + 2, (M,), generator=g, dtype=torch.int32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_rows_plain_any_dtype(dtype):
    src, idx = _rows(48, 768, dtype, 0), _idx(48, 64, 1)
    got = K.gather_rows(src, idx)     # a CPU tensor: the plain version
    assert got.dtype == dtype
    assert torch.equal(got, src[idx.long().clamp(0, 47)])


def test_packed_cuda_backend_gathers_without_casts():
    """The packed kernels' backend hands rows of any dtype to the kernel's
    wrapper itself, no float32 round trip around it."""
    assert get_compute_backend("packed_cuda").gather_rows is K.gather_rows
    src, idx = _rows(8, 16, torch.bfloat16, 2), _idx(8, 5, 3)
    got = get_compute_backend("packed_pallas").gather_rows(src, idx)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, K.gather_rows_plain(src, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_rows_kernel_by_element_size(cuda_device, dtype, F):
    src = _rows(48, F, dtype, F).to(cuda_device)
    idx = _idx(48, 64, F + 1).to(cuda_device)
    before = K.gather_rows.launches
    got = K.gather_rows(src, idx)
    torch.cuda.synchronize()
    assert K.gather_rows.launches == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, K.gather_rows_plain(src, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_gather_rows_kernel_unaligned_rows(cuda_device, offset):
    """Rows that start off a 16-byte boundary (a view at an element
    offset) copy in a narrower unit, still exactly."""
    base = _rows(48 * 768 + 8, 1, torch.bfloat16, offset).to(cuda_device)
    src = base.view(-1)[offset:offset + 48 * 768].view(48, 768)
    idx = _idx(48, 64, offset).to(cuda_device)
    got = K.gather_rows(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, K.gather_rows_plain(src, idx))


def _flat_cfg(H: int) -> ArchConfig:
    return ArchConfig(name=f"flat-{H}", n_layers=1, d_model=64, n_heads=H,
                      n_kv_heads=8, head_dim=128, d_ff=128, vocab_size=64,
                      causal=True, period=(BlockCfg(),),
                      spls=SPLSConfig(enabled=True, k_ratio=0.12,
                                      s_threshold=0.6, f_threshold=6,
                                      window=8, causal=True))


def _flat_inputs(cfg, B: int, L: int, device, seed: int):
    """q (B, H, 1, L, Dh), k / v (B, H, L, Dh) -- the flat layout -- and a
    flat SPLS plan from random predicted heads."""
    g = torch.Generator().manual_seed(seed)
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    q = torch.randn(B, H, 1, L, Dh, generator=g)
    k = torch.randn(B, H, L, Dh, generator=g)
    v = torch.randn(B, H, L, Dh, generator=g)
    ctx = PlanContext.for_config(cfg, "flat")
    xn = torch.randn(B, L, cfg.d_model, generator=g)
    p = {"wq": torch.randn(cfg.d_model, cfg.n_kv_heads,
                           H // cfg.n_kv_heads, Dh, generator=g),
         "wk": torch.randn(cfg.d_model, cfg.n_kv_heads, Dh, generator=g)}
    plan = ctx.plan_progressive(p, xn)
    assert plan.attn_mask.shape == (B, H, 1, L, L)
    move = lambda x: x.to(device)
    return (move(q), move(k), move(v),
            type(plan)(*(move(f) for f in plan)))


@pytest.mark.parametrize("H", [16, 32])
def test_flat_plain_flash_equals_dense_without_plan(H):
    """The flash route's plain version in the flat layout is dense
    attention (what the card's kernel is held to)."""
    cfg = _flat_cfg(H)
    q, k, v, _ = _flat_inputs(cfg, 1, 96, "cpu", H)
    got = ab.torch_flash(cfg, q, k, v)
    want = ab.torch_dense(cfg, q, k, v)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("H", [16, 32])
def test_flash_kernel_flat_layout(cuda_device, H, with_plan):
    """B4 at G 1 over H heads, as the flat layout gives it (qwen3-0.6b's
    16 heads on a 16-wide model axis; musicgen's 24 padded to 32)."""
    cfg = _flat_cfg(H)
    q, k, v, plan = _flat_inputs(cfg, 2, 384, cuda_device, H)
    plan = plan if with_plan else None
    before = K.flash_attention.launches
    got = ab.cuda_flash(cfg, q, k, v, plan=plan, q_capacity=384)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 1
    want = ab.torch_flash(cfg, q, k, v, plan=plan, q_capacity=384)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * max(1.0, float(want.abs().max())), err
