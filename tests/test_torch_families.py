"""Every architecture of the registry at its smoke form (float32), on
bridged weights, against the reference: ``forward``, ``prefill`` and four
``decode_step``s -- dense GQA with qk-norm, windows, soft-caps and
post-norms, MoE, Mamba2, the hybrid, and the embeddings input -- plus GQA
variants of the attention-only families (``smoke()`` always yields one
query head per KV head).

Tolerance: logits and caches rtol = atol = 1e-4 (XLA and torch order sums
differently; the Mamba state compounds it over the steps); the bf16
embedding frontend bit for bit.  Also: ``init_params`` fills the period
stack in draw order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.models import model as jm
from repro_torch.models import model as tm

from _torch_parity import arch_pair, n, params_pair, t

TOL = dict(rtol=1e-4, atol=1e-4)
B, L, MAX_LEN, STEPS = 2, 16, 24, 4


def _inputs(cfg, rng, length):
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, length)).astype(np.int32)
    return rng.standard_normal((B, length, cfg.d_model)).astype(np.float32)


def _check(jc, tc):
    jp, tp = params_pair(jc, jit=True)
    rng = np.random.default_rng(0)
    x = _inputs(jc, rng, L)
    jl = jax.jit(lambda p, a: jm.forward(jc, p, a))(jp, jnp.asarray(x))
    np.testing.assert_allclose(n(tm.forward(tc, tp, t(x))), np.asarray(jl),
                               **TOL)

    jl, jcache = jax.jit(lambda p, a: jm.prefill(jc, p, a, max_len=MAX_LEN)
                         )(jp, jnp.asarray(x))
    tl, tcache = tm.prefill(tc, tp, t(x), max_len=MAX_LEN)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    step = jax.jit(lambda p, c, a, pos: jm.decode_step(jc, p, c, a, pos))
    for s in range(STEPS):
        tok = _inputs(jc, rng, 1)
        pos = np.full((B,), L + s, np.int32)
        jl, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = tm.decode_step(tc, tp, tcache, t(tok), t(pos))
        np.testing.assert_allclose(n(tl), np.asarray(jl), **TOL)
    for jc_blk, tc_blk in zip(jcache, tcache):
        assert type(tc_blk).__name__ == type(jc_blk).__name__
        for a, b in zip(jc_blk, tc_blk):
            assert b.shape == a.shape and str(b.dtype).endswith(
                str(a.dtype))
            np.testing.assert_allclose(n(b), np.asarray(a), **TOL)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_family_matches_reference(arch_id):
    jc, tc = arch_pair(arch_id)
    _check(jc, tc)


@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "gemma2-27b",
                                     "llama3-405b"])
@pytest.mark.parametrize("kv", [2, 1])
def test_gqa_variant_matches_reference(arch_id, kv):
    """G = 2 and G = 4 query heads per KV head (4 heads)."""
    jc, tc = arch_pair(arch_id, n_kv_heads=kv)
    assert tc.n_heads // tc.n_kv_heads == 4 // kv
    _check(jc, tc)


def test_bf16_embedding_scale_matches_reference():
    """gemma2 scales embeddings by sqrt(d_model) rounded to the compute
    dtype first (sqrt(72) = 8.485 -> 8.5 in bf16; 67.88 -> 68 at 4608)."""
    jc, tc = arch_pair("gemma2-27b", compute_dtype="bfloat16", d_model=72)
    jp, tp = params_pair(jc, jit=True)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 8))
    got = tm.embed_inputs(tc, tp, t(toks.astype(np.int32)))
    ref = jm.embed_inputs(jc, jp, jnp.asarray(toks, jnp.int32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(got.view(torch.int16)),
                                  np.asarray(ref).view(np.int16))
    unrounded = tp["embed"][t(toks)].to(torch.bfloat16) * 72 ** 0.5
    assert not torch.equal(unrounded, got)      # the rounding shows


@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "jamba-v0.1-52b"])
def test_init_params_stacks_periods_in_draw_order(arch_id):
    """The period stack is filled as each period is drawn, block by block
    (the same weights as stacking every period's draws at the end)."""
    from repro_torch.models import init_block

    _, tc = arch_pair(arch_id)
    got = tm.init_params(tc, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    embed = torch.empty(tc.vocab_size, tc.d_model)
    torch.nn.init.trunc_normal_(embed, 0.0, 1.0, -2.0, 2.0, generator=gen)
    np.testing.assert_array_equal(n(got["embed"]),
                                  n(embed * tc.d_model ** -0.5))
    for blk, stacked in zip(tc.period, got["periods"]):
        draws = [init_block(tc, blk, gen, torch.float32, "cpu")
                 for _ in range(tc.n_periods)]
        flat = jax.tree.leaves(stacked)
        for i, d in enumerate(draws):
            for a, b in zip(flat, jax.tree.leaves(d)):
                np.testing.assert_array_equal(n(a[i]), n(b))
