"""The port's MoE and Mamba2 layers against the reference's, on the same
numpy inputs and bridged weights.

- MoE: ``_dispatch_combine`` exactly (0/1 dispatch, gate-weighted combine),
  also where the per-expert capacity overflows and where router
  probabilities tie (the lower expert index wins, as ``jax.lax.top_k``);
  ``moe_forward`` at rtol = atol = 1e-5, at the capacities of a chunk step
  and of a decode tick; ``moe_aux_loss`` at 1e-6 relative.
- Mamba2: ``ssd_chunked`` at chunk > 1 with and without an initial state,
  ``mamba_forward`` at the chunk-1 fallback and with its decode cache
  (prompts longer and shorter than the conv window), and ``mamba_decode``
  steps, all at rtol = atol = 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.weights import params_from_jax

from _torch_parity import arch_pair, n, t

TOL = dict(rtol=1e-5, atol=1e-5)


def _probs(rng, B, L, E):
    return jax.nn.softmax(jnp.asarray(
        rng.standard_normal((B, L, E)).astype(np.float32)), axis=-1)


@pytest.mark.parametrize("B,L,E,K,C", [
    (2, 16, 4, 2, 16),      # room for every choice
    (2, 16, 4, 2, 8),       # the smoke form's capacity at L 16: overflows
    (1, 64, 64, 8, 16),     # olmoe's 64 experts, top 8, a 64-row chunk
    (4, 1, 16, 2, 8),       # a decode tick: one token a row
])
def test_dispatch_combine_exact(B, L, E, K, C):
    rng = np.random.default_rng(B * 1000 + L + E)
    probs = _probs(rng, B, L, E)
    jd, jc = jmoe._dispatch_combine(probs, K, C)
    td, tc = tmoe._dispatch_combine(t(probs), K, C)
    np.testing.assert_array_equal(n(td), np.asarray(jd))
    np.testing.assert_array_equal(n(tc), np.asarray(jc))
    kept = int(np.asarray(jd).sum())
    if C * E < B * L * K:
        assert kept < B * L * K           # the overflow case drops choices
    assert kept <= B * E * C


def test_top_k_ties_pick_the_lower_expert():
    """Equal probabilities: ``jax.lax.top_k`` picks the lower index; so
    must the port, which a plain ``torch.topk`` does not promise."""
    probs = np.full((1, 3, 6), 1.0 / 6, np.float32)
    probs[0, 1, [1, 4]] = 0.3
    probs[0, 2, [5, 2, 0]] = 0.25
    jd, jc = jmoe._dispatch_combine(jnp.asarray(probs), 2, 8)
    td, tc = tmoe._dispatch_combine(t(probs), 2, 8)
    np.testing.assert_array_equal(n(td), np.asarray(jd))
    np.testing.assert_array_equal(n(tc), np.asarray(jc))
    _, idx = tmoe._top_k(t(probs), 3)
    assert idx[0].tolist() == [[0, 1, 2], [1, 4, 0], [0, 2, 5]]


@pytest.mark.parametrize("arch_id,act", [("olmoe-1b-7b", "silu"),
                                         ("dbrx-132b", "gelu_mlp")])
@pytest.mark.parametrize("B,L", [(2, 16), (1, 40), (4, 1)])
def test_moe_forward_and_aux_loss(arch_id, act, B, L):
    """Gated and plain experts; a whole prompt, a ragged chunk-sized call
    and a decode tick (each at its own ``cfg.moe_capacity(L)``)."""
    jc, tc = arch_pair(arch_id, ffn_activation=act)
    jf, tf = _layer(jmoe.init_moe, jc)
    x = np.random.default_rng(L).standard_normal(
        (B, L, jc.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        n(tmoe.moe_forward(tc, tf, t(x))),
        np.asarray(jmoe.moe_forward(jc, jf, jnp.asarray(x))), **TOL)
    # a capacity below what the routing needs drops the same tokens
    np.testing.assert_allclose(
        n(tmoe.moe_forward(tc, tf, t(x), capacity=2)),
        np.asarray(jmoe.moe_forward(jc, jf, jnp.asarray(x), capacity=2)),
        **TOL)

    probs = jax.nn.softmax(jnp.asarray(x) @ jf["router"], axis=-1)
    jd, _ = jmoe._dispatch_combine(probs, jc.moe_topk,
                                   jc.moe_capacity(L))
    td, _ = tmoe._dispatch_combine(t(probs), tc.moe_topk,
                                   tc.moe_capacity(L))
    ja = float(jmoe.moe_aux_loss(probs, jd))
    ta = float(tmoe.moe_aux_loss(t(probs), td))
    assert ta == pytest.approx(ja, rel=1e-6)


def _layer(init, jc, seed=0):
    """One layer's reference params (float32) and their bridged copy."""
    jp = jax.tree.map(np.asarray,
                      init(jc, jax.random.PRNGKey(seed), jnp.float32))
    return jp, params_from_jax(jp, device="cpu")


def _mamba():
    jc, tc = arch_pair("mamba2-370m")
    jm, tm = _layer(jmamba.init_mamba, jc)
    # non-trivial decay, skip and bias (init gives zeros / ones)
    rng = np.random.default_rng(7)
    h = jc.mamba_nheads
    for name, val in (("A_log", rng.uniform(-1, 1, h)),
                      ("dt_bias", rng.uniform(-2, 0, h)),
                      ("D", rng.uniform(0, 2, h))):
        jm[name] = val.astype(np.float32)
        tm[name] = t(jm[name])
    return jc, tc, jm, tm


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(chunk, with_state):
    rng = np.random.default_rng(chunk)
    b, l, h, p, nst = 2, 32, 3, 4, 5
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, B, C = f(b, l, h, p), f(b, l, nst), f(b, l, nst)
    dt = rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32)
    A = -rng.uniform(0.1, 2.0, h).astype(np.float32)
    s0 = f(b, h, p, nst) if with_state else None
    jy, jfin = jmamba.ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B),
        jnp.asarray(C), chunk, None if s0 is None else jnp.asarray(s0))
    ty, tfin = tmamba.ssd_chunked(t(x), t(dt), t(A), t(B), t(C), chunk,
                                  None if s0 is None else t(s0))
    np.testing.assert_allclose(n(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(n(tfin), np.asarray(jfin), **TOL)
    # the chunked scan is the token recurrence: chunk 1 gives the same
    ty1, tfin1 = tmamba.ssd_chunked(t(x), t(dt), t(A), t(B), t(C), 1,
                                    None if s0 is None else t(s0))
    np.testing.assert_allclose(n(ty1), n(ty), **TOL)
    np.testing.assert_allclose(n(tfin1), n(tfin), **TOL)


def test_segsum_mask_is_minus_inf():
    x = np.random.default_rng(0).standard_normal((2, 5)).astype(np.float32)
    js = np.asarray(jmamba._segsum(jnp.asarray(x)))
    ts = n(tmamba._segsum(t(x)))
    assert np.array_equal(np.isneginf(ts), np.isneginf(js))
    assert np.isneginf(ts[..., 0, 1]).all()
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], **TOL)


@pytest.mark.parametrize("L,chunk", [(20, 8), (16, 8), (3, 256)])
def test_mamba_forward_with_cache_then_decode(L, chunk):
    """L 20 at chunk 8 runs the chunk-1 fallback, L 16 two chunks, L 3 a
    prompt shorter than the conv window; then three decode steps from the
    returned cache."""
    jc, tc, jm, tm = _mamba()
    rng = np.random.default_rng(L)
    u = rng.standard_normal((2, L, jc.d_model)).astype(np.float32)
    jm = jax.tree.map(jnp.asarray, jm)
    jo, jcache = jax.jit(lambda p, a: jmamba.mamba_forward(
        jc, p, a, chunk=chunk, want_cache=True))(jm, jnp.asarray(u))
    to, tcache = tmamba.mamba_forward(tc, tm, t(u), chunk=chunk,
                                      want_cache=True)
    np.testing.assert_allclose(n(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(n(tcache.conv), np.asarray(jcache.conv),
                               **TOL)
    np.testing.assert_allclose(n(tcache.ssd), np.asarray(jcache.ssd), **TOL)
    assert tcache.ssd.dtype == torch.float32
    np.testing.assert_allclose(
        n(tmamba.mamba_forward(tc, tm, t(u), chunk=chunk)), n(to), **TOL)
    step = jax.jit(lambda p, a, c: jmamba.mamba_decode(jc, p, a, c))
    for _ in range(3):
        ut = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
        jo, jcache = step(jm, jnp.asarray(ut), jcache)
        to, tcache = tmamba.mamba_decode(tc, tm, t(ut), tcache)
        np.testing.assert_allclose(n(to), np.asarray(jo), **TOL)
        np.testing.assert_allclose(n(tcache.ssd), np.asarray(jcache.ssd),
                                   **TOL)
        np.testing.assert_allclose(n(tcache.conv), np.asarray(jcache.conv),
                                   **TOL)


def test_mamba_decode_continues_forward():
    """Decoding token by token from a zero cache gives the whole-sequence
    forward's outputs (the recurrence and the chunked scan agree)."""
    _, tc, _, tm = _mamba()
    u = t(np.random.default_rng(3).standard_normal(
        (1, 12, tc.d_model)).astype(np.float32))
    full = tmamba.mamba_forward(tc, tm, u, chunk=4)
    cache = tmamba.init_mamba_cache(tc, 1, torch.float32, "cpu")
    steps = [tmamba.mamba_decode(tc, tm, u[:, i:i + 1], cache)[0]
             for i in range(12)]
    np.testing.assert_allclose(n(torch.cat(steps, 1)), n(full), **TOL)
