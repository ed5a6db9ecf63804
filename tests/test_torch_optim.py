"""The port's optimizer, schedules and gradient compression against the
reference (``repro.optim``) on the same numpy inputs, and the port of the
reference's ``TestAdamW`` and ``TestGradCompression``.

Tolerances: one ``adamw_update`` -- params, moments and the grad norm
rtol 1e-6, atol 1e-7 (float32 elementwise math; the reference's XLA may
fuse it, the port does not; a bf16 moment may round the other way at a
half-ulp tie: 1 bf16 ulp, and the params that follow rtol 1e-5, atol
1e-6); schedules rtol 1e-6 (the reference computes in
float32, the port in float64); ``compress``: the int8 codes equal except
where ``|x / scale|`` sits within 1e-5 of a half-integer (a rounding
tie that the two packages' float32 division may break differently), the
scales rtol 1e-6, the residuals atol 1e-6 x max |g|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _propcheck import given, settings
from _propcheck import strategies as st

from repro import optim as jo
from repro.optim import schedules as jsched
from repro_torch import optim as to
from repro_torch.weights import opt_state_from_jax, params_from_jax

from _torch_parity import n, t

jax.config.update("jax_platform_name", "cpu")


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"w": (r.standard_normal((4, 33)) * scale).astype(np.float32),
            "periods": ({"a": (r.standard_normal((3, 8)) * scale
                               ).astype(np.float32)},),
            "b": (r.standard_normal((7,)) * scale).astype(np.float32)}


def _cmp(got, ref, rtol=1e-6, atol=1e-7):
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, ref)),
                    _torch_leaves(got)):
        np.testing.assert_allclose(n(b.float()),
                                   a.astype(np.float32), rtol=rtol,
                                   atol=atol)


def _torch_leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


@pytest.mark.parametrize("moment_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 1.0, 100.0])
def test_adamw_update_matches_reference(moment_dtype, clip):
    cfg_j = jo.AdamWConfig(clip_norm=clip, moment_dtype=moment_dtype)
    cfg_t = to.AdamWConfig(clip_norm=clip, moment_dtype=moment_dtype)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    jst = jo.adamw_init(cfg_j, jp)
    tp = params_from_jax(_tree(0), device="cpu")
    tst = opt_state_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    for step in range(3):
        g = _tree(10 + step, scale=3.0)
        jp, jst, jm = jo.adamw_update(cfg_j, jax.tree.map(jnp.asarray, g),
                                      jst, jp, jnp.asarray(1e-2))
        tp, tst, tm = to.adamw_update(cfg_t, params_from_jax(g, "cpu"),
                                      tst, tp, 1e-2)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == pytest.approx(1e-2)
    assert int(tst.count) == int(jst.count) == 3
    mom = dict(rtol=2 ** -7, atol=1e-7) if moment_dtype == "bfloat16" \
        else {}
    _cmp(tp, jp, **({"rtol": 1e-5, "atol": 1e-6} if mom else {}))
    _cmp(tst.mu, jst.mu, **mom)
    _cmp(tst.nu, jst.nu, **mom)
    want = {None: torch.float32, "float32": torch.float32,
            "bfloat16": torch.bfloat16}[moment_dtype]
    assert all(m.dtype == want for m in _torch_leaves(tst.mu))


def test_adamw_updates_leaves_in_place():
    """The stacked leaves themselves change (no copies)."""
    p = {"periods": ({"w": torch.ones(2, 3)},)}
    leaf = p["periods"][0]["w"]
    st_ = to.adamw_init(to.AdamWConfig(), p)
    to.adamw_update(to.AdamWConfig(), {"periods": ({"w": torch.ones(2, 3)},)},
                    st_, p, 0.1)
    assert p["periods"][0]["w"] is leaf and float(leaf[0, 0]) < 1.0


def test_clip_and_global_norm():
    g = _tree(3, scale=5.0)
    jg, jn = jo.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg, tn = to.clip_by_global_norm(params_from_jax(g, "cpu"), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _cmp(tg, jg)
    np.testing.assert_allclose(float(to.global_norm(tg)), 1.0, rtol=1e-5)


def test_schedules_match_reference():
    for args in ((3e-4, 20, 100), (1.0, 0, 10), (2e-3, 5, 5)):
        js, ts = jsched.warmup_cosine(*args), to.warmup_cosine(*args)
        for s in range(args[2] + 6):
            assert ts(s) == pytest.approx(float(js(s)), rel=1e-6, abs=1e-12)
            assert ts(torch.tensor(s, dtype=torch.int32)) == ts(s)
    assert to.constant(0.5)(7) == float(jsched.constant(0.5)(7))


@pytest.mark.parametrize("size,scale", [(1000, 1.0), (300, 100.0),
                                        (256, 1e-3), (5, 1.0)])
def test_compress_matches_reference(size, scale):
    r = np.random.default_rng(size)
    g = (r.standard_normal(size) * scale).astype(np.float32)
    res = (r.standard_normal(size) * scale * 1e-2).astype(np.float32)
    jq, js, jr = jo.compress(jnp.asarray(g), jnp.asarray(res))
    tq, ts, tr = to.compress(t(g), t(res))
    assert tq.dtype == torch.int8 and tq.shape == jq.shape
    np.testing.assert_allclose(n(ts), np.asarray(js), rtol=1e-6)
    blocks = np.pad(g + res, (0, (-size) % 256)).reshape(-1, 256)
    frac = np.abs(blocks / np.asarray(js)) % 1.0
    tie = np.abs(frac - 0.5) < 1e-5
    assert np.array_equal(n(tq)[~tie], np.asarray(jq)[~tie])
    np.testing.assert_allclose(n(tr), np.asarray(jr),
                               atol=1e-6 * np.abs(g).max())
    np.testing.assert_array_equal(
        n(to.decompress(tq, ts, g.shape)),
        np.asarray(jo.decompress(jnp.asarray(n(tq)), jnp.asarray(n(ts)),
                                 g.shape)))


def test_round_half_to_even():
    """``torch.round`` rounds halves to even, as ``jnp.round``."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5])
    assert torch.round(x).tolist() == np.asarray(
        jnp.round(jnp.asarray(n(x)))).tolist() == [0., 2., 2., -0., -2.]


def test_compress_init_shapes():
    st_ = to.compress_init({"a": torch.ones(3, 4), "b": (torch.ones(2),)})
    assert st_.residual["a"].shape == (3, 4)
    assert st_.residual["b"][0].dtype == torch.float32


# ---------------------------------------------------------------------------
# the reference's TestAdamW and TestGradCompression, on the port
# ---------------------------------------------------------------------------

class TestAdamW:
    def test_converges_on_quadratic(self):
        p = {"w": torch.tensor([5.0, -3.0])}
        cfg = to.AdamWConfig(weight_decay=0.0, clip_norm=None)
        st_ = to.adamw_init(cfg, p)
        for _ in range(300):
            g = {"w": 2 * p["w"]}
            p, st_, _ = to.adamw_update(cfg, g, st_, p, 0.05)
        assert float(p["w"].abs().max()) < 0.05

    def test_weight_decay_shrinks(self):
        p = {"w": torch.ones(4)}
        cfg = to.AdamWConfig(weight_decay=0.5, clip_norm=None)
        st_ = to.adamw_init(cfg, p)
        p2, _, _ = to.adamw_update(cfg, {"w": torch.zeros(4)}, st_, p, 0.1)
        assert float(p2["w"][0]) < 1.0

    def test_clip_bounds_update(self):
        p = {"w": torch.zeros(3)}
        cfg = to.AdamWConfig(clip_norm=1.0, weight_decay=0.0)
        st_ = to.adamw_init(cfg, p)
        _, _, m = to.adamw_update(cfg, {"w": torch.full((3,), 1e6)}, st_, p,
                                  0.1)
        assert float(m["grad_norm"]) > 1e5  # reported pre-clip

    @given(st.floats(1e-5, 1e-1), st.integers(0, 5))
    @settings(max_examples=10, deadline=None)
    def test_update_finite(self, lr, seed):
        g_ = torch.Generator().manual_seed(seed)
        p = {"w": torch.randn(8, generator=g_)}
        cfg = to.AdamWConfig()
        st_ = to.adamw_init(cfg, p)
        p2, _, _ = to.adamw_update(cfg, {"w": torch.randn(8, generator=g_)},
                                   st_, p, lr)
        assert torch.isfinite(p2["w"]).all()


class TestGradCompression:
    def test_roundtrip_error_bounded(self):
        g = torch.randn(1000, generator=torch.Generator().manual_seed(0))
        q, scale, _ = to.compress(g)
        err = (to.decompress(q, scale, g.shape) - g).abs()
        assert float(err.max()) <= float(scale.max()) * 0.51 + 1e-7

    def test_error_feedback_accumulates(self):
        g = torch.randn(512, generator=torch.Generator().manual_seed(1)) \
            * 1e-3
        res = torch.zeros_like(g)
        acc = torch.zeros_like(g)
        for _ in range(64):
            q, scale, res = to.compress(g, res)
            acc = acc + to.decompress(q, scale, g.shape)
        np.testing.assert_allclose(n(acc / 64), n(g), atol=2e-5)

    def test_compression_ratio(self):
        g = torch.randn(4096, generator=torch.Generator().manual_seed(2))
        q, scale, _ = to.compress(g)
        assert q.numel() + scale.numel() * 4 < g.numel() * 4 / 3.5

    def test_int8_codes_in_range(self):
        g = torch.randn(300, generator=torch.Generator().manual_seed(3)) \
            * 100
        q, _, _ = to.compress(g)
        assert q.dtype == torch.int8
        assert int(q.to(torch.int32).abs().max()) <= 127
