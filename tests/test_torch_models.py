"""Model pieces of the port against the reference on bridged weights:
attention projections, the MLP, embedding and the LM head.  Single float32
modules agree to rtol = atol = 1e-5."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ja
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.models.common import rms_norm as jrms
from repro_torch.models import attention as ta
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models.common import rms_norm

from _torch_parity import cfg_pair, n, params_pair, t

TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ["mha", "gqa_qknorm"]


def _layer0(jp, tp, part):
    pj = jax.tree.map(lambda a: a[0], jp["periods"][0][part])
    pt = {k: v[0] for k, v in tp["periods"][0][part].items()}
    return pj, pt


def _x(cfg, L=12, B=2, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, L, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_project_qkv_and_kv(kind):
    jc, tc = cfg_pair(kind)
    jp, tp = params_pair(jc)
    pj, pt = _layer0(jp, tp, "attn")
    x = _x(jc)
    pos = np.stack([np.arange(12), np.arange(5, 17)]).astype(np.int32)
    jq, jk, jv = ja.project_qkv(jc, pj, jnp.asarray(x), jnp.asarray(pos),
                                "structured")
    tq, tk, tv = ta.project_qkv(tc, pt, t(x), t(pos))
    for a, b in ((tq, jq), (tk, jk), (tv, jv)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(n(a), np.asarray(b), **TOL)
    jk2, jv2 = ja.project_kv(jc, pj, jnp.asarray(x), jnp.asarray(pos),
                             "structured")
    tk2, tv2 = ta.project_kv(tc, pt, t(x), t(pos))
    np.testing.assert_allclose(n(tk2), np.asarray(jk2), **TOL)
    np.testing.assert_allclose(n(tv2), np.asarray(jv2), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_output_proj(kind):
    jc, tc = cfg_pair(kind)
    jp, tp = params_pair(jc)
    pj, pt = _layer0(jp, tp, "attn")
    G = jc.n_heads // jc.n_kv_heads
    o = np.random.default_rng(1).normal(
        size=(2, jc.n_kv_heads, G, 7, jc.head_dim)).astype(np.float32)
    np.testing.assert_allclose(
        n(ta.output_proj(tc, pt, t(o))),
        np.asarray(ja.output_proj(jc, pj, jnp.asarray(o), "structured")),
        **TOL)


@pytest.mark.parametrize("act", ["gelu_mlp", "silu", "gelu"])
def test_mlp_forward(act):
    jc, tc = cfg_pair("mha", ffn_activation=act)
    jp, tp = params_pair(jc)
    pj, pt = _layer0(jp, tp, "ffn")
    x = _x(jc, seed=2)
    np.testing.assert_allclose(
        n(tmoe.mlp_forward(tc, pt, t(x))),
        np.asarray(jmoe.mlp_forward(jc, pj, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        n(tmoe.ffn_forward(tc, False, pt, t(x))),
        np.asarray(jmoe.ffn_forward(jc, False, pj, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_embed_head_and_norm(kind):
    jc, tc = cfg_pair(kind, scale_embedding=True, final_softcap=15.0)
    jp, tp = params_pair(jc)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 9))
    je = jm.embed_inputs(jc, jp, jnp.asarray(toks, jnp.int32))
    te = tm.embed_inputs(tc, tp, t(toks.astype(np.int32)))
    np.testing.assert_allclose(n(te), np.asarray(je), **TOL)
    np.testing.assert_allclose(n(tm.head_logits(tc, tp, te)),
                               np.asarray(jm.head_logits(jc, jp, je)),
                               **TOL)
    scale = np.random.default_rng(4).normal(size=(jc.d_model,)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        n(rms_norm(te, t(scale))), np.asarray(jrms(je, jnp.asarray(scale))),
        **TOL)


def test_params_tree_and_layouts():
    """The port's own init keeps the reference tree, layouts and shapes
    (so weights bridge by copy), places the tensors on the device asked
    for, and is reproducible from its seed."""
    jc, tc = cfg_pair("gqa_qknorm", tied_embeddings=False)
    jshapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda k: jm.init_params(jc, k), jax.random.PRNGKey(0)))
    tp = tm.init_params(tc, seed=7, device="cpu")
    tshapes = jax.tree.map(lambda a: tuple(a.shape), tp)
    assert tshapes == jshapes
    assert tp["periods"][0]["attn"]["wq"].shape == (
        jc.n_periods, jc.d_model, jc.n_kv_heads,
        jc.n_heads // jc.n_kv_heads, jc.head_dim)
    again = tm.init_params(tc, seed=7, device="cpu")
    assert torch.equal(tp["embed"], again["embed"])
    assert all(v.device.type == "cpu"
               for v in jax.tree.leaves(tp["periods"]))


def test_init_params_defaults_to_the_card():
    _, tc = cfg_pair("mha")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_params(tc, seed=0)
