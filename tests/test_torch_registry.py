"""The port's architecture registry against the reference's: the ids,
every configuration field by field (``SPLSConfig`` included) with its
derived properties, the ``smoke()`` forms, ``LM_SHAPES``, ``get_shape``
and ``all_cells``; the weight bridge on a bfloat16 parameter tree
(every leaf bit-equal, in its own dtype); and ``abstract_params`` at full
width against ``jax.eval_shape(init_params)``.  The reference's public
registry API: ``register_backend`` / ``available_backends``,
``register_compute_backend``, ``layer_norm`` (rtol = atol = 1e-5) and
``NULL_PAGE``.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import sparse_compute as jsc
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.kernels import paged_decode as jpaged
from repro.models import attn_backend as jab
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.common import layer_norm as jax_layer_norm
from repro.models.model import abstract_params as jax_abstract_params
from repro_torch import models as tmodels
from repro_torch import sparse_compute as tsc
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.kernels import paged_decode as tpaged
from repro_torch.models import abstract_params
from repro_torch.models import attn_backend as tab
from repro_torch.tree import leaf_id, leaves_with_path
from repro_torch.weights import params_from_jax

from _torch_parity import arch_pair, cfg_pair, n, params_pair

PROPS = ("n_periods", "resolved_head_dim", "d_inner", "mamba_nheads",
         "has_attn", "has_mamba", "has_moe")


def test_arch_ids_match():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert len(treg.ARCH_IDS) == 10


@pytest.mark.parametrize("arch_id", jreg.ARCH_IDS + ["bert-base-esact"])
def test_config_equals_reference(arch_id):
    for jc, tc in ((jreg.get_config(arch_id), treg.get_config(arch_id)),
                   (jreg.get_config(arch_id).smoke(),
                    treg.get_config(arch_id).smoke())):
        assert [f.name for f in dataclasses.fields(tc)] == \
            [f.name for f in dataclasses.fields(jc)]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert type(tc.spls).__module__ == "repro_torch.core.spls"
        for prop in PROPS:
            assert getattr(tc, prop) == getattr(jc, prop), prop
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        for ntok in (1, 16, 64, 4096):
            assert tc.moe_capacity(ntok) == jc.moe_capacity(ntok)


def test_shapes_and_cells():
    assert [dataclasses.asdict(s) for s in tbase.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.LM_SHAPES]
    for s in jbase.LM_SHAPES:
        got = treg.get_shape(s.name)
        assert dataclasses.asdict(got) == dataclasses.asdict(s)
        assert got.is_decode == s.is_decode
    for inc in (False, True):
        assert list(treg.all_cells(inc)) == list(jreg.all_cells(inc))
    assert len(list(treg.all_cells(True))) == 40
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("gpt-5")
    with pytest.raises(KeyError, match="unknown shape"):
        treg.get_shape("train_1m")


@pytest.mark.parametrize("arch_id", ["gemma2-27b", "jamba-v0.1-52b"])
def test_bf16_tree_bridges_bit_for_bit(arch_id):
    """The smoke form at its published ``param_dtype="bfloat16"``: every
    bf16 leaf crosses as torch.bfloat16 with its bits unchanged, and the
    float32 leaves (MoE routers, Mamba's A / D / dt bias) stay float32."""
    jc, _ = arch_pair(arch_id, param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda k: jax_init_params(jc, k))(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, device="cpu")
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert tdef == jdef
    dtypes = set()
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        if a.dtype.name == "bfloat16":
            assert b.dtype == torch.bfloat16
            assert np.array_equal(b.view(torch.int16).numpy(),
                                  a.view(np.int16))
        else:
            assert b.dtype == torch.from_numpy(np.zeros(0, a.dtype)).dtype
            assert np.array_equal(b.numpy(), a)
        dtypes.add(str(b.dtype))
    assert "torch.bfloat16" in dtypes
    if arch_id.startswith("jamba"):
        assert "torch.float32" in dtypes


# leaves that ``ArchConfig.param_count`` leaves out of its count, in both
# packages: qk-norm and post-norm scales, the conv bias; it counts an
# ``ln2`` for every block, also for a block without an FFN
_UNCOUNTED = ("q_norm", "k_norm", "post_ln1", "post_ln2", "conv_b")


@pytest.mark.parametrize("arch_id", jreg.ARCH_IDS)
def test_abstract_params_equal_reference(arch_id):
    """Full width on the ``meta`` device: the reference's leaf paths,
    shapes and dtypes, no storage; the sizes sum to ``param_count()`` up
    to the leaves it does not count."""
    cfg = treg.get_config(arch_id)
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax_abstract_params(jreg.get_config(arch_id)))[0]:
        lid = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        ref[lid] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    leaves = {leaf_id(p): x for p, x in leaves_with_path(
        abstract_params(cfg))}
    assert {k: (tuple(x.shape), str(x.dtype).split(".")[-1])
            for k, x in leaves.items()} == ref
    assert all(x.device.type == "meta" for x in leaves.values())
    total = sum(x.numel() for x in leaves.values())
    uncounted = sum(x.numel() for k, x in leaves.items()
                    if k.split(".")[-1] in _UNCOUNTED)
    no_ffn = sum(not b.has_ffn for b in cfg.period) * cfg.n_periods
    assert total == cfg.param_count() + uncounted - no_ffn * cfg.d_model


# ---------------------------------------------------------------------------
# the reference's public registry API
# ---------------------------------------------------------------------------

_SITE_DICTS = (tab.FORWARD_BACKENDS, tab.DECODE_BACKENDS,
               tab.PAGED_DECODE_BACKENDS)


@pytest.fixture
def toy_attn_backend():
    """A forward backend registered in the port for one test: dense
    attention that counts its calls; unregistered afterwards."""
    calls = []

    @tmodels.register_backend("toy_dense", doc="counts, then torch_dense")
    def toy(cfg, q, k, v, **kw):
        calls.append(tuple(q.shape))
        return tab.torch_dense(cfg, q, k, v, **kw)

    yield calls
    for reg in _SITE_DICTS:
        reg.pop("toy_dense", None)


def test_registered_backend_resolves_and_runs(toy_attn_backend):
    """A backend registered by name resolves through ``get_backend`` and
    ``resolve_backend`` and runs a ``forward``, whose logits equal the
    reference's ``xla_dense`` forward within 1e-4 (blocks' tolerance)."""
    assert tmodels.get_backend("toy_dense").__doc__ == \
        "counts, then torch_dense"
    assert "toy_dense" in tmodels.available_backends(decode=False)
    assert "toy_dense" not in tmodels.available_backends(decode=True)
    assert tmodels.resolve_backend("toy_dense", "cpu", "forward") == \
        "toy_dense"
    # at a decode site the forward name falls back to auto, with a warning
    with pytest.warns(RuntimeWarning, match="forward backend"):
        assert tmodels.resolve_backend("toy_dense", "cpu", "decode") == \
            "torch_flash_decode"
    jc, tc = cfg_pair("gqa_qknorm", spls=dict(enabled=False))
    jp, tp = params_pair(jc)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 12))
    got = tmodels.forward(dataclasses.replace(tc, attn_backend="toy_dense"),
                          tp, torch.from_numpy(toks))
    want = jax_forward(dataclasses.replace(jc, attn_backend="xla_dense"),
                       jp, toks)
    assert toy_attn_backend == [(2, 2, 2, 12, 16)] * tc.n_layers
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("decode,paged", [(None, None), (False, None),
                                          (True, None), (True, False),
                                          (True, True), (None, True),
                                          (None, False), (False, True)])
def test_available_backends_filter_as_reference(decode, paged):
    """The reference's names, through the port's alias table, are the
    port's names at every filter, but for the port's two plain-version
    names (``torch_flash``, ``torch_flash_decode``), which have no
    reference counterpart."""
    ref = {tab._ALIASES.get(x, x)
           for x in jab.available_backends(decode=decode, paged=paged)}
    got = set(tmodels.available_backends(decode=decode, paged=paged))
    assert ref <= got
    assert got - ref <= {"torch_flash", "torch_flash_decode"}
    assert tuple(sorted(got)) == tmodels.available_backends(decode, paged)


def test_register_compute_backend_as_reference():
    """A compute backend registered in both packages resolves by name, is
    not packed (in both), and its primitives are the ones registered."""
    gm = lambda x, w, perm, src_slot=None: x[perm] @ w
    gr = lambda rows, idx: rows[idx]
    try:
        jsc.register_compute_backend("toy_compute", gm, gr, "toy")
        tsc.register_compute_backend("toy_compute", gm, gr, "toy")
        for pkg, kw in ((jsc, {}), (tsc, dict(device="cpu"))):
            assert "toy_compute" in pkg.available_compute_backends()
            assert pkg.resolve_compute_backend(
                "toy_compute", sparse=True, **kw) == "toy_compute"
            assert pkg.resolve_compute_backend(
                "toy_compute", sparse=False, **kw) == "toy_compute"
            assert not pkg.is_packed("toy_compute")
            b = pkg.get_compute_backend("toy_compute")
            assert (b.gathered_matmul, b.gather_rows, b.doc) == (gm, gr,
                                                                 "toy")
    finally:
        from repro.sparse_compute import backend as jb
        from repro_torch.sparse_compute import backend as tb
        jb._REGISTRY.pop("toy_compute", None)
        tb._REGISTRY.pop("toy_compute", None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_equals_reference(dtype):
    """float32 inside, output in the input's dtype; rtol = atol = 1e-5 in
    float32, one bf16 rounding apart in bf16."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 3 + 0.5
    scale = rng.normal(size=(48,)).astype(np.float32)
    bias = rng.normal(size=(48,)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    want = jax_layer_norm(jnp.asarray(x, jdt), jnp.asarray(scale),
                          jnp.asarray(bias), 1e-5)
    got = tmodels.layer_norm(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(scale),
                             torch.from_numpy(bias), 1e-5)
    assert got.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(
        rtol=0, atol=2 ** -7 * float(np.abs(np.asarray(want,
                                                       np.float32)).max()))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_null_page_reexported():
    from repro_torch.serving import pager
    assert tpaged.NULL_PAGE == jpaged.NULL_PAGE == pager.NULL_PAGE
    assert "NULL_PAGE" in tpaged.__all__
