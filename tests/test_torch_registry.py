"""The port's architecture registry against the reference's: the ids,
every configuration field by field (``SPLSConfig`` included) with its
derived properties, the ``smoke()`` forms, ``LM_SHAPES``, ``get_shape``
and ``all_cells``; the weight bridge on a bfloat16 parameter tree
(every leaf bit-equal, in its own dtype); and ``abstract_params`` at full
width against ``jax.eval_shape(init_params)``.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import init_params as jax_init_params
from repro.models.model import abstract_params as jax_abstract_params
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import abstract_params
from repro_torch.tree import leaf_id, leaves_with_path
from repro_torch.weights import params_from_jax

from _torch_parity import arch_pair

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
