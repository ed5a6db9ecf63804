"""The port's configuration dataclasses mirror the reference's: the same
field names, the same defaults, the same derived properties."""

from __future__ import annotations

import dataclasses

import jax  # noqa: F401  (both frameworks load in every parity test)
import pytest
import torch  # noqa: F401

from repro.configs import bert_base_esact as jbert
from repro.configs.base import ArchConfig as JArch, BlockCfg as JBlock
from repro.core.spls import SPLSConfig as JSPLS
from repro.serving import ServeConfig as JServe
from repro_torch.configs import bert_base_esact as tbert
from repro_torch.configs.base import ArchConfig as TArch, BlockCfg as TBlock
from repro_torch.core.spls import SPLSConfig as TSPLS
from repro_torch.serving import ServeConfig as TServe


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        d = f.default
        if dataclasses.is_dataclass(d):
            d = dataclasses.asdict(d)
        elif isinstance(d, tuple) and d and dataclasses.is_dataclass(d[0]):
            d = tuple(dataclasses.asdict(x) for x in d)
        out[f.name] = d
    return out


@pytest.mark.parametrize("pair", [(JArch, TArch), (JBlock, TBlock),
                                  (JSPLS, TSPLS), (JServe, TServe)],
                         ids=["ArchConfig", "BlockCfg", "SPLSConfig",
                              "ServeConfig"])
def test_fields_and_defaults_match(pair):
    ref, port = pair
    assert list(_fields(port)) == list(_fields(ref))
    assert _fields(port) == _fields(ref)
    assert (port.__dataclass_params__.frozen
            == ref.__dataclass_params__.frozen)


@pytest.mark.parametrize("smoke", [False, True])
def test_bert_config_and_properties_match(smoke):
    jc, tc = jbert.CONFIG, tbert.CONFIG
    if smoke:
        jc, tc = jc.smoke(), tc.smoke()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("n_periods", "resolved_head_dim", "d_inner", "has_attn",
                 "has_mamba", "has_moe"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


def test_bert_full_width():
    c = tbert.CONFIG
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.d_ff, c.vocab_size) == (12, 768, 12, 12, 64, 3072, 30522)
    assert c.ffn_activation == "gelu_mlp" and c.tied_embeddings
    assert (c.spls.k_ratio, c.spls.s_threshold, c.spls.f_threshold,
            c.spls.window, c.spls.quant_method, c.spls.quant_bits) == \
        (0.12, 0.6, 6, 8, "hlog", 8)


def test_post_init_validation_matches():
    for cls, blk in ((JArch, JBlock), (TArch, TBlock)):
        with pytest.raises(ValueError, match="not divisible"):
            cls(n_layers=3, period=(blk(), blk()))
        with pytest.raises(ValueError, match="at least one block"):
            cls(period=())
