"""Shared set-up for the parity tests of the PyTorch port against the
reference JAX package: matching configurations in both packages, bridged
weights, and numpy inputs from a seed.  JAX stays on the CPU."""

from __future__ import annotations

import jax
import numpy as np
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import BlockCfg as JBlockCfg
from repro.core.spls import SPLSConfig as JSPLSConfig
from repro.models import init_params as jax_init_params
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.configs.base import BlockCfg as TBlockCfg
from repro_torch.core.spls import SPLSConfig as TSPLSConfig
from repro_torch.weights import params_from_jax

jax.config.update("jax_platform_name", "cpu")

SPLS = dict(enabled=True, k_ratio=0.12, s_threshold=0.6, f_threshold=2,
            window=4, causal=True)

# small causal configurations: MHA, GQA (G = 2) with qk-norm, a window
CONFIGS = {
    "mha": dict(),
    "gqa_qknorm": dict(n_kv_heads=2, qk_norm=True),
    "gqa_window_softcap": dict(n_kv_heads=2, window=12, attn_softcap=20.0),
}


def cfg_pair(kind: str = "mha", spls: dict = None, **kw):
    """(reference ArchConfig, port ArchConfig) with equal fields."""
    over = dict(CONFIGS[kind])
    over.update(kw)
    window = over.pop("window", None)
    base = dict(name=f"parity-{kind}", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128,
                ffn_activation="gelu_mlp", remat=False, causal=True)
    base.update(over)
    sp = dict(SPLS)
    sp.update(spls or {})
    jc = JArchConfig(period=(JBlockCfg(window=window),),
                     spls=JSPLSConfig(**sp), **base)
    tc = TArchConfig(period=(TBlockCfg(window=window),),
                     spls=TSPLSConfig(**sp), **base)
    return jc, tc


_PARAMS = {}


def params_pair(jc, seed: int = 0):
    """(reference params, the same weights as port tensors on the CPU)."""
    key = (jc, seed)
    if key not in _PARAMS:
        jp = jax_init_params(jc, jax.random.PRNGKey(seed))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _PARAMS[key] = (jp, tp)
    return _PARAMS[key]


def t(a) -> torch.Tensor:
    """numpy / jax array -> CPU tensor (copied)."""
    return torch.from_numpy(np.array(a, copy=True))


def n(x) -> np.ndarray:
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
