"""A Qwen3 configuration file -> the serving program's model, and the
benchmark's weights for it.

The weights are drawn on the device from the run's seed, a few large
calls of one ``torch.Generator``, in the layout the program serves from;
the reference reads the same tensors (:mod:`perfbench.reference.qwen3`).
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def arch_config(cfg: dict, spls: bool):
    """The program's ``ArchConfig`` for this file (imported here, never by
    the reference); SPLS on or off as the traffic mix asks."""
    from repro_torch.configs.base import ArchConfig, BlockCfg
    from repro_torch.core.spls import SPLSConfig

    sp = cfg["spls"]
    return ArchConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        period=(BlockCfg(mixer="attn"),), qk_norm=True,
        ffn_activation="silu", tied_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        param_dtype=cfg["torch_dtype"], compute_dtype=cfg["torch_dtype"],
        causal=True, remat=False,
        spls=SPLSConfig(enabled=spls, k_ratio=sp["k_ratio"],
                        s_threshold=sp["s_threshold"],
                        f_threshold=sp["f_threshold"], window=sp["window"],
                        quant_bits=sp["quant_bits"], causal=True))


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Truncated-normal projections scaled by ``1 / sqrt(fan_in)``, norm
    scales ``0.1 * N(0, 1)`` (the program's RMSNorm multiplies by ``1 +
    scale``), stacked over layers, one draw per leaf."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = _DTYPES[cfg["torch_dtype"]]
    L, D, V = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["vocab_size"])
    H, KV, Dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    F, G = cfg["intermediate_size"], H // KV

    def proj(shape, fan_in):
        t = torch.empty(shape, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return t.mul_(fan_in ** -0.5).to(dtype)

    def norm(shape):
        return torch.randn(shape, device=device, generator=gen).mul_(
            0.1).to(dtype)

    block = {"ln1": norm((L, D)), "ln2": norm((L, D)),
             "attn": {"wq": proj((L, D, KV, G, Dh), D),
                      "wk": proj((L, D, KV, Dh), D),
                      "wv": proj((L, D, KV, Dh), D),
                      "wo": proj((L, KV, G, Dh, D), H * Dh),
                      "q_norm": norm((L, Dh)), "k_norm": norm((L, Dh))},
             "ffn": {"w_up": proj((L, D, F), D), "w_gate": proj((L, D, F), D),
                     "w_down": proj((L, F, D), F)}}
    return {"embed": proj((V, D), D), "periods": (block,),
            "final_norm": norm((D,))}

