"""A BERT-Base configuration file -> the program's encoder, and the
benchmark's weights for it, drawn on the device from the run's seed, a
few large calls of one ``torch.Generator``, in the layout the program
runs from; the reference reads the same tensors
(:mod:`perfbench.reference.bert`)."""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# the block this module builds, as the configuration file states it
STRUCTURE = {"norm_type": "pre_rmsnorm", "use_bias": False,
             "lm_head": "tied_all_positions", "type_vocab_size": 0,
             "position_embedding_type": "rotary"}


def arch_config(cfg: dict, attn_backend: str = "auto"):
    from repro_torch.configs.base import ArchConfig, BlockCfg
    from repro_torch.core.spls import SPLSConfig

    off = {k: cfg.get(k) for k, v in STRUCTURE.items() if cfg.get(k) != v}
    if off:
        raise ValueError(f"this encoder builds {STRUCTURE}; the file "
                         f"states {off}")
    sp = cfg["spls"]
    H = cfg["num_attention_heads"]
    return ArchConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=H, n_kv_heads=H, head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        period=(BlockCfg(mixer="attn"),), causal=False,
        ffn_activation="gelu_mlp", tied_embeddings=True,
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["layer_norm_eps"],
        param_dtype=cfg["torch_dtype"], compute_dtype=cfg["torch_dtype"],
        attn_backend=attn_backend, remat=False,
        spls=SPLSConfig(enabled=True, k_ratio=sp["k_ratio"],
                        s_threshold=sp["s_threshold"],
                        f_threshold=sp["f_threshold"], window=sp["window"],
                        quant_bits=sp["quant_bits"], causal=False))


def make_weights(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = _DTYPES[cfg["torch_dtype"]]
    L, D, V = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["vocab_size"])
    H, Dh, F = (cfg["num_attention_heads"], cfg["head_dim"],
                cfg["intermediate_size"])

    def proj(shape, fan_in):
        t = torch.empty(shape, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return t.mul_(fan_in ** -0.5).to(dtype)

    def norm(shape):
        return torch.randn(shape, device=device, generator=gen).mul_(
            0.1).to(dtype)

    block = {"ln1": norm((L, D)), "ln2": norm((L, D)),
             "attn": {"wq": proj((L, D, H, 1, Dh), D),
                      "wk": proj((L, D, H, Dh), D),
                      "wv": proj((L, D, H, Dh), D),
                      "wo": proj((L, H, 1, Dh, D), H * Dh)},
             "ffn": {"w_up": proj((L, D, F), D), "w_down": proj((L, F, D), F)}}
    return {"embed": proj((V, D), D), "periods": (block,),
            "final_norm": norm((D,))}
