"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 -- qk-norm, GQA.  [hf:Qwen/Qwen3-8B; hf]

long_500k: skipped -- pure full attention (see DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    period=(BlockCfg(mixer="attn"),),
    qk_norm=True,
    ffn_activation="silu",
    tied_embeddings=True,
    rope_theta=1000000.0,
    param_dtype="float32",
    compute_dtype="bfloat16",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    microbatch={"train_4k": 8},
)
