"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8.  [arXiv:2409.02060; hf]

long_500k: skipped -- pure full attention (see DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    period=(BlockCfg(mixer="attn", use_moe=True),),
    moe_experts=64,
    moe_topk=8,
    capacity_factor=1.25,
    qk_norm=True,
    ffn_activation="silu",
    tied_embeddings=False,
    rope_theta=10000.0,
    param_dtype="float32",
    compute_dtype="bfloat16",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    microbatch={"train_4k": 4},
)
