"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]

long_500k: skipped -- pure full attention (see DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    period=(BlockCfg(mixer="attn", use_moe=True),),
    moe_experts=16,
    moe_topk=4,
    capacity_factor=1.25,
    ffn_activation="silu",
    tied_embeddings=False,
    rope_theta=500000.0,
    fsdp=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    microbatch={"train_4k": 4},
)
