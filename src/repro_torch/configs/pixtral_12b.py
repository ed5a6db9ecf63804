"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 -- pixtral-ViT frontend + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

Modality frontend (the ViT) is a STUB per the assignment: input_specs()
provides precomputed patch+text embeddings (B, L, d_model).
long_500k: skipped -- pure full attention (see DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    period=(BlockCfg(mixer="attn"),),
    ffn_activation="silu",
    input_mode="embeddings",
    tied_embeddings=False,
    rope_theta=1000000000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    microbatch={"train_4k": 2},
)
