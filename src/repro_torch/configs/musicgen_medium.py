"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24, MHA) d_ff=6144
vocab=2048 -- decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Modality frontend (EnCodec) is a STUB per the assignment: input_specs()
provides precomputed frame embeddings (B, L, d_model); the head predicts
EnCodec codebook tokens (vocab 2048).
long_500k: skipped -- pure full attention (see DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    period=(BlockCfg(mixer="attn"),),
    ffn_activation="gelu_mlp",
    input_mode="embeddings",
    tied_embeddings=False,
    param_dtype="float32",
    compute_dtype="bfloat16",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    microbatch={"train_4k": 4},
)
