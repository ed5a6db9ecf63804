"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 -- GQA, 128k vocab.  [arXiv:2407.21783; unverified]

long_500k: skipped -- pure full attention (see DESIGN.md).
bf16 params + optimizer state to fit 16 GB/chip HBM at 512 chips
(see DESIGN.md hardware-adaptation notes).
"""

from repro_torch.configs.base import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    period=(BlockCfg(mixer="attn"),),
    ffn_activation="silu",
    tied_embeddings=False,
    rope_theta=500000.0,
    fsdp=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k"),
    microbatch={"train_4k": 4},
)
