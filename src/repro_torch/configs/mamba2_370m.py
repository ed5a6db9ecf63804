"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, vocab=50280,
ssm_state=128 -- SSD (state-space duality).  [arXiv:2405.21060; unverified]

long_500k: supported -- recurrent decode has O(1) state per token.
SPLS inapplicability: no attention matrix exists, so the paper's technique
does not apply (DESIGN.md §Arch-applicability); the arch runs dense.
vocab 50280 is not divisible by the 16-way model axis; the sharding layer
replicates the embedding (divisibility fallback).
"""

from repro_torch.configs.base import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    period=(BlockCfg(mixer="mamba", has_ffn=False),),
    ssm_state=128,
    mamba_headdim=64,
    mamba_expand=2,
    conv_width=4,
    tied_embeddings=True,
    param_dtype="float32",
    compute_dtype="bfloat16",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    microbatch={"train_4k": 8},
)
