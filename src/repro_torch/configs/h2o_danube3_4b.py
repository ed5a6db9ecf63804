"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 -- llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]

long_500k: supported -- every layer is SWA, decode touches a bounded window.
"""

from repro_torch.configs.base import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="h2o-danube3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    period=(BlockCfg(mixer="attn", window=4096),),
    ffn_activation="silu",
    tied_embeddings=False,
    rope_theta=10000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    microbatch={"train_4k": 2},
)
