"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 -- local+global alternating attention, logit soft-capping.
[arXiv:2408.00118; hf]

long_500k: supported -- half the layers are SWA(4096) and the cell is a
*decode* step (O(cache) per token); the global layers read the full cache.
"""

from repro_torch.configs.base import ArchConfig, BlockCfg

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    period=(BlockCfg(mixer="attn", window=4096), BlockCfg(mixer="attn")),
    attn_softcap=50.0,
    final_softcap=30.0,
    ffn_activation="gelu",        # GeGLU
    use_post_norm=True,
    scale_embedding=True,
    tied_embeddings=True,
    rope_theta=10000.0,
    fsdp=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    microbatch={"train_4k": 4},
)
