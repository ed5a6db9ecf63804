"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 -- Mamba+attention 1:7 interleave, MoE
every other layer.  [arXiv:2403.19887; hf]

Period of 8 layers: attention at index 4, mamba elsewhere; MoE on odd
indices (4 MoE / 4 dense per period).  4 periods = 32 layers.
long_500k: supported (hybrid -- mamba layers are O(1)/token, the 4 attn
layers read the cache).
"""

from repro_torch.configs.base import ArchConfig, BlockCfg

_M = lambda moe: BlockCfg(mixer="mamba", use_moe=moe)
_A = lambda moe: BlockCfg(mixer="attn", use_moe=moe)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    period=(_M(False), _M(True), _M(False), _M(True),
            _A(False), _M(True), _M(False), _M(True)),
    moe_experts=16,
    moe_topk=2,
    capacity_factor=1.25,
    ssm_state=16,
    mamba_headdim=64,
    mamba_expand=2,
    conv_width=4,
    ffn_activation="silu",
    tied_embeddings=False,
    fsdp=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    microbatch={"train_4k": 4},
)
