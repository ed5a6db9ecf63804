"""The paper's own primary workload: BERT-Base encoder with SPLS enabled.

Used by the reproduction benchmarks (Fig. 15/16/17/18/19) and examples.
Non-causal, MHA, GELU MLP, seq 128/384/512 per the GLUE/SQuAD/CLOTH setup.
"""

from repro_torch.configs.base import ArchConfig, BlockCfg
from repro_torch.core.spls import SPLSConfig

CONFIG = ArchConfig(
    name="bert-base-esact",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=30522,
    period=(BlockCfg(mixer="attn"),),
    causal=False,
    ffn_activation="gelu_mlp",
    tied_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
    spls=SPLSConfig(enabled=True, k_ratio=0.12, s_threshold=0.6,
                    f_threshold=6, window=8, causal=False),
    supported_shapes=("train_4k", "prefill_32k"),
    microbatch={"train_4k": 8},
)
