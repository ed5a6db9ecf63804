"""Architecture configuration system (a copy of the reference package's
``configs/base.py``; the same field names, defaults and properties).

Every assigned architecture is expressed as an :class:`ArchConfig`: a layer
*pattern* (one period of possibly-heterogeneous blocks, repeated
``n_periods`` times), attention/SSM/MoE hyper-parameters, numerics, and
the SPLS settings for the paper's technique.  ``smoke()`` returns a
structurally identical but tiny config for CPU tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core.spls import SPLSConfig

__all__ = ["BlockCfg", "ArchConfig", "ShapeCfg", "LM_SHAPES"]


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One block inside the layer period."""

    mixer: str = "attn"            # "attn" | "mamba"
    window: Optional[int] = None   # sliding-window size (None = global)
    use_moe: bool = False
    has_ffn: bool = True           # mamba2-pure blocks have no FFN


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One input-shape cell from the assignment table."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


LM_SHAPES: Tuple[ShapeCfg, ...] = (
    ShapeCfg("train_4k", 4096, 256, "train"),
    ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    ShapeCfg("decode_32k", 32768, 128, "decode"),
    ShapeCfg("long_500k", 524288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"          # dense | moe | ssm | hybrid | audio | vlm
    # dimensions
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 1024
    # layer pattern: `period` repeated `n_periods` times (scanned)
    period: Tuple[BlockCfg, ...] = (BlockCfg(),)
    # attention features
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    causal: bool = True
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    capacity_factor: float = 1.25
    # Mamba2 / SSD
    ssm_state: int = 0
    mamba_headdim: int = 64
    mamba_expand: int = 2
    conv_width: int = 4
    # embedding / IO
    input_mode: str = "tokens"      # "tokens" | "embeddings" (modality stub)
    tied_embeddings: bool = True
    norm_eps: float = 1e-6
    ffn_activation: str = "silu"    # silu (gated) | gelu (gated) | gelu_mlp
    use_post_norm: bool = False     # gemma2-style post-block norms
    scale_embedding: bool = False   # multiply embeddings by sqrt(d_model)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # FSDP (reference-package mesh option; kept for field parity, unused
    # by the single-card port)
    fsdp: bool = False
    # SPLS (the paper's technique); None-like default = disabled
    spls: SPLSConfig = SPLSConfig(enabled=False)
    # attention execution backend (repro_torch.models.attn_backend
    # registry): "auto" | "torch_paged_decode" | "cuda_paged_decode" (the
    # reference package's names are accepted as aliases)
    attn_backend: str = "auto"
    # compute execution backend for the token-compacted *linear* ops (QKV
    # projection / FFN) under SPLS (repro_torch.sparse_compute registry):
    # "dense" | "packed_torch" | "packed_cuda" | "auto"; packed backends
    # compute only critical rows and broadcast leaders
    compute_backend: str = "dense"
    # training
    remat: bool = True
    # shape support: names from LM_SHAPES this arch can run; long_500k only
    # for sub-quadratic archs (SSM / hybrid / SWA)
    supported_shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    # per-shape microbatch override for gradient accumulation {shape: mb}
    microbatch: Optional[dict] = None

    # ------------------------------------------------------------------
    def __post_init__(self):
        if len(self.period) == 0:
            raise ValueError("period must contain at least one block")
        if self.n_layers % len(self.period):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"period length {len(self.period)}")

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_nheads(self) -> int:
        return self.d_inner // self.mamba_headdim

    @property
    def has_attn(self) -> bool:
        return any(b.mixer == "attn" for b in self.period)

    @property
    def has_mamba(self) -> bool:
        return any(b.mixer == "mamba" for b in self.period)

    @property
    def has_moe(self) -> bool:
        return any(b.use_moe for b in self.period)

    def moe_capacity(self, n_tokens: int) -> int:
        """Per-expert token capacity, rounded up to a multiple of 8."""
        c = math.ceil(n_tokens * self.moe_topk * self.capacity_factor
                      / max(self.moe_experts, 1))
        return max(8, -(-c // 8) * 8)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, Dh = self.d_model, self.resolved_head_dim
        n = self.vocab_size * D  # embed
        if not self.tied_embeddings:
            n += D * self.vocab_size
        per_period = 0
        for b in self.period:
            if b.mixer == "attn":
                per_period += D * self.n_heads * Dh          # wq
                per_period += 2 * D * self.n_kv_heads * Dh   # wk, wv
                per_period += self.n_heads * Dh * D          # wo
            else:
                di, ds, nh = self.d_inner, self.ssm_state, self.mamba_nheads
                per_period += D * (2 * di + 2 * ds + nh)     # in_proj
                per_period += (di + 2 * ds) * self.conv_width
                per_period += di * D                          # out_proj
                per_period += 3 * nh + di                     # A, D, dt_bias, norm
            if b.has_ffn:
                mult = 3 if self.ffn_activation in ("silu", "gelu") else 2
                f = mult * D * self.d_ff
                if b.use_moe:
                    per_period += self.moe_experts * f + D * self.moe_experts
                else:
                    per_period += f
            per_period += 2 * D  # norms
        return n + per_period * self.n_periods + D

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.has_moe:
            return self.param_count()
        D = self.d_model
        mult = 3 if self.ffn_activation in ("silu", "gelu") else 2
        f = mult * D * self.d_ff
        dead = sum((self.moe_experts - self.moe_topk) * f
                   for b in self.period if b.use_moe) * self.n_periods
        return self.param_count() - dead

    # ------------------------------------------------------------------
    def smoke(self) -> "ArchConfig":
        """Structurally identical, CPU-sized variant for tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 * len(self.period) if len(self.period) <= 2 else len(self.period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            moe_experts=min(self.moe_experts, 4) if self.moe_experts else 0,
            moe_topk=min(self.moe_topk, 2) if self.moe_topk else 0,
            ssm_state=16 if self.ssm_state else 0,
            mamba_headdim=16,
            period=tuple(dataclasses.replace(
                b, window=min(b.window, 8) if b.window else None)
                for b in self.period),
            param_dtype="float32",
            compute_dtype="float32",
            spls=dataclasses.replace(self.spls, window=4)
            if self.spls.enabled else self.spls,
        )
