"""Operations and bytes from shapes: the numerators of the shares of peak.

Copied arithmetic, so that the yardstick stays where it is when the
program changes: the per-component matmul counts of
``repro_torch.sparse_compute.accounting.chunk_flops`` (a multiply-add is
two operations; Q, K, V and the output projection, attention's two
products over the context, a gated FFN's three products) and the
``2 N`` per token of ``repro_torch.launch.dryrun._model_flops``, here per
token with its own context; the byte bound of the paged decode kernel as
``chip_smoke.py`` states it (every live K and V row read once, q read and
the output written once).
"""

from __future__ import annotations

from typing import Iterable

# NVIDIA H100 SXM, dense, without sparsity (NVIDIA's data sheet)
PEAK_FP32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def _dims(cfg: dict):
    H = cfg["num_attention_heads"]
    return (cfg["num_hidden_layers"], cfg["hidden_size"], H,
            cfg.get("num_key_value_heads", H), cfg["head_dim"],
            cfg["intermediate_size"], cfg["vocab_size"])


def _ffn_mats(cfg: dict) -> int:
    return 3 if cfg.get("hidden_act", "silu") in ("silu",) else 2


def proj_flops(cfg: dict) -> float:
    """One token through every layer's projections and FFN."""
    L, D, H, KV, Dh, F, _ = _dims(cfg)
    per = 2.0 * (D * H * Dh + 2 * D * KV * Dh + H * Dh * D
                 + _ffn_mats(cfg) * D * F)
    return L * per


def attn_flops(cfg: dict, ctx: float) -> float:
    """One token's QK^T and AV over ``ctx`` columns, every layer."""
    L, _, H, _, Dh, _, _ = _dims(cfg)
    return L * 2.0 * 2.0 * H * Dh * ctx


def head_flops(cfg: dict) -> float:
    _, D, *_, V = _dims(cfg)
    return 2.0 * D * V


def causal_span_flops(cfg: dict, a: int, b: int) -> float:
    """Positions ``a .. b - 1`` of one sequence, each over its own causal
    context (position + 1 columns), without the LM head."""
    n = max(0, b - a)
    ctx = n * (a + b + 1) / 2.0          # sum of (p + 1) for p in [a, b)
    return n * proj_flops(cfg) + attn_flops(cfg, ctx)


def paged_decode_bytes(cfg: dict, n_valid: Iterable[int],
                       elem_bytes: int = 4) -> float:
    """The least bytes of one decode tick's attention, every layer:
    ``n_valid`` live K / V rows of each active sequence read once, q read
    and the output written once."""
    L, _, H, KV, Dh, _, _ = _dims(cfg)
    rows = list(n_valid)
    kv = sum(rows) * KV * Dh * 2 * elem_bytes
    qo = len(rows) * H * Dh * 2 * elem_bytes
    return L * float(kv + qo)
