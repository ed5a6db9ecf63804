"""ESACT core of the PyTorch port: the SPLS mechanism.

  quantizers      -- HLog / PoT / APoT log-domain quantizers + bit-level SD
  predict         -- HLog-quantized Q/K prediction and the full PAM
  topk            -- row-wise top-k -> SPA + K/V column pruning
  similarity      -- fixed-window local similarity (critical/similar rows)
  mfi             -- Most-Frequent-Index FFN token sparsity
  spls            -- the one-shot plan (``build_plan``) and its stats
  spls_chunked    -- one progressive plan block per row block / chunk, and
                     the long-sequence row-block plan
  planner         -- PlanContext: predictor state and every planning mode
                     (exact, scan, streaming step, progressive)
  sparse_exec     -- execution under a plan: packing critical rows to
                     static capacities, leader recovery, sparse attention
                     and FFN
  flops           -- exact FLOPs accounting (the paper's Fig. 15)
"""

from .spls import SPLSConfig, SparsityPlan, build_plan, plan_stats
from .quantizers import (apot_project, hlog_bitlevel_decode,
                         hlog_bitlevel_encode, hlog_bitlevel_project,
                         hlog_levels, hlog_project, pot_project,
                         quantize_dequantize, symmetric_quantize)
from .predict import predict_qk, predict_qk_pre, predicted_attention
from .topk import kv_keep_from_mask, row_topk_mask, sparsify_pam, topk_count
from .similarity import LocalSimilarity, local_similarity, windowed_l1
from .mfi import FFNSparsity, mfi_ffn_sparsity
from .spls_chunked import ChunkedPlan, chunked_plan_scan
from .planner import (PlanContext, build_block_plan,
                      build_block_plan_chunked,
                      build_block_plan_progressive, progressive_plan_blocks)
from .sparse_exec import (Compaction, compact_rows, gather_rows,
                          pack_by_mask, spls_attention,
                          spls_attention_packed, spls_ffn, spls_ffn_packed,
                          unpack_by_leader)
from .flops import ComponentFlops, dense_flops, reduction_report, spls_flops

__all__ = [
    "SPLSConfig", "SparsityPlan", "build_plan", "plan_stats",
    "apot_project", "hlog_bitlevel_decode", "hlog_bitlevel_encode",
    "hlog_bitlevel_project", "hlog_levels", "hlog_project", "pot_project",
    "quantize_dequantize", "symmetric_quantize", "predict_qk",
    "predict_qk_pre", "predicted_attention", "kv_keep_from_mask",
    "row_topk_mask", "sparsify_pam", "topk_count", "LocalSimilarity",
    "local_similarity", "windowed_l1", "FFNSparsity", "mfi_ffn_sparsity",
    "ChunkedPlan", "chunked_plan_scan", "PlanContext", "build_block_plan",
    "build_block_plan_chunked", "build_block_plan_progressive",
    "progressive_plan_blocks", "Compaction", "compact_rows", "gather_rows",
    "pack_by_mask", "spls_attention", "spls_attention_packed", "spls_ffn",
    "spls_ffn_packed",
    "unpack_by_leader", "ComponentFlops", "dense_flops", "reduction_report",
    "spls_flops",
]
