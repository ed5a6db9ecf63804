"""ESACT core of the PyTorch port: the SPLS mechanism.

  quantizers      -- HLog / PoT / APoT log-domain quantizers + bit-level SD
  predict         -- HLog-quantized Q/K prediction
  topk            -- the row-wise top-k count
  similarity      -- fixed-window local similarity (critical/similar rows)
  mfi             -- Most-Frequent-Index FFN token sparsity
  spls_chunked    -- one progressive plan block per prefill chunk
  planner         -- PlanContext: predictor state, the streaming plan step
                     and the progressive full-sequence plan
  sparse_exec     -- execution under a plan: packing critical rows to
                     static capacities, leader recovery, sparse attention
                     and FFN
"""

from .spls import SPLSConfig, SparsityPlan
from .quantizers import (hlog_bitlevel_decode, hlog_bitlevel_encode,
                         hlog_bitlevel_project, hlog_project,
                         quantize_dequantize, symmetric_quantize)
from .predict import predict_qk, predict_qk_pre
from .topk import topk_count
from .similarity import LocalSimilarity, local_similarity, windowed_l1
from .mfi import FFNSparsity, mfi_ffn_sparsity
from .planner import (PlanContext, build_block_plan_progressive,
                      progressive_plan_blocks)
from .sparse_exec import (Compaction, compact_rows, gather_rows,
                          pack_by_mask, unpack_by_leader)

__all__ = [
    "SPLSConfig", "SparsityPlan", "hlog_bitlevel_decode",
    "hlog_bitlevel_encode", "hlog_bitlevel_project", "hlog_project",
    "quantize_dequantize",
    "symmetric_quantize", "predict_qk", "predict_qk_pre", "topk_count",
    "LocalSimilarity", "local_similarity", "windowed_l1", "FFNSparsity",
    "mfi_ffn_sparsity", "PlanContext", "build_block_plan_progressive",
    "progressive_plan_blocks", "Compaction", "compact_rows", "gather_rows",
    "pack_by_mask", "unpack_by_leader",
]
