"""SPLS-aware serving of the PyTorch port.

Block-pool KV cache and the SPLS prune vote (:mod:`pager`), paged model
execution (:mod:`paged_model`), the continuous-batching scheduler with
chunked prefill and preemption (:mod:`scheduler`), and the engines
(:mod:`engine`): the paged engine and the dense fixed-slot one.
"""

from .pager import (NULL_PAGE, POS_SENTINEL, PagedKVCache, PagePool,
                    PredKCache, init_paged_cache, init_pos_pages,
                    init_pred_cache, keep_from_votes, spls_token_keep,
                    spls_token_votes)
from .paged_model import (compact_slots, paged_decode_step,
                          paged_prefill_chunk, paged_prefill_chunk_spls,
                          scatter_prefill)
from .scheduler import Scheduler, SchedulerConfig, SeqState
from .engine import PagedServingEngine, Request, ServeConfig, ServingEngine

__all__ = [
    "NULL_PAGE", "POS_SENTINEL", "PagedKVCache", "PagePool", "PredKCache",
    "init_paged_cache", "init_pos_pages", "init_pred_cache",
    "keep_from_votes", "spls_token_keep", "spls_token_votes",
    "compact_slots", "paged_decode_step", "paged_prefill_chunk",
    "paged_prefill_chunk_spls", "scatter_prefill", "Scheduler", "SchedulerConfig", "SeqState",
    "PagedServingEngine", "Request", "ServeConfig", "ServingEngine",
]
