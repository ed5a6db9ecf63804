"""SPLS-specific serving instruments.

What ESACT's sparsity pipeline should be able to show about itself at
runtime (cf. AccelTran's per-component realized-vs-predicted sparsity
counters): realized kept-column ratios vs the scheduler's EMA estimate,
vote-horizon finalization counts, capacity-bucket occupancy and
overflow-fallback rates per :class:`~repro_torch.sparse_compute.capacity.
CapacityController`, and the byte/occupancy gauges of the page pool and
the int8 predictor cache.

Everything here is a thin naming layer over the
:class:`~repro_torch.observability.metrics.MetricsRegistry` -- one place owns
the instrument names so the engine, the report module, and the tests
agree on them.  All methods are host-side and cheap; with a disabled
registry every call lands on the shared null instrument.

Note on "per-layer": serving's prune decision is *layer-shared* by
design -- the layer-0 cross-head vote decides a page slot that every
layer uses (SpAtten-style; see ``serving/README.md``) -- so the kept
ratio is one number per request plus the per-head agreement the vote
aggregates, not a per-layer family.
"""

from __future__ import annotations

from .metrics import MetricsRegistry

__all__ = ["SparsityInstruments", "tree_bytes"]


def tree_bytes(tree) -> int:
    """Total bytes of the tensors in a nested tuple / list / dict /
    NamedTuple (metadata only, no device sync)."""
    if hasattr(tree, "element_size"):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return 0


class SparsityInstruments:
    def __init__(self, registry: MetricsRegistry):
        self.registry = registry

    # -- prune vote ----------------------------------------------------
    def note_prune(self, prompt_len: int, kept: int) -> None:
        """One request's finalized page-prune outcome."""
        r = self.registry
        if prompt_len > 0:
            r.histogram("spls/kept_ratio").observe(kept / prompt_len)
        r.counter("spls/columns_seen").inc(prompt_len)
        r.counter("spls/columns_kept").inc(kept)

    def note_votes(self, head_votes) -> None:
        """Per-head agreement at vote finalization: ``head_votes`` is the
        (H, S) accumulated keep-vote matrix; records the fraction of
        prompt columns each head wanted kept."""
        import numpy as np

        hv = np.asarray(head_votes)
        if hv.size == 0:
            return
        hist = self.registry.histogram("spls/head_keep_frac")
        for frac in hv.mean(axis=1):
            hist.observe(float(frac))

    # -- horizon-finalized votes (core.planner) ------------------------
    def note_horizon(self, finalized: int, kv_capacity_drops: int = 0
                     ) -> None:
        r = self.registry
        r.counter("spls/horizon_finalized_cols").inc(finalized)
        if kv_capacity_drops:
            r.counter("spls/horizon_kv_capacity_drops").inc(
                kv_capacity_drops)

    # -- capacity controllers (sparse_compute.capacity) ----------------
    def note_capacity(self, kind: str, capacity: int, observed: int,
                      overflowed: bool) -> None:
        """One packed chunk's capacity outcome for controller ``kind``
        (``q`` / ``ffn`` / ``kv``): the bucket served, the critical-row
        count observed, and whether the chunk overflowed into the
        window-leader fallback."""
        r = self.registry
        r.gauge(f"capacity/{kind}_bucket").set(capacity)
        r.histogram(f"capacity/{kind}_critical_rows").observe(observed)
        if capacity > 0:
            r.histogram(f"capacity/{kind}_occupancy").observe(
                min(observed, capacity) / capacity)
        r.counter(f"capacity/{kind}_chunks").inc()
        if overflowed:
            r.counter(f"capacity/{kind}_overflows").inc()

    # -- page pool / predictor cache -----------------------------------
    def observe_pool(self, pool) -> None:
        """Pool occupancy gauges (the gauge keeps the high-watermark) and
        the double-free/foreign-free guard-trip counter."""
        r = self.registry
        r.gauge("pool/pages_in_use").set(pool.pages_in_use)
        r.gauge("pool/free_pages").set(pool.free_pages)
        if pool.capacity > 0:
            r.gauge("pool/utilization").set(
                pool.pages_in_use / pool.capacity)
        r.counter("pool/guard_trips").set(pool.guard_trips)

    def note_pool_bytes(self, kv_bytes: int, pred_bytes: int = 0) -> None:
        r = self.registry
        r.gauge("pool/kv_bytes").set(kv_bytes)
        r.gauge("pool/pred_cache_bytes").set(pred_bytes)
