"""Serving telemetry for the PyTorch port.

Host-side, low-overhead observability for the paged SPLS serving stack:
typed metrics (:mod:`metrics`), per-request lifecycle tracing as Chrome
trace events (:mod:`trace`), SPLS sparsity instruments
(:mod:`sparsity`) and the engine-facing facade (:mod:`telemetry`).  The
modules are copies of the reference package's pure-Python ones; only
``tree_bytes`` is rewritten for tensors.  The ``BENCH_serving.json``
report module has not been ported yet (ROADMAP.md, Queue A item 6).
"""

from .metrics import (Counter, CounterDictView, Gauge, Histogram,
                      MetricsRegistry, NullInstrument, percentile)
from .trace import ENGINE_TRACK, TraceRecorder
from .sparsity import SparsityInstruments, tree_bytes
from .telemetry import RequestRecord, Telemetry

__all__ = [
    "Counter", "CounterDictView", "Gauge", "Histogram", "MetricsRegistry",
    "NullInstrument", "percentile", "ENGINE_TRACK", "TraceRecorder",
    "SparsityInstruments", "tree_bytes", "RequestRecord", "Telemetry",
]
