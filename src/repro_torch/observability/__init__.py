"""Serving telemetry for the PyTorch port.

Host-side, low-overhead observability for the paged SPLS serving stack:
typed metrics (:mod:`metrics`), per-request lifecycle tracing as Chrome
trace events (:mod:`trace`), SPLS sparsity instruments
(:mod:`sparsity`), the engine-facing facade (:mod:`telemetry`) and the
schema-versioned ``BENCH_serving.json`` report (:mod:`report`, validated
by ``python -m repro_torch.observability``).  The modules are copies of
the reference package's pure-Python ones; only ``tree_bytes`` is
rewritten for tensors.
"""

from .metrics import (Counter, CounterDictView, Gauge, Histogram,
                      MetricsRegistry, NullInstrument, percentile)
from .trace import ENGINE_TRACK, TraceRecorder
from .sparsity import SparsityInstruments, tree_bytes
from .telemetry import RequestRecord, Telemetry
from .report import (SCHEMA_VERSION, latency_ms, serving_report,
                     validate_report, write_report)

__all__ = [
    "Counter", "CounterDictView", "Gauge", "Histogram", "MetricsRegistry",
    "NullInstrument", "percentile", "ENGINE_TRACK", "TraceRecorder",
    "SparsityInstruments", "tree_bytes", "RequestRecord", "Telemetry",
    "SCHEMA_VERSION", "latency_ms", "serving_report", "validate_report",
    "write_report",
]
