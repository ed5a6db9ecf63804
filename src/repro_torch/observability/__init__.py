"""Serving telemetry for the PyTorch port.

Host-side, low-overhead observability for the paged SPLS serving stack:
typed metrics (:mod:`metrics`), per-request lifecycle tracing as Chrome
trace events (:mod:`trace`), SPLS sparsity instruments
(:mod:`sparsity`), the engine-facing facade (:mod:`telemetry`) and the
schema-versioned ``BENCH_serving.json`` report (:mod:`report`, validated
by ``python -m repro_torch.observability``).  The modules are copies of
the reference package's pure-Python ones; ``tree_bytes`` is rewritten
for tensors, and :mod:`trace` adds what the port alone records:

* spans (B/E events on each request's track and the engine's:
  ``queued``, ``prefill_chunk``, ``full_prefill``, ``prune_compact``,
  ``decode_tick``) stamped on two clocks -- ``ts`` on the injected
  monotonic clock, as the reference stamps them, and ``wall_ns`` on
  ``time.time_ns``, the clock of ``torch.profiler``'s timeline -- and,
  on the card, the time the card finished a ``prefill_chunk``,
  ``full_prefill`` or ``decode_tick`` (``device_end_ns``);
* phase intervals on ``time.time_ns`` only, opened anywhere with
  ``with phase(name):`` while the engine's ``tick()`` runs:
  ``engine.tick``; per layer of an SPLS chunk step ``spls.predict``,
  ``spls.plan`` (with ``spls.topk`` inside), ``chunk.attend``,
  ``chunk.ffn``; ``chunk.host``; ``decode.prepare``, ``decode.forward``;
  and ``sync`` around every wait of the host for the card
  (``with host_wait(what):``), labelled ``votes``, ``capacity_counts``,
  ``token_pick`` or ``h2d:<name>``; once a wait returns, the card's span
  ends marked before it are dated (``device_end_ns``), so no CUDA event
  outlives the next wait.

The recorder of the latest engine iteration stays readable after its
engine is freed (``last_recorder()``).

No phase adds an instrument to the metrics registry: the serving
report's ``counters`` are the reference's.
"""

from .metrics import (Counter, CounterDictView, Gauge, Histogram,
                      MetricsRegistry, NullInstrument, percentile)
from .trace import (ENGINE_TRACK, TraceRecorder, host_wait, last_recorder,
                    phase)
from .sparsity import SparsityInstruments, tree_bytes
from .telemetry import RequestRecord, Telemetry
from .report import (SCHEMA_VERSION, latency_ms, serving_report,
                     validate_report, write_report)

__all__ = [
    "Counter", "CounterDictView", "Gauge", "Histogram", "MetricsRegistry",
    "NullInstrument", "percentile", "ENGINE_TRACK", "TraceRecorder",
    "host_wait", "last_recorder", "phase", "SparsityInstruments",
    "tree_bytes", "RequestRecord", "Telemetry", "SCHEMA_VERSION",
    "latency_ms", "serving_report", "validate_report", "write_report",
]
