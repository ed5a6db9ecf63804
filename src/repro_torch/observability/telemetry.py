"""The telemetry facade the serving engines thread through.

One :class:`Telemetry` object per engine bundles the pieces:

* ``core`` -- an **always-on** mini registry holding the typed counters
  behind the back-compat ``stats`` views (``sched/admitted`` etc.).
  These are functional engine state, not optional diagnostics: they cost
  what the ad-hoc dict they replaced cost, so the telemetry knob does
  not gate them.
* ``metrics`` / ``trace`` / ``sparsity`` -- the knob-gated instruments:
  lifecycle histograms, Chrome trace spans, SPLS gauges.  With
  ``enabled=False`` these are no-op sinks and record **nothing** (the
  test suite pins an empty snapshot and an empty trace after a full
  serving run).
* ``requests`` -- per-request lifecycle records (submit / admit / first
  token / per-token cadence / preemptions / outcome) that the report
  module aggregates into TTFT/TPOT percentiles and
  preemption/requeue rates.

Every timestamp comes from the injected monotonic clock via
``Telemetry.now()`` -- host-side only, after device readback; nothing
here is ever traced by jit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from .metrics import MetricsRegistry
from .sparsity import SparsityInstruments
from .trace import TraceRecorder

__all__ = ["RequestRecord", "Telemetry"]


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle timestamps of one request (monotonic-clock seconds)."""

    rid: int
    prompt_len: int
    submit_ts: float
    admit_ts: Optional[float] = None     # first admission
    first_token_ts: Optional[float] = None
    last_token_ts: Optional[float] = None
    end_ts: Optional[float] = None
    n_tokens: int = 0
    n_preempts: int = 0
    outcome: Optional[str] = None        # "retired" | "aborted"

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submit_ts

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first (None with < 2
        tokens)."""
        if self.n_tokens < 2 or self.last_token_ts is None \
                or self.first_token_ts is None:
            return None
        return (self.last_token_ts - self.first_token_ts) \
            / (self.n_tokens - 1)


class Telemetry:
    def __init__(self, enabled: bool = True, clock=time.monotonic):
        self.enabled = enabled
        self.core = MetricsRegistry(enabled=True, clock=clock)
        self.metrics = MetricsRegistry(enabled=enabled, clock=clock)
        self.trace = TraceRecorder(enabled=enabled)
        self.sparsity = SparsityInstruments(self.metrics)
        self.requests: Dict[int, RequestRecord] = {}
        self.started_ts = clock()

    def now(self) -> float:
        return self.core.now()

    # -- request lifecycle ---------------------------------------------
    def request_submitted(self, rid: int, prompt_len: int) -> None:
        if not self.enabled:
            return
        ts = self.now()
        self.requests[rid] = RequestRecord(rid=rid, prompt_len=prompt_len,
                                           submit_ts=ts)
        tid = self.trace.track_for(rid)
        self.trace.begin("request", ts, tid,
                         args={"rid": rid, "prompt_len": prompt_len})
        self.trace.begin("queued", ts, tid)
        self.metrics.counter("requests/submitted").inc()

    def request_admitted(self, rid: int) -> None:
        if not self.enabled:
            return
        ts = self.now()
        rec = self.requests.get(rid)
        if rec is not None and rec.admit_ts is None:
            rec.admit_ts = ts
        self.trace.end("queued", ts, self.trace.track_for(rid))
        self.metrics.counter("requests/admitted").inc()

    def _unwind(self, tid: int, ts: float) -> None:
        """Close every span open on a track above the root "request"
        span -- preemption and abort can strike mid-phase, and B/E
        pairing must survive whatever phase the request was torn out
        of."""
        stack = self.trace.open_spans(tid)
        while stack and stack[-1] != "request":
            self.trace.end(stack.pop(), ts, tid)

    def request_preempted(self, rid: int) -> None:
        """Preemption-by-eviction: the request re-queues front-of-line,
        so one preemption is one requeue."""
        if not self.enabled:
            return
        ts = self.now()
        rec = self.requests.get(rid)
        if rec is not None:
            rec.n_preempts += 1
        tid = self.trace.track_for(rid)
        self._unwind(tid, ts)   # may be mid-prefill (grow_to self-preempt)
        self.trace.instant("preempt", ts, tid)
        self.trace.begin("queued", ts, tid)   # back in the waiting line
        self.metrics.counter("requests/preemptions").inc()
        self.metrics.counter("requests/requeues").inc()

    def _finish(self, rid: int, outcome: str) -> None:
        ts = self.now()
        rec = self.requests.get(rid)
        if rec is not None and rec.outcome is None:
            rec.end_ts = ts
            rec.outcome = outcome
            tpot = rec.tpot_s
            if tpot is not None:
                self.metrics.histogram("latency/tpot_s").observe(tpot)
            self.metrics.histogram("latency/e2e_s").observe(
                ts - rec.submit_ts)
        tid = self.trace.track_for(rid)
        self._unwind(tid, ts)   # queued / mid-prefill spans, if any
        if outcome == "aborted":
            self.trace.instant("abort", ts, tid)
        self.trace.end("request", ts, tid, args={"outcome": outcome})
        self.metrics.counter(f"requests/{outcome}").inc()

    def request_retired(self, rid: int) -> None:
        if self.enabled:
            self._finish(rid, "retired")

    def request_aborted(self, rid: int) -> None:
        if self.enabled:
            self._finish(rid, "aborted")

    # -- tokens --------------------------------------------------------
    def first_token(self, rid: int) -> None:
        if not self.enabled:
            return
        ts = self.now()
        rec = self.requests.get(rid)
        if rec is not None:
            if rec.first_token_ts is None:
                ttft = ts - rec.submit_ts
                self.metrics.histogram("latency/ttft_s").observe(ttft)
                self.trace.instant("first_token", ts,
                                   self.trace.track_for(rid))
            rec.first_token_ts = rec.first_token_ts or ts
            rec.last_token_ts = ts
            rec.n_tokens += 1
        self.metrics.counter("tokens/emitted").inc()

    def tokens_decoded(self, rids: List[int]) -> None:
        """One batched decode tick produced one token per rid (single
        clock read for the whole batch)."""
        if not self.enabled or not rids:
            return
        ts = self.now()
        for rid in rids:
            rec = self.requests.get(rid)
            if rec is None:
                continue
            if rec.first_token_ts is None:
                rec.first_token_ts = ts
                self.metrics.histogram("latency/ttft_s").observe(
                    ts - rec.submit_ts)
                self.trace.instant("first_token", ts,
                                   self.trace.track_for(rid))
            rec.last_token_ts = ts
            rec.n_tokens += 1
        self.metrics.counter("tokens/emitted").inc(len(rids))

    # -- engine phases -------------------------------------------------
    def span_begin(self, name: str, rid: Optional[int] = None,
                   args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        tid = 0 if rid is None else self.trace.track_for(rid)
        self.trace.begin(name, self.now(), tid, args=args)

    def span_end(self, name: str, rid: Optional[int] = None,
                 args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        tid = 0 if rid is None else self.trace.track_for(rid)
        self.trace.end(name, self.now(), tid, args=args)
