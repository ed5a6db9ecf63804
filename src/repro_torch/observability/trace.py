"""Per-request lifecycle tracing as Chrome trace events (Perfetto), and
the host's phases on the profiler's clock.

**Spans (B/E events).**  The serving engine opens a span per request
phase -- ``queued`` (submit to admit), one ``prefill_chunk`` per streamed
chunk, ``full_prefill`` per whole-prompt prefill, ``prune_compact``
around the end-of-prefill vote/compaction, one engine-scope
``decode_tick`` per batched decode -- and marks point events
(``first_token``, ``preempt``, ``abort``) as instants.  Each request
renders as its own track (``tid`` = request id + 1; ``tid 0`` is the
engine track).

**Phase intervals.**  Inside an engine iteration, compact
``(name, tid, start_ns, end_ns, label)`` tuples time the host's work at
finer grain, opened through :func:`phase` (``with phase("spls.plan"):``)
from any module.  They record into the recorder that the engine
activates for the duration of its ``tick()`` (:meth:`TraceRecorder.
activate`) and cost one context-variable read otherwise; the latest
recorder so activated stays readable after its engine is freed
(:func:`last_recorder`).  The engine's phases:

* ``engine.tick`` -- the root of one engine iteration (engine track);
* per layer of each SPLS chunk step (the request's track, inside its
  ``prefill_chunk``): ``spls.predict`` (HLog prediction, the predictor
  page write, the cached predicted K), ``spls.plan`` (the plan block, the
  own-column K/V keep, the capacity counts), ``spls.topk`` (the top-k
  bisection, inside ``spls.plan``), ``chunk.attend`` (K/V projection and
  page writes, packed Q, scores, softmax, AV, output projection) and
  ``chunk.ffn`` (the residual FFN);
* ``chunk.host`` -- the chunk step's host work after the forward (vote
  OR, horizon liveness, capacity observations, FLOP accounting);
* ``decode.prepare`` (tables and slot arrays onto the device) and
  ``decode.forward`` (the decode step's enqueue and the token pick);
* ``sync`` -- every point where the host waits for the card
  (:func:`host_wait`), labelled with what it waited for: ``votes``,
  ``capacity_counts``, ``token_pick``, ``h2d:<name>`` (a blocking
  host-to-device copy).

A phase's track is that of the latest engine span still open when it
starts (:attr:`TraceRecorder.track`, kept by the telemetry facade), so
each phase's parent is the span or phase that encloses it on its own
track.

**Two clocks.**  A span event's ``ts`` comes from the caller (the
registry's injected monotonic clock, seconds); every event also carries
``wall_ns``, ``time.time_ns()`` when it was recorded.  Phase intervals
are stamped on ``time.time_ns()`` only -- they never read the injected
clock, so a clock that waits for the card adds no wait per phase.
``time.time_ns`` is the clock of ``torch.profiler``'s timeline, so the
intervals lie over a profile of the same run.  A span ended on a CUDA
device (:meth:`TraceRecorder.end`'s ``device``) gets the time the card
reached the span's end, ``device_end_ns`` on the wall clock, once
:meth:`TraceRecorder.resolve_device_ends` runs: after the next
:func:`host_wait` (the card has caught up by then, so no CUDA event
outlives it) and on export.  The later of ``wall_ns`` and
``device_end_ns`` is when the span's work ended, where the host returned
before the card finished.

Export is the Chrome trace-event JSON format: spans at their ``ts``
converted to microseconds, intervals as complete (``"X"``) events in
wall-clock microseconds on a process of their own (``pid + 1``), so they
stay apart from the spans' clock.  Spans are **B/E pairs**:
``begin``/``end`` must nest per track, and intervals per track nest or
are disjoint, which :func:`TraceRecorder.validate` checks -- the test
suite runs it on real engine traces.

A ``TraceRecorder(enabled=False)`` drops everything (records nothing);
``max_events`` bounds the events and, apart, the intervals, with the
overflow counted in ``dropped`` instead of silently truncating.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import time
from typing import List, Optional

__all__ = ["TraceRecorder", "ENGINE_TRACK", "host_wait", "last_recorder",
           "phase"]

# tid of the engine-scope track (requests use tid = rid + 1 so rid 0
# does not collide with the engine track)
ENGINE_TRACK = 0

# the recorder of the engine iteration under way in this context
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_active_trace", default=None)
_OFF = contextlib.nullcontext()
# the recorder of the latest engine iteration in this process
_LAST: Optional["TraceRecorder"] = None


class _Interval:
    """One phase interval being timed (see :func:`phase`)."""

    __slots__ = ("rec", "name", "tid", "label", "t0")

    def __init__(self, rec: "TraceRecorder", name: str, tid: int,
                 label: Optional[str]):
        self.rec, self.name, self.tid, self.label = rec, name, tid, label

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rec.interval(self.name, self.tid, self.t0, time.time_ns(),
                          self.label)
        return False


class _Wait(_Interval):
    """A ``sync`` phase.  Once the host has waited for the card, the card
    has reached every span end marked before the wait, so the recorder
    dates those marks then (one anchor event, on an idle stream)."""

    __slots__ = ()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self.rec._pending:
            self.rec.resolve_device_ends()
        return False


def phase(name: str, label: Optional[str] = None):
    """``with phase(name):`` times the block as a phase interval of the
    active recorder, on its current track; a no-op context when no engine
    iteration is under way (or its telemetry is off)."""
    rec = _ACTIVE.get()
    if rec is None:
        return _OFF
    return _Interval(rec, name, rec.track, label)


def last_recorder() -> Optional["TraceRecorder"]:
    """The recorder of the latest engine iteration run in this process
    with telemetry on (None before any), kept after its engine is freed:
    a harness reads a run's spans and phases once the engine has gone,
    without a hook inside the run."""
    return _LAST


def host_wait(label: str):
    """``with host_wait(what):`` -- the ``sync`` phase around a point where
    the host blocks on the card (a readback, a blocking copy), labelled
    with what it waits for; after it, the span ends marked on the card
    are resolved (:meth:`TraceRecorder.resolve_device_ends`)."""
    rec = _ACTIVE.get()
    if rec is None:
        return _OFF
    return _Wait(rec, "sync", rec.track, label)


class TraceRecorder:
    def __init__(self, enabled: bool = True, pid: int = 1,
                 max_events: int = 200_000):
        self.enabled = enabled
        self.pid = pid
        self.max_events = max_events
        self.events: List[dict] = []
        self.intervals: List[tuple] = []
        self.dropped = 0
        # the track that phases record onto (the engine's open span's)
        self.track = ENGINE_TRACK
        self._stacks: dict = {}   # (pid, tid) -> [open span names]
        self._pending: list = []  # [(E event, CUDA event, device)]

    # ------------------------------------------------------------------
    def _emit(self, ev: dict) -> bool:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return False
        self.events.append(ev)
        return True

    def open_spans(self, tid: int) -> List[str]:
        """Names of currently open spans on a track, outermost first
        (the preemption/abort paths unwind these so B/E pairing stays
        valid whatever phase the request was torn out of)."""
        return list(self._stacks.get((self.pid, tid), []))

    @staticmethod
    def track_for(rid: int) -> int:
        return rid + 1

    def begin(self, name: str, ts: float, tid: int = ENGINE_TRACK,
              args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "B", "name": name, "ts": ts, "pid": self.pid,
              "tid": tid, "wall_ns": time.time_ns()}
        if args:
            ev["args"] = args
        self._stacks.setdefault((self.pid, tid), []).append(name)
        self._emit(ev)

    def end(self, name: str, ts: float, tid: int = ENGINE_TRACK,
            args: Optional[dict] = None, device=None) -> None:
        """Close a span.  On a CUDA ``device``, a CUDA event is recorded on
        its current stream (no wait) and resolved to the span's
        ``device_end_ns`` later."""
        if not self.enabled:
            return
        ev = {"ph": "E", "name": name, "ts": ts, "pid": self.pid,
              "tid": tid, "wall_ns": time.time_ns()}
        if args:
            ev["args"] = args
        stack = self._stacks.get((self.pid, tid))
        if stack and stack[-1] == name:
            stack.pop()
        if self._emit(ev) and getattr(device, "type", None) == "cuda":
            import torch
            mark = torch.cuda.Event(enable_timing=True)
            mark.record(torch.cuda.current_stream(device))
            self._pending.append((ev, mark, device))

    def instant(self, name: str, ts: float, tid: int = ENGINE_TRACK,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "i", "name": name, "ts": ts, "pid": self.pid,
              "tid": tid, "s": "t", "wall_ns": time.time_ns()}
        if args:
            ev["args"] = args
        self._emit(ev)

    # ------------------------------------------------------------------
    def activate(self):
        """Context of one engine iteration: :func:`phase` records here,
        and the iteration itself is the phase interval ``engine.tick`` on
        the engine track.  A no-op context when the recorder is
        disabled."""
        if not self.enabled:
            return _OFF
        return self._activated()

    @contextlib.contextmanager
    def _activated(self):
        global _LAST
        _LAST = self
        token = _ACTIVE.set(self)
        try:
            with _Interval(self, "engine.tick", ENGINE_TRACK, None):
                yield
        finally:
            _ACTIVE.reset(token)

    def interval(self, name: str, tid: int, start_ns: int, end_ns: int,
                 label: Optional[str] = None) -> None:
        if len(self.intervals) >= self.max_events:
            self.dropped += 1
            return
        self.intervals.append((name, tid, start_ns, end_ns, label))

    def resolve_device_ends(self) -> None:
        """Stamp each span ended with a CUDA event with ``device_end_ns``:
        one anchor event per device, waited for, dates every pending
        event by its elapsed time to the anchor."""
        if not self._pending:
            return
        import torch
        by_dev: dict = {}
        for ev, mark, dev in self._pending:
            by_dev.setdefault(dev, []).append((ev, mark))
        for dev, pend in by_dev.items():
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record(torch.cuda.current_stream(dev))
            anchor.synchronize()
            now = time.time_ns()
            for ev, mark in pend:
                ev["device_end_ns"] = now - round(
                    mark.elapsed_time(anchor) * 1e6)
        self._pending.clear()

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Raise ValueError unless every B has a matching E, properly
        nested per (pid, tid) track, with non-decreasing timestamps, and
        the phase intervals of each track nest or are disjoint."""
        stacks: dict = {}
        last_ts: dict = {}
        for ev in self.events:
            key = (ev["pid"], ev["tid"])
            if ev["ts"] < last_ts.get(key, float("-inf")):
                raise ValueError(
                    f"timestamps regress on track {key}: {ev}")
            last_ts[key] = ev["ts"]
            if ev["ph"] == "B":
                stacks.setdefault(key, []).append(ev["name"])
            elif ev["ph"] == "E":
                stack = stacks.get(key)
                if not stack:
                    raise ValueError(f"E without open B on {key}: {ev}")
                top = stack.pop()
                if top != ev["name"]:
                    raise ValueError(
                        f"mismatched span nesting on {key}: "
                        f"E {ev['name']!r} closes B {top!r}")
        open_spans = {k: v for k, v in stacks.items() if v}
        if open_spans:
            raise ValueError(f"unclosed spans: {open_spans}")
        ends: dict = {}   # tid -> ends of the enclosing intervals
        for iv in sorted(self.intervals, key=lambda s: (s[2], -s[3])):
            name, tid, a, b = iv[:4]
            if b < a:
                raise ValueError(f"interval ends before it starts: {iv}")
            open_ = ends.setdefault(tid, [])
            while open_ and open_[-1] <= a:
                open_.pop()
            if open_ and b > open_[-1]:
                raise ValueError(f"interval overlaps its parent on track "
                                 f"{tid}: {iv}")
            open_.append(b)

    def to_chrome_trace(self, time_scale: float = 1e6) -> dict:
        """Chrome trace JSON object.  ``time_scale`` converts the
        recorder's timestamp unit (seconds, from the monotonic clock) to
        the format's microseconds; a span's resolved device end goes into
        its E event's ``args`` (``device_end_us``, wall clock).  Phase
        intervals are ``"X"`` events in wall-clock microseconds on process
        ``pid + 1``."""
        self.resolve_device_ends()
        events = []
        for ev in self.events:
            out = {**ev, "ts": ev["ts"] * time_scale}
            if "device_end_ns" in ev:
                out["args"] = {**ev.get("args", {}),
                               "device_end_us": ev["device_end_ns"] / 1e3}
            events.append(out)
        if self.intervals:
            pid = self.pid + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": ENGINE_TRACK,
                           "args": {"name": "host phases (wall clock)"}})
            for name, tid, a, b, label in self.intervals:
                x = {"ph": "X", "name": name, "ts": a / 1e3,
                     "dur": (b - a) / 1e3, "pid": pid, "tid": tid}
                if label is not None:
                    x["args"] = {"what": label}
                events.append(x)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str, time_scale: float = 1e6) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(time_scale), f)
