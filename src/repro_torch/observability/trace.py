"""Per-request lifecycle tracing as Chrome trace events (Perfetto).

The serving engine opens a span per request phase -- ``queued`` (submit
to admit), one ``prefill_chunk`` per streamed chunk,
``prune_compact`` around the end-of-prefill vote/compaction, one
engine-scope ``decode_tick`` per batched decode -- and marks point
events (``first_token``, ``preempt``, ``abort``) as instants.  Export is
the Chrome trace-event JSON array format: load the file at
https://ui.perfetto.dev (or chrome://tracing) and each request renders
as its own track (``tid`` = request id; ``tid 0`` is the engine track).

Timestamps come from the caller (the registry's injected monotonic
clock), converted to the format's microsecond unit at export.  Spans are
**B/E pairs**: ``begin``/``end`` must nest per track, which
:func:`TraceRecorder.validate` checks -- the test suite runs it on real
engine traces.

A ``TraceRecorder(enabled=False)`` drops everything (records nothing);
``max_events`` bounds memory on long runs, with the overflow counted in
``dropped`` instead of silently truncating.
"""

from __future__ import annotations

import json
from typing import List, Optional

__all__ = ["TraceRecorder", "ENGINE_TRACK"]

# tid of the engine-scope track (requests use tid = rid + 1 so rid 0
# does not collide with the engine track)
ENGINE_TRACK = 0


class TraceRecorder:
    def __init__(self, enabled: bool = True, pid: int = 1,
                 max_events: int = 200_000):
        self.enabled = enabled
        self.pid = pid
        self.max_events = max_events
        self.events: List[dict] = []
        self.dropped = 0
        self._stacks: dict = {}   # (pid, tid) -> [open span names]

    # ------------------------------------------------------------------
    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

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
              "tid": tid}
        if args:
            ev["args"] = args
        self._stacks.setdefault((self.pid, tid), []).append(name)
        self._emit(ev)

    def end(self, name: str, ts: float, tid: int = ENGINE_TRACK,
            args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "E", "name": name, "ts": ts, "pid": self.pid,
              "tid": tid}
        if args:
            ev["args"] = args
        stack = self._stacks.get((self.pid, tid))
        if stack and stack[-1] == name:
            stack.pop()
        self._emit(ev)

    def instant(self, name: str, ts: float, tid: int = ENGINE_TRACK,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "i", "name": name, "ts": ts, "pid": self.pid,
              "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self._emit(ev)

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Raise ValueError unless every B has a matching E, properly
        nested per (pid, tid) track, with non-decreasing timestamps."""
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

    def to_chrome_trace(self, time_scale: float = 1e6) -> dict:
        """Chrome trace JSON object.  ``time_scale`` converts the
        recorder's timestamp unit (seconds, from the monotonic clock) to
        the format's microseconds."""
        events = [{**ev, "ts": ev["ts"] * time_scale} for ev in self.events]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str, time_scale: float = 1e6) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(time_scale), f)
