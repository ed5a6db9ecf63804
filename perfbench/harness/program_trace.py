"""The program's own spans over a traced window.

The engine's trace recorder (``repro_torch.observability.trace``) stamps
its spans' B/E events (``wall_ns``) and its phase intervals on
``time.time_ns``, the clock of the profiler's timeline.  From the chunk
steps (``prefill_chunk`` spans) and engine iterations (``engine.tick``
intervals) that lie wholly inside the window, :func:`read` takes

* the host time a chunk step spends in its planner (``spls.predict`` +
  ``spls.plan``) and in its compute (``chunk.attend`` + ``chunk.ffn``),
  and the share of the step its direct children cover;
* the host time an engine iteration waits for the card (``sync``);

and, given the window's profile,

* through the profiler's correlation of each CUDA runtime launch with the
  kernel, copy or fill it started, the device time of the work launched
  inside the planner's phases and the number of launches inside a chunk
  step;
* the card's idle seconds by innermost program span, each beside the
  device seconds launched from that span, printed to standard error.

The idle seconds follow :func:`~perfbench.harness.trace.summarize`'s rule
(each gap between the card's merged busy intervals goes to the innermost
phase open at its middle, the latest started where phases overlap) with
the program's spans as the phases, computed on arrays: the profile of a
51 s window of cell A holds some four million events, which one pass
reads into numpy (a Python sweep over them took over a minute).

Two ways in.  The metric readers call :func:`from_record` with a run's
record: the program keeps the recorder of its latest engine iteration
(``last_recorder()``) after the engine is freed, and the window is the
last ``window_s`` seconds before the end of the last engine iteration,
which closes it; these give the host numbers alone, the profile being
gone by then.  ``python3 -m perfbench.harness.program_trace --workload
<cell> --seed <n> --seconds <s>`` makes a traced run of a serving cell
as ``perfbench/run.py ... --trace 1`` does, prints its result line as
that does, and reads every number above at the window's close, with the
profile and the window's own edges, onto standard error.  A program
without phase intervals (one older than them) gives nothing.
"""

from __future__ import annotations

import bisect
import importlib
import json
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .trace import DEVICE_ACTIVITY

PLAN = ("spls.predict", "spls.plan")
COMPUTE = ("chunk.attend", "chunk.ffn")
# what the engine's spans read from the recorder (lifecycle spans such as
# ``request`` and ``queued`` are no host work)
ENGINE_SPANS = ("prefill_chunk", "full_prefill", "prune_compact",
                "decode_tick")
OUTSIDE = "outside_phases"


def span_intervals(events: List[dict], names) -> List[tuple]:
    """``(name, tid, start_ns, end_ns)`` of each B/E pair named in
    ``names``, on the events' wall clock."""
    out, open_ = [], {}
    for ev in events:
        if ev["name"] not in names or "wall_ns" not in ev:
            continue
        key = (ev["tid"], ev["name"])
        if ev["ph"] == "B":
            open_.setdefault(key, []).append(ev["wall_ns"])
        elif ev["ph"] == "E" and open_.get(key):
            out.append((ev["name"], ev["tid"], open_[key].pop(),
                        ev["wall_ns"]))
    return out


def _label(iv: tuple) -> str:
    return iv[0] if iv[4] is None else f"{iv[0]}:{iv[4]}"


def _inside(ivs: List[tuple], starts: List[int], a: int, b: int):
    """The intervals of one track (sorted by start) lying in ``[a, b]``."""
    i = bisect.bisect_left(starts, a)
    while i < len(ivs) and ivs[i][2] <= b:
        if ivs[i][3] <= b:
            yield ivs[i]
        i += 1


class Phases:
    """``(name, start, end)`` phases, sorted by start; :meth:`innermost`
    finds, for many times at once, the latest-started phase open at each
    (``start <= t < end``), which is ``summarize``'s rule."""

    def __init__(self, phases: List[Tuple[str, int, int]]):
        ph = sorted(phases, key=lambda p: p[1])
        self.names = [p[0] for p in ph]
        self.start = np.array([p[1] for p in ph], dtype=np.int64)
        self.end = np.array([p[2] for p in ph], dtype=np.int64)
        # the latest earlier phase that ends later: every phase between
        # it and this one ends no later than this one, so once this one
        # has ended, so have they
        up = np.full(len(ph), -1, dtype=np.int64)
        stack: List[int] = []
        for i, e in enumerate(self.end.tolist()):
            while stack and self.end[stack[-1]] <= e:
                stack.pop()
            up[i] = stack[-1] if stack else -1
            stack.append(i)
        self.up = up

    def innermost(self, t: np.ndarray) -> np.ndarray:
        """Index of the phase for each time in ``t``, -1 outside all."""
        idx = np.searchsorted(self.start, t, side="right") - 1
        todo = np.flatnonzero(idx >= 0)
        while todo.size:
            closed = self.end[idx[todo]] <= t[todo]
            todo = todo[closed]
            idx[todo] = self.up[idx[todo]]
            todo = todo[idx[todo] >= 0]
        return idx

    def by_name(self, idx: np.ndarray, weights: np.ndarray
                ) -> Dict[str, float]:
        """``weights`` summed by the name of phase ``idx`` (-1: outside)."""
        sums = np.bincount(idx + 1, weights=weights,
                           minlength=len(self.names) + 1)
        out: Dict[str, float] = {}
        for name, v in zip([OUTSIDE] + self.names, sums.tolist()):
            if v:
                out[name] = out.get(name, 0.0) + v
        return out


def device_work(prof) -> dict:
    """One pass over the profiler's events: the start and duration (ns)
    of every kernel, copy and fill on the card, and the host start of the
    CUDA runtime (or driver) call that launched each, by correlation id
    (``launch_ns`` -1 where none was recorded).  A launch's host events
    share its id (a lazy module load inside it starts later), so the
    earliest is the call itself; with only the CUDA activity on, the
    profiler records no other host events."""
    import torch
    evs = prof.profiler.kineto_results.events()
    n = len(evs)
    empty = np.zeros(0, dtype=np.int64)
    if not n:
        return {"start_ns": empty, "dur_ns": empty, "launch_ns": empty}
    ev_t = type(evs[0])
    cuda = int(torch.autograd.DeviceType.CUDA)
    on_dev = np.fromiter(map(int, map(ev_t.device_type, evs)),
                         dtype=np.int64, count=n) == cuda
    start = np.fromiter(map(ev_t.start_ns, evs), dtype=np.int64, count=n)
    dev = np.flatnonzero(on_dev).tolist()
    dev_evs = [evs[i] for i in dev]
    if hasattr(ev_t, "activity_type"):
        work = np.fromiter((k in DEVICE_ACTIVITY for k in
                            map(ev_t.activity_type, dev_evs)),
                           dtype=bool, count=len(dev))
    else:
        work = ~np.fromiter(map(ev_t.is_user_annotation, dev_evs),
                            dtype=bool, count=len(dev))
    dev_evs = [e for e, w in zip(dev_evs, work.tolist()) if w]
    d_idx = np.asarray(dev, dtype=np.int64)[work]
    out = {"start_ns": start[d_idx],
           "dur_ns": np.fromiter(map(ev_t.duration_ns, dev_evs),
                                 dtype=np.int64, count=len(dev_evs)),
           "launch_ns": np.full(len(dev_evs), -1, dtype=np.int64)}
    if not hasattr(ev_t, "correlation_id"):
        return out
    corr = np.fromiter(map(ev_t.correlation_id, evs), dtype=np.int64,
                       count=n)
    host = np.flatnonzero(~on_dev & (corr != 0))
    if not host.size or not len(dev_evs):
        return out
    order = host[np.lexsort((start[host], corr[host]))]
    first = np.r_[True, corr[order][1:] != corr[order][:-1]]
    h_corr, h_start = corr[order][first], start[order][first]
    d_corr = corr[d_idx]
    at = np.minimum(np.searchsorted(h_corr, d_corr), len(h_corr) - 1)
    hit = h_corr[at] == d_corr
    out["launch_ns"][hit] = h_start[at[hit]]
    return out


def idle_gaps(start: np.ndarray, dur: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Middle and length (ns) of each gap between the card's busy
    intervals, merged where they overlap or touch (``summarize``'s
    union)."""
    if not start.size:
        return start, start
    order = np.argsort(start, kind="stable")
    a, b = start[order], (start + dur)[order]
    reach = np.maximum.accumulate(b)
    new = np.flatnonzero(a[1:] > reach[:-1])
    gap_a, gap_b = reach[new], a[new + 1]
    return (gap_a + gap_b) // 2, gap_b - gap_a


def wall_ns(t: float) -> int:
    """A ``time.monotonic`` time on ``time.time_ns``'s clock."""
    return round(t * 1e9) + time.time_ns() - time.monotonic_ns()


def read(rec, prof, lo: int, hi: int, out=None) -> dict:
    """The numbers of the recorder ``rec``'s spans in the window ``[lo,
    hi]`` (``time.time_ns``), with ``prof`` (or None) the window's profile
    and the table to ``out`` (standard error by default); ``{}`` for a
    program without phase intervals."""
    out = out or sys.stderr
    ivs = getattr(rec, "intervals", None)
    if not ivs:
        return {}
    started = time.monotonic()
    spans = span_intervals(rec.events, ENGINE_SPANS)
    res = {"events": len(rec.events), "intervals": len(ivs),
           "dropped": rec.dropped}

    by_tid: Dict[int, List[tuple]] = {}
    for iv in sorted(ivs, key=lambda s: (s[2], -s[3])):
        by_tid.setdefault(iv[1], []).append(iv)
    starts = {t: [iv[2] for iv in v] for t, v in by_tid.items()}

    chunks = [s for s in spans if s[0] == "prefill_chunk"
              and lo <= s[2] and s[3] <= hi]
    plan = compute = 0
    cover = []
    for _, tid, a, b in chunks:
        kids = list(_inside(by_tid.get(tid, []), starts.get(tid, []), a, b))
        plan += sum(k[3] - k[2] for k in kids if k[0] in PLAN)
        compute += sum(k[3] - k[2] for k in kids if k[0] in COMPUTE)
        direct, edge = 0, a
        for k in kids:
            if k[2] >= edge:
                direct += k[3] - k[2]
                edge = k[3]
        cover.append(direct / (b - a) if b > a else 1.0)
    ticks = [iv for iv in ivs if iv[0] == "engine.tick"
             and lo <= iv[2] and iv[3] <= hi]
    syncs = sorted(iv[2:4] for iv in ivs if iv[0] == "sync")
    sync_starts = [s[0] for s in syncs]
    wait = 0
    for iv in ticks:
        i = bisect.bisect_left(sync_starts, iv[2])
        while i < len(syncs) and syncs[i][1] <= iv[3]:
            wait += syncs[i][1] - syncs[i][0]
            i += 1
    n = len(chunks)
    res.update(chunk_steps=n, ticks=len(ticks),
               plan_ms=plan / n * 1e-6 if n else None,
               compute_ms=compute / n * 1e-6 if n else None,
               sync_wait_ms=wait / len(ticks) * 1e-6 if ticks else None,
               child_cover_median=statistics.median(cover) if cover
               else None)
    if prof is None:
        return res

    # the table: every program span, innermost first where they nest
    phases = Phases(sorted([(_label(iv), iv[2], iv[3]) for iv in ivs]
                           + [(s[0], s[2], s[3]) for s in spans],
                           key=lambda p: (p[1], -p[2])))
    work = device_work(prof)
    mid, length = idle_gaps(work["start_ns"], work["dur_ns"])
    idle = {k: v * 1e-9 for k, v in
            phases.by_name(phases.innermost(mid), length).items()}
    launched = work["launch_ns"] >= 0
    h, d = work["launch_ns"][launched], work["dur_ns"][launched]
    at = phases.innermost(h)
    dev_by = {k: v * 1e-9 for k, v in phases.by_name(at, d).items()}
    total = sum(idle.values())
    res["idle_by_span"] = [[k, v, dev_by.get(k, 0.0)] for k, v in
                           sorted(idle.items(), key=lambda kv: -kv[1])]
    res["idle_outside_share"] = (idle.get(OUTSIDE, 0.0) / total
                                 if total else None)
    print("program spans: card idle s / device s launched, by innermost "
          "span (window):", file=out)
    rows = res["idle_by_span"] + [[k, 0.0, v] for k, v in dev_by.items()
                                  if k not in idle]
    for k, v, dv in rows:
        print(f"  {k:<28} {v:12.6f} {dv:12.6f}", file=out)
    print(f"program spans: {res['events']} events, {res['intervals']} "
          f"intervals, {res['dropped']} dropped; {n} chunk steps, children "
          f"cover {res['child_cover_median']} of the median", file=out)

    # the launches inside the window's chunk steps (which never overlap)
    if h.size and n:
        steps = np.array(sorted((c[2], c[3]) for c in chunks),
                         dtype=np.int64)
        i = np.searchsorted(steps[:, 0], h, side="right") - 1
        inside = (i >= 0) & (h < steps[np.maximum(i, 0), 1])
        planner = np.array([k in PLAN + ("spls.topk",) for k in phases.names]
                           + [False])
        res.update(plan_device_ms=float(d[inside & planner[at]].sum())
                   / n * 1e-6, launches=int(inside.sum()) / n)
    print(f"program spans: {int(h.size)} correlated launches of "
          f"{work['dur_ns'].size} device events; read in "
          f"{time.monotonic() - started:.3f} s", file=out)
    return res


def recorder():
    """The program's recorder of its latest engine iteration, or None
    (none ran, or a program older than ``last_recorder``)."""
    mod = importlib.import_module("repro_torch.observability.trace")
    last = getattr(mod, "last_recorder", None)
    return last() if last else None


_READ: list = [None, None]     # the record last read, and what it gave


def from_record(run: dict) -> dict:
    """The host numbers of a serving run's window (its record ``run``),
    read once per record from the program's latest recorder: the window
    is the ``window_s`` seconds that end with the last engine iteration.
    ``{}`` where the program keeps no such recorder."""
    if _READ[0] is run:
        return _READ[1]
    rec, res = recorder(), {}
    ticks = [iv[3] for iv in getattr(rec, "intervals", None) or ()
             if iv[0] == "engine.tick"]
    if ticks and run.get("window_s"):
        hi = max(ticks)
        res = read(rec, None, hi - round(run["window_s"] * 1e9), hi)
    _READ[:] = [run, res]
    return res


def main(argv: Optional[List[str]] = None) -> int:
    """A traced run of a serving cell with every number of the program's
    spans read at the window's close (see the module's docstring)."""
    from perfbench import run
    from . import serve

    inner = serve.ClosedLoop.window

    def window(self, seconds, trace):
        t0, t1, prof = inner(self, seconds, trace)
        rec = recorder()
        if rec is not None and prof is not None:
            res = read(rec, prof, wall_ns(t0), wall_ns(t1))
            print("program_trace: " + json.dumps(res), file=sys.stderr)
        return t0, t1, prof

    serve.ClosedLoop.window = window
    args = list(sys.argv[1:] if argv is None else argv)
    return run.main(args + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
