"""The device trace of a traced run: ``torch.profiler`` over the window.

The profiler records the card's activity only (kernels, copies, fills);
busy time is the union of their intervals, as ``chip_smoke.py``'s path (d)
profile takes it, and a kernel's device time is the sum of its launches'.
The host's side comes from the harness itself: :class:`PhaseLog` stamps
the engine phases it wraps on the wall clock the profiler's timeline uses,
so an idle gap of the card is named by the innermost phase the host was
in at the gap's middle.  Raw profiler events are read directly (building
the profiler's event tree for a window of a million launches takes
minutes).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled():
    import torch
    from torch.profiler import ProfilerActivity, profile
    # a host without a card (the CPU tests) records its own ops instead
    act = (ProfilerActivity.CUDA if torch.cuda.is_available()
           else ProfilerActivity.CPU)
    with profile(activities=[act]) as prof:
        yield prof


class PhaseLog:
    """``(name, start_ns, end_ns)`` of each wrapped call, on
    ``time.time_ns`` (the clock of the profiler's timeline)."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []

    def wrap(self, fn, name: str):
        def run(*a, **k):
            t = time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                self.spans.append((name, t, time.time_ns()))
        return run


def _device_events(prof) -> List[Tuple[int, int, str]]:
    """The card's activity: kernels, copies, fills (not the annotations
    that the profiler mirrors onto the device's timeline)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        if hasattr(e, "activity_type"):
            if e.activity_type() not in DEVICE_ACTIVITY:
                continue
        elif getattr(e, "is_user_annotation", lambda: False)():
            continue
        a = e.start_ns()
        out.append((a, a + e.duration_ns(), e.name()))
    return out


def summarize(prof, phases: List[Tuple[str, int, int]], top: int = 10
              ) -> Dict:
    """``busy_s``; device seconds by kernel name (``kernel_s``); the
    ``top`` heaviest device ops and the ``top`` host phases by the idle
    time of the card inside them, each as ``[name, seconds]``; the share
    of device time that falls inside a recorded phase
    (``device_in_phases``, a check on the two clocks' alignment)."""
    dev = sorted(_device_events(prof))
    if not dev:
        return {"busy_s": 0.0, "kernel_s": {}, "device_ops": [],
                "idle_gaps": [], "device_in_phases": None}
    by_name: Dict[str, float] = {}
    merged: List[List[int]] = []
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-9
    ph = sorted(phases, key=lambda s: s[1])
    gaps = [((merged[i][1] + merged[i + 1][0]) // 2,
             merged[i + 1][0] - merged[i][1]) for i in range(len(merged) - 1)]
    pts = gaps + [((a + b) // 2, -(b - a)) for a, b in merged]
    pts.sort()
    idle: Dict[str, float] = {}
    inside = 0
    active: List[Tuple[str, int, int]] = []
    j = 0
    for mid, length in pts:
        while j < len(ph) and ph[j][1] <= mid:
            active.append(ph[j])
            j += 1
        active = [s for s in active if s[2] > mid]
        name = active[-1][0] if active else "outside_phases"
        if length >= 0:
            idle[name] = idle.get(name, 0.0) + length * 1e-9
        elif active:
            inside += -length
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "kernel_s": by_name,
            "device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gap_list],
            "device_in_phases": inside * 1e-9 / busy if busy else None}
