"""The program's own spans as the benchmark reads them
(``perfbench/harness/program_trace.py``): on a tiny traced rehearsal, on
a hand timeline, and against ``summarize``'s rule on a random one."""

import io
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench.harness import program_trace
from perfbench.harness.trace import summarize
from perfbench.tests._tiny import ROOT, rehearse

NEW = ("spls.plan_ms", "chunk.compute_ms", "engine.sync_wait_ms")


def _metric(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), ROOT / "perfbench/metrics" /
        f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_traced_tiny_cell_reads_program_spans(monkeypatch):
    """After a run has freed its engine, the readers find the program's
    spans through its latest recorder, over the run's window; a program
    without that recorder gives nothing, and raises nothing."""
    rec = rehearse("qwen3-0.6b.spls_prefill_heavy", trace=True, seconds=4.0)
    p = program_trace.from_record(rec)
    assert p["dropped"] == 0 and p["events"] > 0 and p["intervals"] > 0
    assert p["chunk_steps"] > 0 and p["ticks"] >= p["chunk_steps"]
    for name in NEW:
        assert _metric(name)(rec) > 0, name
    assert 0.8 < p["child_cover_median"] <= 1.0
    # the window's chunk steps, as the engine's span clock counts them
    assert p["chunk_steps"] == len(rec["spans"]["prefill_chunk"])
    assert program_trace.from_record(rec) is p          # read once

    import repro_torch.observability.trace as trace_mod
    monkeypatch.delattr(trace_mod, "last_recorder")
    for name in NEW:
        assert _metric(name)(dict(rec)) is None
    monkeypatch.undo()
    monkeypatch.setattr(trace_mod, "_LAST", None)
    for name in NEW:
        assert _metric(name)(dict(rec)) is None


class _KinetoEvent:
    def __init__(self, kind, cuda, corr, start_ns, dur_ms=0.0, name="op"):
        self._k, self._c, self._n = kind, corr, name
        self._d = (torch.autograd.DeviceType.CUDA if cuda
                   else torch.autograd.DeviceType.CPU)
        self._a, self._dur = start_ns, int(dur_ms * 1e6)

    def activity_type(self):
        return self._k

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._dur

    def name(self):
        return self._n


def _profile(kin):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: kin)))


def test_program_trace_attributes_launches_and_idle_gaps():
    """A hand timeline (ms from ``base``): one chunk step and one decode
    tick in one engine iteration, six launches correlated with their
    kernels and copies."""
    base = time.time_ns() // 10 ** 6 * 10 ** 6
    ms = lambda x: base + int(x * 1e6)
    ev = lambda ph, name, tid, x: {"ph": ph, "name": name, "tid": tid,
                                   "ts": 0.0, "wall_ns": ms(x)}
    events = [ev("B", "request", 1, 1), ev("B", "prefill_chunk", 1, 12),
              ev("E", "prefill_chunk", 1, 50), ev("B", "decode_tick", 0, 51),
              ev("E", "decode_tick", 0, 58)]
    ivs = [(n, tid, ms(a), ms(b), lab) for n, tid, a, b, lab in (
        ("spls.predict", 1, 13, 15, None), ("spls.topk", 1, 16, 24, None),
        ("spls.plan", 1, 15, 25, None), ("chunk.attend", 1, 25, 35, None),
        ("chunk.ffn", 1, 35, 45, None), ("sync", 1, 46, 48, "votes"),
        ("chunk.host", 1, 45, 49, None), ("decode.prepare", 0, 51, 52,
                                          None),
        ("sync", 0, 51.2, 51.8, "h2d:tables"),
        ("decode.forward", 0, 52, 57, None),
        ("engine.tick", 0, 10, 60, None))]
    kin = []
    for corr, launch, start, dur, kind in (
            (1, 14, 20, 2, "kernel"), (2, 17, 26, 1, "kernel"),
            (3, 30, 40, 3, "kernel"), (4, 53, 55, 1, "kernel"),
            (5, 5, 6, 1, "gpu_memcpy"), (6, 65, 70, 1, "gpu_memset")):
        kin.append(_KinetoEvent("cuda_runtime", False, corr, ms(launch)))
        kin.append(_KinetoEvent(kind, True, corr, ms(start), dur))
    kin.append(_KinetoEvent("cpu_op", False, 0, ms(14)))
    trace = SimpleNamespace(events=events, intervals=ivs, dropped=0)
    out = io.StringIO()
    p = program_trace.read(trace, _profile(kin), ms(0), ms(100), out=out)
    assert p["chunk_steps"] == 1 and p["ticks"] == 1
    assert p["plan_ms"] == pytest.approx(12.0)
    assert p["compute_ms"] == pytest.approx(20.0)
    assert p["sync_wait_ms"] == pytest.approx(2.6)
    assert p["plan_device_ms"] == pytest.approx(3.0)
    assert p["launches"] == 3
    assert p["child_cover_median"] == pytest.approx(36 / 38)
    rows = {k: (idle, dev) for k, idle, dev in p["idle_by_span"]}
    want = {"spls.predict": (0.013, 0.002), "spls.plan": (0.004, 0.0),
            "chunk.attend": (0.013, 0.003),
            "prefill_chunk": (0.012, 0.0), "outside_phases": (0.014, 0.002)}
    for k, (idle, dev) in want.items():
        assert rows[k] == pytest.approx((idle, dev), abs=1e-9), k
    assert p["idle_outside_share"] == pytest.approx(0.25)
    assert "spls.topk" in out.getvalue()            # its 1 ms launched
    # without the profile: the host numbers alone, and no table
    host = program_trace.read(trace, None, ms(0), ms(100), out=out)
    assert host == {k: v for k, v in p.items() if k in host}
    assert "launches" not in host and "idle_by_span" not in host
    # the window read from a run's record: the window_s seconds that end
    # with the last engine iteration (here 60 ms, from 10 ms: all of it)
    program_trace._READ[:] = [None, None]
    import repro_torch.observability.trace as trace_mod
    saved = trace_mod._LAST
    try:
        trace_mod._LAST = trace
        assert program_trace.from_record({"window_s": 0.05}) == host
        program_trace._READ[:] = [None, None]
        short = program_trace.from_record({"window_s": 0.049})
        assert short["ticks"] == 0 and short["chunk_steps"] == 1
    finally:
        trace_mod._LAST = saved
        program_trace._READ[:] = [None, None]
    # a program older than the phase intervals gives nothing
    old = SimpleNamespace(events=events, dropped=0)
    assert program_trace.read(old, _profile(kin), ms(0), ms(100),
                              out=out) == {}


def test_program_trace_idle_and_launches_follow_summarize_rule():
    """On a random timeline -- nested, overlapping and disjoint phases,
    kernels that overlap, touch and stand apart -- the arrays give
    ``summarize``'s idle seconds by phase, and each launch the phase a
    sweep over the phases finds."""
    rng = np.random.default_rng(7)
    phases = []
    for _ in range(300):
        a = int(rng.integers(0, 10 ** 6))
        phases.append((f"p{rng.integers(0, 6)}", a,
                       a + int(rng.integers(1, 40_000))))
    phases.sort(key=lambda p: (p[1], -p[2]))
    kin = []
    t = 0
    for corr in range(1, 3001):
        t = max(0, t + int(rng.choice([-200, 0, 1, 50, 300])))
        dur = int(rng.integers(1, 400))
        kin.append(_KinetoEvent("cuda_runtime", False, corr,
                                max(0, t - int(rng.integers(1, 900)))))
        kin.append(_KinetoEvent("kernel", True, corr, t, dur * 1e-6))
        t += dur
    prof = _profile(kin)
    want = dict(summarize(prof, phases, top=10 ** 6)["idle_gaps"])

    ph = program_trace.Phases(phases)
    work = program_trace.device_work(prof)
    mid, length = program_trace.idle_gaps(work["start_ns"], work["dur_ns"])
    got = {k: v * 1e-9 for k, v in
           ph.by_name(ph.innermost(mid), length).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k

    def sweep(x):
        open_ = [i for i, (_, a, b) in enumerate(ph_sorted) if a <= x < b]
        return ph_sorted[open_[-1]][0] if open_ else "outside_phases"

    ph_sorted = sorted(phases, key=lambda p: p[1])
    assert (work["launch_ns"] >= 0).all()
    at = ph.innermost(work["launch_ns"])
    names = ["outside_phases" if i < 0 else ph.names[i] for i in at]
    assert names == [sweep(x) for x in work["launch_ns"].tolist()]
