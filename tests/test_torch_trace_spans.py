"""The port's trace recorder inside the engine: phase intervals on the
profiler's clock, ``sync`` spans around every host wait, the spans' device
ends, and B/E spans unchanged on an injected clock.

A tiny causal SPLS model runs through ``PagedServingEngine`` with packed
compute on the CPU; one run, with the host's readbacks and blocking copies
stamped as the engine makes them, feeds most tests.  The reference-parity
test imports JAX when it is there; the card's test runs with ``-m cuda``
(``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_trace_spans.py``).
"""

from __future__ import annotations

import itertools
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.models import init_params
from repro_torch.observability import (Telemetry, TraceRecorder,
                                      host_wait, last_recorder, phase)
from repro_torch.serve_batch import demo_config, demo_prompts
from repro_torch.serving import (PagedServingEngine, Request, ServeConfig,
                                 ServingEngine)

try:
    import jax  # noqa: F401
except ImportError:          # the card's machine: only the cuda test runs
    jax = None

CHUNK_PHASES = ("spls.predict", "spls.plan", "chunk.attend", "chunk.ffn")
PAGED = dict(n_slots=2, max_len=96, page_size=8, prefill_chunk=16,
             compute_backend="packed_torch",
             attn_backend="torch_paged_decode")


def _serve(engine_cls, cfg, params, scfg, prompts, device="cpu", max_new=4):
    eng = engine_cls(cfg, params, scfg, device=device)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    eng.run_until_drained(max_ticks=500)
    return eng


class _Waits:
    """Stamps (``time.time_ns``) each call from the engine's module that
    makes the host wait for the card: ``.cpu()``, ``.tolist()``,
    ``int()`` of a tensor, ``.to()`` a device, ``torch.tensor(...,
    device=)``."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("cpu", "tolist", "__int__", "to"):
            monkeypatch.setattr(torch.Tensor, name,
                                self._wrap(getattr(torch.Tensor, name), name))
        monkeypatch.setattr(torch, "tensor", self._wrap(torch.tensor,
                                                        "tensor"))

    def _wrap(self, fn, name):
        def call(*a, **k):
            if sys._getframe(1).f_code.co_filename.endswith(
                    "serving/engine.py"):
                self.calls.append((name, time.time_ns()))
            return fn(*a, **k)
        return call


@pytest.fixture(scope="module")
def spls_cfg():
    cfg = demo_config(True, 0.25, 0.6)
    return cfg, init_params(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def served(spls_cfg):
    """The packed SPLS engine after serving three prompts of three chunks
    each, and the host waits its module made."""
    cfg, params = spls_cfg
    mp = pytest.MonkeyPatch()
    try:
        waits = _Waits(mp)
        eng = _serve(PagedServingEngine, cfg, params, ServeConfig(**PAGED),
                     demo_prompts(3, 40, cfg.vocab_size))
    finally:
        mp.undo()
    return eng, waits.calls


def _spans(events, name):
    """(tid, B wall_ns, E wall_ns) of each ``name`` span."""
    out, open_ = [], {}
    for ev in events:
        if ev["name"] != name:
            continue
        if ev["ph"] == "B":
            open_[ev["tid"]] = ev["wall_ns"]
        elif ev["ph"] == "E":
            out.append((ev["tid"], open_.pop(ev["tid"]), ev["wall_ns"]))
    return out


def test_chunk_phases_per_layer_inside_prefill_chunk(served, spls_cfg):
    eng, _ = served
    cfg, _ = spls_cfg
    tr = eng.telemetry.trace
    tr.validate()
    chunks = _spans(tr.events, "prefill_chunk")
    assert len(chunks) == eng.sched.stats["prefill_chunks"] == 9
    for tid, a, b in chunks:
        inside = [iv for iv in tr.intervals
                  if iv[1] == tid and a <= iv[2] and iv[3] <= b]
        for name in CHUNK_PHASES:
            assert sum(iv[0] == name for iv in inside) == cfg.n_layers, name
        assert sum(iv[0] == "chunk.host" for iv in inside) == 1
    # every chunk-step phase lies inside some chunk step of its track
    for iv in tr.intervals:
        if iv[0] in CHUNK_PHASES + ("chunk.host", "spls.topk"):
            assert any(t == iv[1] and a <= iv[2] and iv[3] <= b
                       for t, a, b in chunks), iv


def test_topk_inside_plan(served, spls_cfg):
    tr = served[0].telemetry.trace
    plans = [iv for iv in tr.intervals if iv[0] == "spls.plan"]
    topks = [iv for iv in tr.intervals if iv[0] == "spls.topk"]
    assert len(topks) == len(plans) > 0
    for iv in topks:
        assert sum(p[1] == iv[1] and p[2] <= iv[2] and iv[3] <= p[3]
                   for p in plans) == 1, iv


def _inside_sync(tr, t: int) -> bool:
    return any(iv[0] == "sync" and iv[2] <= t <= iv[3]
               for iv in tr.intervals)


def test_every_host_wait_of_the_paged_engine_is_a_sync(served):
    eng, calls = served
    tr = eng.telemetry.trace
    ticks = [iv for iv in tr.intervals if iv[0] == "engine.tick"]
    waits = [(n, t) for n, t in calls
             if any(a <= t <= b for _, _, a, b, _ in ticks)]
    assert {n for n, _ in waits} == {"cpu", "tolist", "__int__", "to"}
    for n, t in waits:
        assert _inside_sync(tr, t), n
    labels = {iv[4] for iv in tr.intervals if iv[0] == "sync"}
    assert {"votes", "capacity_counts", "token_pick", "h2d:table",
            "h2d:tokens", "h2d:tables", "h2d:kv_len", "h2d:cur_pos",
            "h2d:keep_slots"} <= labels
    # decode's phases, on the engine track inside the tick
    for name in ("decode.prepare", "decode.forward"):
        ivs = [iv for iv in tr.intervals if iv[0] == name]
        assert ivs and all(iv[1] == 0 for iv in ivs)
        assert len(ivs) == len(_spans(tr.events, "decode_tick"))


def test_every_host_wait_of_the_dense_engine_is_a_sync(monkeypatch):
    cfg = demo_config(False)
    params = init_params(cfg, seed=0, device="cpu")
    waits = _Waits(monkeypatch)
    eng = _serve(ServingEngine, cfg, params,
                 ServeConfig(n_slots=2, max_len=64),
                 demo_prompts(3, 12, cfg.vocab_size))
    monkeypatch.undo()
    tr = eng.telemetry.trace
    tr.validate()
    ticks = [iv for iv in tr.intervals if iv[0] == "engine.tick"]
    waits = [(n, t) for n, t in waits.calls
             if any(a <= t <= b for _, _, a, b, _ in ticks)]
    assert {n for n, _ in waits} == {"tensor", "tolist", "__int__", "to"}
    for n, t in waits:
        assert _inside_sync(tr, t), n


def test_telemetry_off_records_nothing(spls_cfg):
    cfg, params = spls_cfg
    eng = _serve(PagedServingEngine, cfg, params,
                 ServeConfig(**PAGED, telemetry=False),
                 demo_prompts(2, 20, cfg.vocab_size), max_new=2)
    tr = eng.telemetry.trace
    assert tr.events == [] and tr.intervals == [] and tr.dropped == 0
    assert all(r.done for r in eng._retired) and len(eng._retired) == 2


def test_phase_records_only_inside_an_active_tick():
    tr = TraceRecorder()
    with phase("spls.plan"):
        pass
    assert tr.intervals == []
    with tr.activate():
        with phase("spls.plan"):
            with phase("sync", "votes"):
                pass
    with phase("chunk.ffn"):
        pass
    assert [(iv[0], iv[1], iv[4]) for iv in tr.intervals] == [
        ("sync", 0, "votes"), ("spls.plan", 0, None),
        ("engine.tick", 0, None)]
    tr.validate()
    off = TraceRecorder(enabled=False)
    with off.activate():
        with phase("spls.plan"):
            pass
    assert off.intervals == []


def test_the_latest_recorder_outlives_its_engine(spls_cfg):
    """The recorder of the latest engine iteration with telemetry on stays
    readable once its engine is freed; an engine with telemetry off does
    not replace it."""
    import gc
    import weakref
    cfg, params = spls_cfg
    eng = _serve(PagedServingEngine, cfg, params, ServeConfig(**PAGED),
                 demo_prompts(1, 20, cfg.vocab_size), max_new=2)
    tr, gone = eng.telemetry.trace, weakref.ref(eng)
    assert last_recorder() is tr
    del eng
    gc.collect()
    assert gone() is None and last_recorder() is tr
    assert [iv for iv in tr.intervals if iv[0] == "engine.tick"]
    _serve(PagedServingEngine, cfg, params,
           ServeConfig(**PAGED, telemetry=False),
           demo_prompts(1, 20, cfg.vocab_size), max_new=2)
    assert last_recorder() is tr
    off = TraceRecorder(enabled=False)
    with off.activate():
        pass
    assert last_recorder() is tr


def test_phases_follow_the_open_span_while_another_track_unwinds():
    """A preemption of another request inside a span (``grow_to`` in a
    whole-prompt prefill) leaves the span's phases on its own track."""
    tel = Telemetry()
    for rid in (0, 1):
        tel.request_submitted(rid, 8)
        tel.request_admitted(rid)
    tr = tel.trace
    with tr.activate():
        tel.span_begin("full_prefill", rid=0)
        with phase("sync", "h2d:table"):
            pass
        tel.request_preempted(1)
        with phase("sync", "h2d:keep_idx"):
            pass
        tel.span_begin("prune_compact", rid=0)
        tel.request_preempted(1)
        with phase("sync", "h2d:keep_slots"):
            pass
        tel.span_end("prune_compact", rid=0)
        with phase("sync", "h2d:dest_slots"):
            pass
        tel.span_end("full_prefill", rid=0)
        with phase("sync", "token_pick"):
            pass
    track = {iv[4]: iv[1] for iv in tr.intervals if iv[0] == "sync"}
    assert track == {"h2d:table": 1, "h2d:keep_idx": 1, "h2d:keep_slots": 1,
                     "h2d:dest_slots": 1, "token_pick": 0}
    tel.request_retired(0)
    tel.request_retired(1)
    tr.validate()


def test_a_host_wait_resolves_the_marked_span_ends(monkeypatch):
    """Span ends marked on the card wait for the next host wait (the card
    has caught up by then), not for the export."""
    tr = TraceRecorder()
    calls = []
    monkeypatch.setattr(tr, "resolve_device_ends",
                        lambda: (calls.append(len(tr._pending)),
                                 tr._pending.clear()))
    with tr.activate():
        with host_wait("token_pick"):
            pass
        assert calls == []                  # nothing marked yet
        tr._pending.append(("E event", "CUDA event", "device"))
        with phase("chunk.host"):
            pass
        assert calls == []                  # no wait, no resolution
        with host_wait("votes"):
            assert calls == []              # only once the wait is over
        assert calls == [1] and tr._pending == []
    assert [(iv[0], iv[4]) for iv in tr.intervals] == [
        ("sync", "token_pick"), ("chunk.host", None), ("sync", "votes"),
        ("engine.tick", None)]
    with host_wait("votes"):                # no tick under way: a no-op
        pass
    assert len(tr.intervals) == 4


def test_chrome_export_carries_phase_intervals(served, tmp_path):
    import json
    tr = served[0].telemetry.trace
    path = tmp_path / "trace.json"
    tr.write(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    xs = [e for e in ev if e["ph"] == "X"]
    assert len(xs) == len(tr.intervals)
    assert {e["pid"] for e in xs} == {tr.pid + 1}
    first = min(tr.intervals, key=lambda iv: iv[2])
    assert min(e["ts"] for e in xs) == pytest.approx(first[2] / 1e3)
    assert all(e["dur"] >= 0 for e in xs)
    assert {e["args"]["what"] for e in xs if e["name"] == "sync"} == \
        {iv[4] for iv in tr.intervals if iv[0] == "sync"}
    meta = [e for e in ev if e["ph"] == "M"]
    assert meta and meta[0]["pid"] == tr.pid + 1
    # the spans keep the injected clock's seconds, in microseconds
    spans = [e for e in ev if e["ph"] in "BEi"]
    assert [e["ts"] for e in spans] == [e["ts"] * 1e6 for e in tr.events]


def test_overflow_is_counted_in_dropped():
    tr = TraceRecorder(max_events=3)
    for i in range(5):
        tr.begin("s", float(i))
        tr.interval("p", 0, i, i + 1)
    assert len(tr.events) == 3 and len(tr.intervals) == 3
    assert tr.dropped == 4
    assert all("wall_ns" in ev for ev in tr.events)


def test_validate_rejects_overlapping_intervals():
    tr = TraceRecorder()
    tr.interval("outer", 1, 0, 10)
    tr.interval("inner", 1, 2, 5)
    tr.interval("other_track", 2, 5, 20)
    tr.validate()
    tr.interval("straddles", 1, 8, 12)
    with pytest.raises(ValueError, match="overlaps"):
        tr.validate()


def test_spans_on_a_fake_clock_match_the_reference():
    """On a clock that counts its reads, the port's B/E/instant events
    carry the ``ts`` of the reference's engine, read for read: the phases
    read no injected clock."""
    if jax is None:
        pytest.skip("needs the reference JAX package")
    import jax.numpy as jnp
    from _torch_parity import (JEngine, JRequest, JServe, TEngine, TRequest,
                               TServe, demo_pair)

    jc, tc, jp, tp = demo_pair(True, 0.05, 0.9)
    prompts = demo_prompts(3, 40, tc.vocab_size, repeat=16)
    kw = dict(n_slots=2, max_len=64, page_size=8, prefill_chunk=16,
              compute_backend="packed_xla")
    got = []
    for Engine, Req, Serve, cfg, params, extra, conv in (
            (JEngine, JRequest, JServe, jc, jp, {}, jnp.asarray),
            (TEngine, TRequest, TServe, tc, tp, {"device": "cpu"},
             lambda p: p)):
        eng = Engine(cfg, params, Serve(**kw), **extra)
        count = itertools.count()
        fake = lambda: float(next(count))          # noqa: E731
        eng.telemetry.core.clock = eng.telemetry.metrics.clock = fake
        for i, p in enumerate(prompts):
            eng.submit(Req(rid=i, prompt=conv(p), max_new_tokens=4))
        eng.run_until_drained(max_ticks=500)
        got.append([(e["ph"], e["name"], e["tid"], e["ts"])
                    for e in eng.telemetry.trace.events])
    assert len(got[1]) > 40 and got[1] == got[0]


@pytest.mark.cuda
def test_spans_end_with_their_work_on_the_card():
    """Chunked prefill without SPLS returns at enqueue: its span's device
    end, resolved from a CUDA event, lies at or after its host end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = demo_config(False)
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev)
    eng = _serve(PagedServingEngine, cfg, params,
                 ServeConfig(n_slots=2, max_len=96, page_size=8,
                             prefill_chunk=16,
                             attn_backend="torch_paged_decode"),
                 demo_prompts(3, 40, cfg.vocab_size), device=dev)
    tr = eng.telemetry.trace
    ends = [ev for ev in tr.events if ev["ph"] == "E"
            and ev["name"] in ("prefill_chunk", "decode_tick")]
    # the host's waits dated every mark but those after the last wait
    last_wait = max(iv[3] for iv in tr.intervals if iv[0] == "sync")
    later = [ev for ev in tr.events if ev["ph"] == "E"
             and ev["name"] in ("prefill_chunk", "full_prefill",
                                "decode_tick")
             and ev["wall_ns"] >= last_wait]
    assert len(tr._pending) == len(later)
    assert all("device_end_ns" in ev for ev in ends
               if not any(ev is e for e in later))
    chrome = tr.to_chrome_trace()
    assert tr._pending == []
    assert ends and all("device_end_ns" in ev for ev in ends)
    # a CUDA event is reached after it is recorded (the clocks agree to
    # well under a millisecond)
    assert all(ev["device_end_ns"] >= ev["wall_ns"] - 1_000_000
               for ev in ends)
    assert sum("device_end_us" in e.get("args", {})
               for e in chrome["traceEvents"]) == len(ends)
    tr.validate()
