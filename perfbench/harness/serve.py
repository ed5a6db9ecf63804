"""Closed-loop serving through the program's paged engine.

Set-up builds one ``PagedServingEngine`` on the benchmark's weights and
serves the mix's warm-up requests through it.  It then offers the mix's
clients to that same engine, a closed loop in which each client sends its
next request as soon as its last retires, and serves until one wave of
requests has retired; the window opens on that loop, unbroken.  After the
window the harness reads what the engine did in it, frees the engine, and
replays a sample of the requests that finished in the window through the
plain reference.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import controller as ctl_rule
from . import flops as fl
from . import stats, traffic as tr
from .trace import PhaseLog, profiled, summarize

clock = time.monotonic


@dataclasses.dataclass
class Live:
    req: object
    client: int
    spec: tr.RequestSpec
    times: List[float] = dataclasses.field(default_factory=list)


class CapacityLog:
    """What the capacity controllers picked for each SPLS chunk, and every
    pick and observation in order: the reference replays a chunk at the
    program's capacity, and :func:`controller.replay_mismatches` checks
    the picks by themselves.  Wraps the engine's own objects; edits no
    code of the program."""

    def __init__(self, engine):
        self.picks: Dict[tuple, tuple] = {}
        self.events: Dict[str, list] = {}
        self._cur: Dict[str, int] = {}
        for name in ("q", "f"):
            c = getattr(engine, f"_cap_{name}", None)
            if c is None:
                continue
            self.events[name] = []
            c.capacity = self._wrap_pick(name, c.capacity)
            c.observe = self._wrap_obs(name, c.observe)
        if self.events:
            inner = engine._spls_chunk

            def chunk(st, start, *a, **k):
                self._cur = {}
                out = inner(st, start, *a, **k)
                self.picks[(st.req.rid, start)] = (self._cur.get("q"),
                                                   self._cur.get("f"))
                return out
            engine._spls_chunk = chunk

    def _wrap_pick(self, name, fn):
        def capacity():
            v = fn()
            self._cur[name] = v
            self.events[name].append(("pick", v))
            return v
        return capacity

    def _wrap_obs(self, name, fn):
        def observe(n):
            self.events[name].append(("obs", int(n)))
            return fn(n)
        return observe


class DecodeSpy:
    """Traced runs only: each decode tick's live rows (``kv_len + 1``
    slots of every active sequence), kept on the device until the window
    closes; and the tick's span in the phase log."""

    def __init__(self, phases: PhaseLog):
        import repro_torch.serving.engine as mod
        self.mod, self.inner, self.kv = mod, mod.paged_decode_step, []
        inner = phases.wrap(self.inner, "decode_tick")

        def step(cfg, params, cache, pos_pages, tables, kv_len, *a, **k):
            self.kv.append(kv_len)
            return inner(cfg, params, cache, pos_pages, tables, kv_len,
                         *a, **k)
        mod.paged_decode_step = step

    def close(self) -> List[int]:
        self.mod.paged_decode_step = self.inner
        rows = []
        for t in self.kv:
            v = t.cpu().numpy().astype(np.int64)
            rows.extend(int(x) + 1 for x in v if x > 0)
        return rows


def build(cfg: dict, traffic: dict, seed: int, device):
    """The program's engine for this cell, on the benchmark's weights."""
    from repro_torch.serving import PagedServingEngine, ServeConfig

    model = importlib.import_module(f"perfbench.models.{cfg['family']}")
    eng = traffic["engine"]
    arch = model.arch_config(cfg, spls=eng["spls"])
    params = model.make_weights(cfg, tr.seed_int(seed), device)
    scfg = ServeConfig(
        n_slots=eng["n_slots"], max_len=eng["max_len"],
        page_size=eng["page_size"], prefill_chunk=eng["prefill_chunk"],
        compute_backend=eng["compute_backend"],
        attn_backend=eng["attn_backend"],
        spls_prune_vote=eng.get("spls_prune_vote", 0.5),
        capacity_margin=eng.get("capacity_margin", 1.25))
    engine = PagedServingEngine(arch, params, scfg, device=device)
    return params, engine


class ClosedLoop:
    """The mix's clients on one engine: each sends its first request at
    the pre-roll's start and its next one as soon as the last retires.
    :meth:`preroll` serves until one wave (as many requests as clients)
    has retired, in set-up, so the window opens on the loop's steady state
    and not on its first burst of prompts; :meth:`window` then serves on,
    unbroken, for ``seconds``."""

    def __init__(self, engine, streams):
        self.engine, self.streams = engine, streams
        self.lives: Dict[int, Live] = {}
        self.inflight: set = set()
        self._nxt = [0] * len(streams)
        self._rid = 0

    def _submit(self, c: int) -> None:
        from repro_torch.serving import Request
        spec = self.streams[c][self._nxt[c] % len(self.streams[c])]
        self._nxt[c] += 1
        req = Request(rid=self._rid, prompt=spec.prompt,
                      max_new_tokens=spec.output_len)
        self.lives[self._rid] = Live(req, c, spec)
        self.inflight.add(self._rid)
        self._rid += 1
        self.engine.submit(req)

    def _tick(self) -> tuple:
        """One engine tick; stamps each new token; returns the clock after
        it and how many requests retired in it (each client sends its next
        request at once)."""
        self.engine.tick()
        t, retired = clock(), 0
        for r in sorted(self.inflight):
            lv = self.lives[r]
            lv.times.extend([t] * (len(lv.req.output) - len(lv.times)))
            if lv.req.done:
                self.inflight.discard(r)
                retired += 1
                self._submit(lv.client)
        return t, retired

    def preroll(self) -> None:
        for c in range(len(self.streams)):
            self._submit(c)
        retired = 0
        while retired < len(self.streams):
            retired += self._tick()[1]

    def window(self, seconds: float, trace: bool):
        """Returns ``(t0, t1, prof)``."""
        def timed():
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = t = clock()
            while t - t0 < seconds:
                t = self._tick()[0]
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            return t0, clock()

        if not trace:
            return (*timed(), None)
        with profiled() as prof:
            t0, t1 = timed()
        prof.stop_s = clock() - t1
        return t0, t1, prof

    def progress(self) -> Dict[int, tuple]:
        """``(prompt tokens prefilled, tokens served)`` of every request."""
        active = {st.req.rid: st for st in self.engine.sched.active()}
        return {r: (active[r].prefilled if r in active
                    else len(lv.spec.prompt) if lv.req.done else 0,
                    len(lv.req.output)) for r, lv in self.lives.items()}


def dense_done(cfg: dict, prompt_len: int, pre: int, n_out: int) -> float:
    """The dense model's FLOPs for a request that has prefilled ``pre``
    prompt tokens and served ``n_out``: each prompt position over its own
    context; each served token but the last fed back at the next position;
    the LM head for every served token."""
    f = fl.causal_span_flops(cfg, 0, pre)
    if n_out:
        f += fl.causal_span_flops(cfg, prompt_len, prompt_len + n_out - 1) \
            + n_out * fl.head_flops(cfg)
    return f


def window_record(engine, cfg: dict, lives: Dict[int, Live], t0: float,
                  t1: float, flops0: dict, base: Dict[int, tuple],
                  end: Dict[int, tuple]) -> dict:
    """Tokens and FLOPs done in the window (each request's progress at its
    close less that at its opening, ``end`` and ``base``), the gaps between
    a request's tokens, TTFT and the engine's spans (program clock)."""
    tokens, dense, itl, seen = 0, 0.0, [], []
    for r, lv in lives.items():
        p0, o0 = base.get(r, (0, 0))
        p1, o1 = end[r]
        if lv.req.done and lv.times and lv.times[-1] < t0:
            continue                      # retired before the window
        seen.append(lv)
        lp = len(lv.spec.prompt)
        tokens += (p1 - p0) + (o1 - o0)
        dense += dense_done(cfg, lp, p1, o1) - dense_done(cfg, lp, p0, o0)
        itl += stats.gaps_in_window(lv.times, t0, t1)
    tel = engine.telemetry
    ttft = [rec.ttft_s for rec in tel.requests.values()
            if rec.rid in lives and rec.first_token_ts is not None
            and t0 - 1e-9 <= rec.first_token_ts <= t1 + 1e-9]
    spans: Dict[str, List[float]] = {}
    open_: Dict[tuple, float] = {}
    for ev in tel.trace.events:
        key = (ev["tid"], ev["name"])
        if ev["ph"] == "B":
            open_[key] = ev["ts"]
        elif ev["ph"] == "E" and key in open_:
            a = open_.pop(key)
            if a >= t0 and ev["ts"] <= t1:
                spans.setdefault(ev["name"], []).append(ev["ts"] - a)
    flops1 = {c: tuple(v) for c, v in engine.sched.flops.items()}
    diff = {c: (flops1[c][0] - flops0.get(c, (0.0, 0.0))[0],
                flops1[c][1] - flops0.get(c, (0.0, 0.0))[1])
            for c in flops1}
    return {"tokens": tokens, "dense_flops": dense, "itl_s": itl,
            "ttft_s": ttft, "spans": spans, "flops": diff,
            "attempted": len(seen),
            # retired short of its budget: aborted by the scheduler
            "failed": sum(1 for lv in seen if lv.req.done
                          and len(lv.req.output) < lv.spec.output_len)}


def sample_finished(lives: Dict[int, Live], t0: float, t1: float, n: int,
                    seed: int) -> List[Live]:
    """``n`` requests that finished in the window, drawn from the seed,
    the longest (prompt and served tokens) always among them."""
    done = [lv for lv in lives.values() if lv.req.done and lv.times
            and t0 <= lv.times[-1] <= t1]
    if not done:
        return []
    size = lambda lv: len(lv.spec.prompt) + len(lv.req.output)
    longest = max(done, key=size)
    rest = [lv for lv in done if lv is not longest]
    rng = np.random.default_rng(tr.seed_int(seed) ^ 0xC0FFEE)
    pick = rng.permutation(len(rest))[:max(0, n - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, limits: dict, t_start: float, check_fn=None) -> dict:
    """One run of a serving cell: set-up, window, the reading of it, the
    check (``check_fn``, by default :func:`check`).  Returns the pieces of
    the result line."""
    params, engine = build(cfg, traffic, seed, device)
    caps = CapacityLog(engine)
    vocab = cfg["vocab_size"]
    from repro_torch.serving import Request
    for i, spec in enumerate(tr.warmup_requests(traffic, vocab, seed)):
        engine.submit(Request(rid=-1 - i, prompt=spec.prompt,
                              max_new_tokens=spec.output_len))
    engine.run_until_drained()
    loop = ClosedLoop(engine, tr.client_streams(traffic, vocab, seed))
    loop.preroll()
    spy = phases = None
    if trace:
        def sync():
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            return clock()
        engine.telemetry.core.clock = sync
        engine.telemetry.metrics.clock = sync
        phases = PhaseLog()
        spy = DecodeSpy(phases)
        for m, name in (("tick", "engine.tick"),
                        ("_chunk_prefill", "prefill_chunk"),
                        ("_full_prefill", "full_prefill"),
                        ("_finish_chunk_prune", "prune_compact")):
            setattr(engine, m, phases.wrap(getattr(engine, m), name))
    flops0 = {c: tuple(v) for c, v in engine.sched.flops.items()}
    base = loop.progress()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    setup_s = clock() - t_start
    t0, t1, prof = loop.window(seconds, trace)
    lives = loop.lives
    rec = window_record(engine, cfg, lives, t0, t1, flops0, base,
                        loop.progress())
    rec.update(window_s=t1 - t0, setup_s=setup_s, cfg=cfg, traffic=traffic)
    if trace:
        rows = spy.close()
        t = clock()
        s = summarize(prof, phases.spans)
        s["profiler_stop_s"], s["reading_s"] = prof.stop_s, clock() - t
        kern = sum(v for k, v in s["kernel_s"].items()
                   if "paged_decode_kernel" in k)
        s["paged_decode"] = {"device_s": kern,
                             "bytes": fl.paged_decode_bytes(cfg, rows)}
        rec["trace"] = s
    rec["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if torch.cuda.is_available() else 0)

    # the check, once the program's state is freed
    eng = traffic["engine"]
    cs = eng["prefill_chunk"]
    replays = [(list(map(int, lv.spec.prompt)), list(lv.req.output),
                [caps.picks.get((lv.req.rid, s0))
                 for s0 in range(0, len(lv.spec.prompt), cs)])
               for lv in sample_finished(lives, t0, t1,
                                         traffic["check"]["requests"], seed)]
    events = caps.events
    del engine, loop, lives, caps, prof, spy
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    rec["check"] = (check_fn or check)(cfg, params, replays, eng, events,
                                       limits, device)
    return rec


# a served token within this of the reference's best is its best up to
# float32 rounding (the reference's logits differ from the program's by
# about 1e-5 where their plans agree)
TOKEN_OFF = 1e-3


def reference_gaps(cfg: dict, params: dict, replays, eng: dict, device,
                   control: Optional[str] = None) -> List[List[float]]:
    """Per replayed request, how far the judged token's logit lies below
    the float32 reference's best at each served position.  Judged are the
    program's served tokens or, with ``control`` (a precision), the tokens
    that the reference in that precision, put in the program's place,
    puts first there."""
    from perfbench.reference.qwen3 import Qwen3, served_gaps

    cs, ps = eng["prefill_chunk"], eng["page_size"]
    kw = dict(chunk=cs, spls=eng["spls"],
              prune_vote=eng.get("spls_prune_vote", 0.5), device=device,
              slots=-(-eng["max_len"] // ps) * ps)
    ref = Qwen3(cfg, params)
    ctl = Qwen3(cfg, params, control) if control else None
    out = []
    for prompt, served, caps in replays:
        caps = [(c[0] or cs, c[1] or cs) if c else (cs, cs) for c in caps]
        logits, _ = ref.serve_logits(prompt, served, caps=caps, **kw)
        tok = served
        if ctl is not None:
            lc, _ = ctl.serve_logits(prompt, served, caps=caps, **kw)
            tok = lc.argmax(-1).tolist()
        out.append(served_gaps(logits, tok))
    return out


def gap_numbers(readings: List[List[float]]) -> dict:
    """The numbers a cell may compare: ``served_gap``, the widest gap;
    ``tokens_off_pct``, the share of served tokens more than ``TOKEN_OFF``
    below the reference's best."""
    gaps = [g for r in readings for g in r]
    return {"served_gap": max(gaps),
            "tokens_off_pct": 100.0 * sum(g > TOKEN_OFF for g in gaps)
            / len(gaps)}


def check(cfg, params, replays, eng: dict, events, limits, device) -> dict:
    """Each number compared, beside its limit (at most, unless
    ``at_least``): those that the cell's limits file names."""
    cs = eng["prefill_chunk"]
    out = {"requests_checked": {"value": len(replays), "limit": 1,
                                "at_least": True}}
    if events:
        margin = eng.get("capacity_margin", 1.25)
        out["capacity_picks_off_rule"] = {
            "value": sum(ctl_rule.replay_mismatches(ev, cs, margin=margin)
                         for ev in events.values()), "limit": 0}
    if replays:
        got = gap_numbers(reference_gaps(cfg, params, replays, eng, device))
        for name, v in got.items():
            if name in limits:
                out[name] = {"value": v, "limit": limits[name]}
    return out
