"""The port's PagedServingEngine against the reference's on bridged
weights: equal greedy tokens and equal scheduler outcomes (peak pages,
preemptions, prefill chunks, FLOPs saved), with random and repeated-token
prompts over several chunks, under a pool small enough to preempt, and for
a non-causal model (whole-prompt prefill).
Also: entry points refuse to guess a device, invalid configurations raise
as in the reference, and the port imports neither jax nor repro."""

from __future__ import annotations

import ast
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in every parity test)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import (PagedServingEngine as JEngine, Request as JRequest,
                           ServeConfig as JServe)
from repro_torch.serving import (PagedServingEngine as TEngine,
                                 Request as TRequest, ServeConfig as TServe)

from _torch_parity import cfg_pair, params_pair

ROOT = Path(__file__).resolve().parents[1]


def _prompts(vocab, lens, seed, repeat=0):
    r = np.random.default_rng(seed)
    out = []
    for i, L in enumerate(lens):
        if repeat and i % 2:
            out.append(np.repeat(r.integers(0, vocab, L // repeat + 1),
                                 repeat)[:L])
        else:
            out.append(r.integers(0, vocab, L))
    return [p.astype(np.int32) for p in out]


def _serve(kind, prompts, max_new, **scfg_kw):
    jc, tc = cfg_pair(kind)
    jp, tp = params_pair(jc)
    kw = dict(attn_backend="xla_paged_decode", compute_backend="packed_xla")
    kw.update(scfg_kw)
    jeng = JEngine(jc, jp, JServe(**kw))
    teng = TEngine(tc, tp, TServe(**kw), device="cpu")
    jreqs = [JRequest(rid=i, prompt=jnp.asarray(p), max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    treqs = [TRequest(rid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained(max_ticks=3000)
        assert all(r.done for r in reqs)
    return jeng, teng, jreqs, treqs


def _assert_same(jeng, teng, jreqs, treqs):
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for key in ("peak_pages", "preemptions", "prefill_chunks", "retired",
                "admitted", "aborted"):
        assert teng.stats[key] == jeng.stats[key], key
    js, ts = jeng.stats["flops_saved_pct"], teng.stats["flops_saved_pct"]
    assert ts.keys() == js.keys()
    for c in js:
        assert ts[c] == pytest.approx(js[c], abs=1e-9), c
    for cap in ("capacity_q", "capacity_ffn"):
        assert teng.stats[cap]["picks"] == jeng.stats[cap]["picks"], cap


@pytest.mark.parametrize("kind", ["mha", "gqa_qknorm"])
def test_engine_matches_reference(kind):
    """Random and repeated-token prompts, chunk 16 over up to 3 chunks,
    adaptive capacity buckets (the repeated prompts shrink them)."""
    jc, _ = cfg_pair(kind)
    prompts = _prompts(jc.vocab_size, (40, 36, 20, 44), seed=1, repeat=4)
    out = _serve(kind, prompts, 5, n_slots=3, max_len=64, page_size=4,
                 prefill_chunk=16, capacity_margin=1.0)
    _assert_same(*out)
    teng = out[1]
    assert teng.stats["flops_saved_pct"]["ffn"] > 0.0
    assert teng.stats["compute_backend"] == "packed_torch"


def test_engine_matches_reference_under_preemption():
    """A pool of 13 allocatable pages cannot hold three growing sequences:
    the youngest is preempted and recomputed, identically in both."""
    jc, _ = cfg_pair("gqa_window_softcap")
    prompts = _prompts(jc.vocab_size, (24, 20, 28), seed=2)
    out = _serve("gqa_window_softcap", prompts, 10, n_slots=3, max_len=48,
                 page_size=4, n_pages=14, prefill_chunk=8)
    _assert_same(*out)
    assert out[1].stats["preemptions"] > 0


def test_non_causal_engine_matches_reference():
    """The paper's non-causal encoder: whole-prompt SPLS prefill through
    the flash backends, the layer-0 prune vote into the pool, paged decode;
    any compute backend is accepted (the whole-prompt path never uses
    one)."""
    jc, tc = cfg_pair("mha", spls=dict(causal=False), causal=False)
    jp, tp = params_pair(jc)
    TEngine(tc, tp, TServe(compute_backend="dense"), device="cpu")
    prompts = _prompts(jc.vocab_size, (20, 12, 20, 12), seed=3, repeat=4)
    kw = dict(n_slots=2, max_len=40, page_size=4, n_pages=17,
              attn_backend="pallas_flash", compute_backend="packed_xla")
    jeng = JEngine(jc, jp, JServe(**kw))
    teng = TEngine(tc, tp, TServe(**kw), device="cpu")
    jreqs = [JRequest(rid=i, prompt=jnp.asarray(p), max_new_tokens=5)
             for i, p in enumerate(prompts)]
    treqs = [TRequest(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained(max_ticks=500)
        assert all(r.done for r in reqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for key in ("peak_pages", "preemptions", "prefill_chunks", "retired",
                "admitted"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["prefill_chunks"] == 0          # every prompt whole


def test_default_device_is_the_card():
    jc, tc = cfg_pair("mha")
    _, tp = params_pair(jc)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(tc, tp, TServe())


@pytest.mark.parametrize("change,error,match", [
    (dict(vote_horizon=0), ValueError, "vote_horizon must be >= 1"),
    (dict(vote_horizon=1, spls_page_prune=False), ValueError,
     "vote_horizon requires SPLS"),
])
def test_unported_configurations_raise(change, error, match):
    """The vote horizon refuses what the reference refuses (a horizon
    below 1, a horizon without page pruning)."""
    jc, tc = cfg_pair("mha")
    _, tp = params_pair(jc)
    with pytest.raises(error, match=match):
        TEngine(tc, tp, TServe(**change), device="cpu")


def test_submit_validates_prompts():
    jc, tc = cfg_pair("mha")
    _, tp = params_pair(jc)
    eng = TEngine(tc, tp, TServe(max_len=32, page_size=4, prefill_chunk=8,
                                 compute_backend="auto"), device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        eng.submit(TRequest(rid=0, prompt=[1, 2, tc.vocab_size]))
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(TRequest(rid=1, prompt=np.zeros(40, np.int32)))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
