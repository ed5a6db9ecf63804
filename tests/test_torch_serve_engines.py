"""The port's PagedServingEngine against the reference's on the serving
configurations of the reference's ``serve_batch`` CI jobs
(``.github/workflows/ci.yml``), at their own sizes, on the ``serve-demo``
model (4 x 128, 8 heads, 4 KV heads) with bridged weights and the same
numpy prompts: chunked serving without SPLS, SPLS on dense compute
(whole-prompt and chunked), SPLS with packed compute, ``vote_horizon`` 1
with the packed K/V projection, the telemetry job's tight knobs, plus SPLS
without page pruning and ``vote_horizon`` 2 and 1 without the K/V pack.
Greedy tokens, pool and scheduler outcomes, FLOPs saved, every capacity
controller's picks and the horizon counters must be equal."""

from __future__ import annotations

import dataclasses

import pytest

from repro.serving import (PagedServingEngine as JEngine,
                           ServeConfig as JServe)
from repro_torch.serve_batch import demo_prompts
from repro_torch.serving import (PagedServingEngine as TEngine,
                                 ServeConfig as TServe)

from _torch_parity import demo_pair, serve_both

# (id, spls, prompt_len, requests, ServeConfig fields, k_ratio,
#  s_threshold, prompt_repeat); ci.yml lines in the ids' comments
CASES = [
    # :39-45 paged serving smoke: no SPLS, chunk 8
    ("nospls_chunked", False, 20, 4, dict(page_size=4, prefill_chunk=8),
     0.25, 0.6, None),
    # :46-52 SPLS on the default dense compute; prompts of one chunk
    # prefill whole (both forward sites pinned to the flash semantics:
    # the reference's "auto" on a CPU is xla_dense, the port's torch_flash)
    ("spls_dense_whole", True, 16, 3, dict(page_size=4), 0.25, 0.6, None),
    # :53-59 long prompts, SPLS chunked on dense compute
    ("spls_dense_chunked", True, 96, 3, dict(page_size=8, prefill_chunk=16),
     0.25, 0.6, None),
    # :80-86 packed compute
    ("spls_packed", True, 96, 3, dict(page_size=8, prefill_chunk=16,
                                      compute_backend="packed_xla"),
     0.25, 0.9, None),
    # :108-116 vote_horizon 1 with the packed K/V projection
    ("horizon1_packed", True, 96, 3,
     dict(page_size=8, prefill_chunk=16, compute_backend="packed_xla",
          vote_horizon=1, spls_prune_vote=1.0), 0.05, 0.9, None),
    # :136-149 the telemetry job's knobs
    ("horizon1_telemetry", True, 96, 3,
     dict(page_size=8, prefill_chunk=16, compute_backend="packed_xla",
          vote_horizon=1, spls_prune_vote=1.0, capacity_margin=1.0),
     0.05, 0.9, 16),
    # beyond ci.yml: SPLS without page pruning; finite horizons without the
    # K/V pack (2 on packed compute, 1 on dense compute)
    ("spls_no_prune", True, 96, 3, dict(page_size=8, prefill_chunk=16,
                                        spls_page_prune=False),
     0.25, 0.6, None),
    ("horizon2_packed", True, 96, 3,
     dict(page_size=8, prefill_chunk=16, compute_backend="packed_xla",
          vote_horizon=2, spls_prune_vote=1.0), 0.05, 0.9, 16),
    ("horizon1_dense", True, 48, 3, dict(page_size=8, prefill_chunk=16,
                                         vote_horizon=1, spls_prune_vote=1.0),
     0.05, 0.9, None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_engine_matches_reference_on_serve_batch_config(case):
    name, spls, lp, n_req, fields, k_ratio, s_thr, repeat = case
    jc, tc, jp, tp = demo_pair(spls, k_ratio, s_thr)
    if name == "spls_dense_whole":
        jc = dataclasses.replace(jc, attn_backend="pallas_flash")
        tc = dataclasses.replace(tc, attn_backend="torch_flash")
    prompts = demo_prompts(n_req, lp, tc.vocab_size, repeat)
    kw = dict(n_slots=2, max_len=lp + 4 + 8, **fields)
    (jeng, jout), (teng, tout) = serve_both(jc, tc, jp, tp, prompts, kw)
    assert tout == jout
    js, ts = jeng.stats, teng.stats
    for key in ("peak_pages", "preemptions", "prefill_chunks", "retired",
                "admitted", "aborted"):
        assert ts[key] == js[key], key
    assert ts["flops_saved_pct"].keys() == js["flops_saved_pct"].keys()
    for c, v in js["flops_saved_pct"].items():
        assert ts["flops_saved_pct"][c] == pytest.approx(v, abs=1e-9), c
    caps = [k for k in js if k.startswith("capacity_")]
    assert caps == [k for k in ts if k.startswith("capacity_")]
    for cap in caps:
        assert ts[cap]["picks"] == js[cap]["picks"], cap
        assert ts[cap]["overflows"] == js[cap]["overflows"], cap
    jm, tm = jeng.telemetry.metrics, teng.telemetry.metrics
    for m in ("spls/horizon_finalized_cols",
              "spls/horizon_kv_capacity_drops"):
        a, b = jm.get(m), tm.get(m)
        assert (a is None) == (b is None), m
        if a is not None:
            assert b.value == a.value, m

    # what each case is there to exercise
    fs = ts["flops_saved_pct"]
    if name == "spls_dense_whole":
        assert ts["prefill_chunks"] == 0
    elif name.startswith("horizon"):
        assert tm.get("spls/horizon_finalized_cols").value > 0
    if name.startswith("horizon1_packed") or name == "horizon1_telemetry":
        assert "capacity_kv" in ts and fs["kv"] > 0
    if name == "horizon1_telemetry":
        assert min(fs.values()) > 0      # all four shares, as ci.yml asks
    if "dense" in name or name in ("nospls_chunked", "spls_no_prune"):
        assert ts["compute_backend"] == "dense"
        assert max(fs.values()) == 0


def test_vote_horizon_validation_matches_reference():
    """The reference's ``ValueError``s: a horizon below 1, and a horizon
    without SPLS page pruning (SPLS off, or ``spls_page_prune=False``)."""
    jc, tc, jp, tp = demo_pair(True, 0.25, 0.6)
    jn, tn, jpn, tpn = demo_pair(False, 0.25, 0.6)
    bad = [(jc, tc, jp, tp, dict(vote_horizon=0)),
           (jn, tn, jpn, tpn, dict(vote_horizon=1)),
           (jc, tc, jp, tp, dict(vote_horizon=2, spls_page_prune=False))]
    for a, b, pa, pb, kw in bad:
        with pytest.raises(ValueError, match="vote_horizon"):
            JEngine(a, pa, JServe(**kw))
        with pytest.raises(ValueError, match="vote_horizon"):
            TEngine(b, pb, TServe(**kw), device="cpu")
