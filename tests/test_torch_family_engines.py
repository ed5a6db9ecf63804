"""Greedy tokens of the reference's serving engines and the port's, on
bridged weights and the same prompts, for the attention-only families at
their smoke form (float32): dense GQA with qk-norm (qwen3) and MoE
(olmoe), through the dense fixed-slot engine and the paged engine, SPLS on
and off (SPLS on both simulation-mode and packed compute).  Tokens exact;
the paged engines' pool and scheduler outcomes and FLOPs saved equal.  (Mamba2 and the hybrid: ``test_torch_family_engines_ssm.py``.)

The dense engines name the flash backends (``pallas_flash``, an alias in
the port): the two packages' ``"auto"`` differ on a CPU
(``repro_torch.models.attn_backend``).
"""

from __future__ import annotations

import pytest

from _torch_parity import (LAUNCH_SPLS, arch_pair, dense_engines_agree,
                           family_prompts, params_pair, serve_both)


@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "olmoe-1b-7b"])
@pytest.mark.parametrize("spls", [False, True])
def test_dense_engine_matches_reference(arch_id, spls):
    dense_engines_agree(arch_id, spls)


@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "olmoe-1b-7b"])
@pytest.mark.parametrize("spls,compute", [(False, "dense"), (True, "dense"),
                                          (True, "packed_xla")])
def test_paged_engine_matches_reference(arch_id, spls, compute):
    """Chunked prefill (chunk 8, pages of 4) between decode ticks; the MoE
    FFN runs in the chunk step and the decode tick at their own
    capacities; with SPLS, the chunk plans and the prune vote, on
    simulation-mode and packed compute (an MoE block keeps its routing
    in place of the packed FFN, as the reference's does)."""
    jc, tc = arch_pair(arch_id, spls=LAUNCH_SPLS if spls else None)
    jp, tp = params_pair(jc, jit=True)
    kw = dict(n_slots=2, max_len=32, page_size=4, prefill_chunk=8,
              compute_backend=compute)
    prompts = family_prompts(jc.vocab_size)
    (jeng, jout), (teng, tout) = serve_both(jc, tc, jp, tp, prompts, kw)
    assert tout == jout
    js, ts = jeng.stats, teng.stats
    for key in ("peak_pages", "preemptions", "prefill_chunks", "retired"):
        assert ts[key] == js[key], key
    assert ts["prefill_chunks"] > 0
    # the reference's backend names are aliases of the port's
    assert ts["compute_backend"] == {"dense": "dense",
                                     "packed_xla": "packed_torch"}[compute]
    for c, v in js["flops_saved_pct"].items():
        assert ts["flops_saved_pct"][c] == pytest.approx(v, abs=1e-9), c

