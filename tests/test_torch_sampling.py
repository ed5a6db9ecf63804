"""Temperature sampling of the port's engines: ``_sample_tokens`` against
``softmax(logits / T)`` by frequency, and the reference test's properties
on both engines (``tests/test_serving_paged.py``'s
``test_temperature_sampling``).  JAX's PRNG cannot be reproduced in torch,
so sampled tokens are held by their distribution, not by equality;
``greedy=False`` at T 0 is the argmax, and there the tokens equal the
reference's exactly.

Tolerances: total-variation distance 0.02 between 20000 draws and the
softmax; tokens exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import Request as JRequest, ServeConfig as JServe
from repro.serving import ServingEngine as JDenseEngine
from repro_torch.serving import (PagedServingEngine, Request, ServeConfig,
                                 ServingEngine)
from repro_torch.serving.engine import _sample_tokens

from _torch_parity import cfg_pair, params_pair, serve_both

ROW = torch.tensor([2.0, 1.5, 0.3, -0.4, 1.0, -2.0, 0.0, 0.8])


@pytest.mark.parametrize("temperature", [0.0, -1.0, 0.7])
def test_greedy_or_cold_is_argmax(temperature):
    logits = torch.randn((5, 3, 40), generator=torch.Generator()
                         .manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    greedy = _sample_tokens(logits, True, temperature, gen)
    assert torch.equal(greedy, logits.argmax(-1))
    if temperature <= 0:
        assert torch.equal(_sample_tokens(logits, False, temperature, gen),
                           greedy)


@pytest.mark.parametrize("temperature", [0.7, 2.0])
def test_draws_follow_the_softmax(temperature):
    """20000 draws of one row in one batched call."""
    gen = torch.Generator().manual_seed(1)
    draws = _sample_tokens(ROW.expand(20000, 8), False, temperature, gen)
    freq = torch.bincount(draws, minlength=8).double() / 20000
    p = torch.softmax(ROW.double() / temperature, -1)
    assert 0.5 * float((freq - p).abs().sum()) < 0.02
    assert _sample_tokens(ROW, False, temperature, gen).shape == ()


def _run(Engine, greedy, temperature, seed):
    jc, tc = cfg_pair("mha")
    _, tp = params_pair(jc)
    eng = Engine(tc, tp, ServeConfig(n_slots=2, max_len=48, page_size=4,
                                     greedy=greedy, temperature=temperature,
                                     seed=seed), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, tc.vocab_size, 10)
                    .astype(np.int32), max_new_tokens=12) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("Engine", [ServingEngine, PagedServingEngine])
def test_temperature_sampling(Engine):
    """Seeded draws repeat, another seed draws others, hot sampling leaves
    the argmax, and greedy ignores the seed."""
    greedy = _run(Engine, True, 1.0, 0)
    s0 = _run(Engine, False, 8.0, 0)
    assert s0 == _run(Engine, False, 8.0, 0)
    assert s0 != _run(Engine, False, 8.0, 1)
    assert s0 != greedy
    assert _run(Engine, True, 8.0, 7) == greedy


def test_cold_sampling_equals_reference_paged():
    """``greedy=False`` at T 0, the paged engine with SPLS: the reference's
    tokens."""
    jc, tc = cfg_pair("mha")
    jp, tp = params_pair(jc)
    prompts = [np.random.default_rng(2).integers(0, jc.vocab_size, L)
               .astype(np.int32) for L in (20, 14, 20)]
    (_, jout), (_, tout) = serve_both(
        jc, tc, jp, tp, prompts, dict(
            n_slots=2, max_len=32, page_size=4, prefill_chunk=8,
            greedy=False, temperature=0.0, seed=3,
            attn_backend="xla_paged_decode", compute_backend="packed_xla"))
    assert tout == jout


def test_cold_sampling_equals_reference_dense():
    """``greedy=False`` at T 0, the dense engine: the reference's
    tokens."""
    jc, tc = cfg_pair("gqa_window_softcap")
    jp, tp = params_pair(jc)
    kw = dict(n_slots=2, max_len=32, attn_backend="pallas_flash",
              greedy=False, temperature=0.0, seed=3)
    prompts = [np.random.default_rng(4).integers(0, jc.vocab_size, L)
               .astype(np.int32) for L in (20, 12, 20)]
    jeng = JDenseEngine(jc, jp, JServe(**kw))
    teng = ServingEngine(tc, tp, ServeConfig(**kw), device="cpu")
    jreqs = [JRequest(rid=i, prompt=jnp.asarray(p), max_new_tokens=4 + i)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=4 + i)
             for i, p in enumerate(prompts)]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained(max_ticks=200)
        assert all(r.done for r in reqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
