"""The port's dense fixed-slot engine and the model path under it against
the reference on bridged weights: SPLS ``prefill`` (progressive plans,
the flash backends) then ``decode_step`` (the flash-decode backends), and
the greedy tokens of ``ServingEngine`` for the paper's non-causal encoder
and a causal model with a window and a softcap.

Both sides name the backend explicitly: the two packages' ``"auto"``
differ on a CPU (``repro_torch.models.attn_backend``).

Tolerances: logits and caches rtol = atol = 1e-4 (XLA and torch order
matmul sums differently on the CPU); tokens exact.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jm
from repro.serving import Request as JRequest, ServeConfig as JServe
from repro.serving import ServingEngine as JEngine
from repro_torch.models import model as tm
from repro_torch.serving import Request as TRequest, ServeConfig as TServe
from repro_torch.serving import ServingEngine as TEngine

from _torch_parity import cfg_pair, n, params_pair, t

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CASES = [("mha", False), ("gqa_qknorm", True),
         ("gqa_window_softcap", False)]


def _pair(kind, causal, **kw):
    return cfg_pair(kind, spls=dict(causal=causal), causal=causal, **kw)


@pytest.mark.parametrize("kind,causal", CASES[::2])
def test_prefill_and_decode_step(kind, causal):
    """SPLS prefill (progressive plans, the flash backends) then two decode
    steps on the flash-decode backends: logits and caches."""
    jc, tc = _pair(kind, causal)
    jc = dataclasses.replace(jc, attn_backend="pallas_flash")
    tc = dataclasses.replace(tc, attn_backend="pallas_flash")
    jp, tp = params_pair(jc)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 20)
                                             ).astype(np.int32)
    jl, jcache = jm.prefill(jc, jp, jnp.asarray(toks), max_len=24,
                            plan_mode="progressive")
    tl, tcache = tm.prefill(tc, tp, t(toks), max_len=24,
                            plan_mode="progressive")
    np.testing.assert_allclose(n(tl), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(n(tcache[0].k), np.asarray(jcache[0].k),
                               **LOGIT_TOL)
    jdc = dataclasses.replace(jc, attn_backend="pallas_flash_decode")
    tdc = dataclasses.replace(tc, attn_backend="pallas_flash_decode")
    pos = np.array([20, 17], np.int32)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(2):
        jd, jcache = jm.decode_step(jdc, jp, jcache, jnp.asarray(nxt),
                                    jnp.asarray(pos))
        td, tcache = tm.decode_step(tdc, tp, tcache, t(nxt), t(pos))
        np.testing.assert_allclose(n(td), np.asarray(jd), **LOGIT_TOL)
        nxt = np.argmax(np.asarray(jd)[:, 0], -1).astype(np.int32)[:, None]
        pos = pos + 1
    np.testing.assert_allclose(n(tcache[0].v), np.asarray(jcache[0].v),
                               **LOGIT_TOL)




@pytest.mark.parametrize("kind,causal,backend", [
    ("mha", False, "pallas_flash"),
    ("gqa_window_softcap", True, "pallas_flash")])
def test_engine_matches_reference(kind, causal, backend):
    """Three requests through two slots: admission into freed slots,
    prefill of ragged prompts, batched decode with inactive rows."""
    jc, tc = _pair(kind, causal)
    jp, tp = params_pair(jc)
    r = np.random.default_rng(5)
    prompts = [r.integers(0, jc.vocab_size, L).astype(np.int32)
               for L in (20, 12, 20)]
    kw = dict(n_slots=2, max_len=32, attn_backend=backend)
    jeng = JEngine(jc, jp, JServe(**kw))
    teng = TEngine(tc, tp, TServe(**kw), device="cpu")
    jreqs = [JRequest(rid=i, prompt=jnp.asarray(p), max_new_tokens=4 + i)
             for i, p in enumerate(prompts)]
    treqs = [TRequest(rid=i, prompt=p, max_new_tokens=4 + i)
             for i, p in enumerate(prompts)]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for q in reqs:
            eng.submit(q)
        done = eng.run_until_drained(max_ticks=200)
        assert len(done) == len(reqs) and all(q.done for q in reqs)
    assert [q.output for q in treqs] == [q.output for q in jreqs]
    assert teng.stats == {"retired": 3, "compute_backend": "dense",
                          "flops_saved_pct": {}}


def test_engine_refuses_what_is_not_ported():
    jc, tc = _pair("mha", False)
    _, tp = params_pair(jc)
    # temperature sampling at T 0 is the greedy pick
    outs = []
    for greedy in (True, False):
        eng = TEngine(tc, tp, TServe(max_len=16, greedy=greedy,
                                     temperature=0.0), device="cpu")
        req = TRequest(rid=0, prompt=np.arange(6, dtype=np.int32),
                       max_new_tokens=4)
        eng.submit(req)
        eng.run_until_drained()
        outs.append(req.output)
    assert outs[0] == outs[1] and len(outs[0]) == 4
    eng = TEngine(tc, tp, TServe(max_len=16), device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(TRequest(rid=0, prompt=np.zeros(20, np.int32)))
    with pytest.raises(ValueError, match="token ids"):
        eng.submit(TRequest(rid=1, prompt=[tc.vocab_size]))
