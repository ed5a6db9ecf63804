"""The port's synthetic data pipeline: the ``lm`` recursion on the
reference's own ``jax.random`` draws (exact: integer tokens), the copy
task's layout and mask against the reference's, and the port of the
reference's ``TestData`` (determinism, distinct steps, learnable
structure, the embeddings mode)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import DataConfig, data_iterator, lm_tokens
from repro_torch.data import synthetic_batch as tbatch

from _torch_parity import n, t

jax.config.update("jax_platform_name", "cpu")


def _jcfg(cfg):
    import dataclasses
    return jpipe.DataConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("seed,step,ngram,V", [(0, 0, 3, 256), (3, 41, 2, 50),
                                              (7, 5, 1, 1000)])
def test_lm_recursion_on_reference_draws(seed, step, ngram, V):
    """The reference's draws (``repro/data/pipeline.py:40-71``) through the
    port's recursion give the reference's tokens."""
    cfg = DataConfig(vocab_size=V, seq_len=48, global_batch=3, seed=seed,
                     ngram=ngram)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    k1, k2, k3 = jax.random.split(key, 3)
    table = jax.random.randint(jax.random.PRNGKey(seed), (V,), 0, V)
    x0 = jax.random.randint(k1, (3, ngram), 0, V)
    noise = jax.random.bernoulli(k2, 0.1, (3, 48))
    rand = jax.random.randint(k3, (3, 48), 0, V)
    want = np.asarray(jpipe._lm_tokens(key, _jcfg(cfg)))
    got = lm_tokens(t(table), t(x0), t(noise), t(rand))
    np.testing.assert_array_equal(n(got), want)


def test_batch_layout_matches_reference():
    """Keys, shapes and dtypes of both tasks and both input modes; the
    copy task's mask equals the reference's."""
    for kw in (dict(), dict(task="copy"),
               dict(input_mode="embeddings", d_model=16)):
        cfg = DataConfig(seq_len=20, global_batch=2, **kw)
        got, ref = tbatch(cfg, 3, device="cpu"), jpipe.synthetic_batch(
            _jcfg(cfg), 3)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert tuple(got[k].shape) == ref[k].shape, k
            assert str(got[k].dtype).endswith(str(ref[k].dtype)), k
        if "mask" in ref:
            np.testing.assert_array_equal(n(got["mask"]),
                                          np.asarray(ref["mask"]))


def test_copy_task_structure():
    cfg = DataConfig(seq_len=21, global_batch=3, task="copy", vocab_size=30)
    b = tbatch(cfg, 0, device="cpu")
    toks = torch.cat([b["inputs"], b["labels"][:, -1:]], dim=1)
    assert (toks[:, 10] == 1).all()
    assert torch.equal(toks[:, :10], toks[:, 11:])
    assert int(toks[:, :10].min()) >= 2


def test_lm_follows_its_table():
    """About 90 % of the ``lm`` stream's tokens are the table successor of
    the token before (10 % noise, which sometimes draws it too)."""
    cfg = DataConfig(seq_len=512, global_batch=4, vocab_size=64)
    from repro_torch.data.pipeline import _TABLE, _gen
    table = torch.randint(0, 64, (64,), generator=_gen(0, _TABLE),
                          dtype=torch.int32)
    b = tbatch(cfg, 0, device="cpu")
    follows = (table[b["inputs"].long()] == b["labels"]).float().mean()
    assert 0.85 < float(follows) < 0.95


def test_iterator_resumes():
    cfg = DataConfig(seq_len=16, global_batch=2)
    it = data_iterator(cfg, start_step=5, device="cpu")
    for s in (5, 6):
        assert torch.equal(next(it)["inputs"],
                           tbatch(cfg, s, device="cpu")["inputs"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch(DataConfig(seq_len=8, global_batch=1), 0)


class TestData:
    def test_deterministic_restart(self):
        cfg = DataConfig(seed=3, seq_len=16, global_batch=2)
        a = tbatch(cfg, 41, device="cpu")
        b = tbatch(cfg, 41, device="cpu")
        assert torch.equal(a["inputs"], b["inputs"])

    def test_steps_differ(self):
        cfg = DataConfig(seed=3, seq_len=16, global_batch=2)
        assert not torch.equal(tbatch(cfg, 1, device="cpu")["inputs"],
                               tbatch(cfg, 2, device="cpu")["inputs"])

    def test_lm_task_is_learnable_structure(self):
        cfg = DataConfig(seed=0, seq_len=256, global_batch=4, ngram=2)
        toks = tbatch(cfg, 0, device="cpu")["inputs"]
        assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
        assert len(torch.unique(toks)) > 10

    def test_embeddings_mode(self):
        cfg = DataConfig(seed=0, seq_len=16, global_batch=2,
                         input_mode="embeddings", d_model=32)
        b = tbatch(cfg, 0, device="cpu")
        assert b["inputs"].shape == (2, 15, 32)
        assert b["labels"].shape == (2, 15)
