"""A run with the timed path broken underneath has to come out not
correct: the harness, at a size a CPU test holds, driven to the end with
each fault a serving cell can have planted in the program, and held to
the cell's committed limit."""

import pytest

from perfbench.tests._tiny import CELLS, ENCODING, SERVING, correct, rehearse


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    assert correct(rehearse(workload)["check"])


@pytest.mark.parametrize("workload", SERVING)
def test_token_altered_where_produced(workload, monkeypatch):
    import repro_torch.serving.engine as eng
    pick = eng._SamplerMixin._pick

    def off_by_one(self, logits):
        return (pick(self, logits) + 1) % logits.shape[-1]
    monkeypatch.setattr(eng._SamplerMixin, "_pick", off_by_one)
    assert not correct(rehearse(workload)["check"])


@pytest.mark.parametrize("workload", SERVING)
def test_decode_step_leaves_its_cache_unchanged(workload, monkeypatch):
    """Each decode tick computes its logits but keeps none of the K / V it
    wrote: the state it returns is the state it got."""
    import repro_torch.serving.engine as eng
    step = eng.paged_decode_step

    def forgetful(cfg, params, cache, pos_pages, *a, **k):
        saved = [(c.k_pages.clone(), c.v_pages.clone()) for c in cache]
        pos = pos_pages.clone()
        out = step(cfg, params, cache, pos_pages, *a, **k)
        for c, (kp, vp) in zip(cache, saved):
            c.k_pages.copy_(kp)
            c.v_pages.copy_(vp)
        pos_pages.copy_(pos)
        return out
    monkeypatch.setattr(eng, "paged_decode_step", forgetful)
    assert not correct(rehearse(workload)["check"])


@pytest.mark.parametrize("workload", ENCODING)
def test_answer_altered_where_produced(workload, monkeypatch):
    """One position of each input given the answer of a position in
    another run of its tokens (a neighbour in a run of repeated tokens may
    share its answer by SPLS's own plan)."""
    import repro_torch.models as models
    fwd = models.forward

    def nudged(cfg, params, toks):
        out = fwd(cfg, params, toks)
        out[:, 5] = out[:, out.shape[1] // 2 + 5]
        return out
    monkeypatch.setattr(models, "forward", nudged)
    assert not correct(rehearse(workload)["check"])


@pytest.mark.parametrize("workload", ENCODING)
def test_block_returns_its_input_unchanged(workload, monkeypatch):
    """The last block's attention and FFN skipped: it hands on its
    input."""
    import repro_torch.models.model as model
    period = model._period

    def skip_last(cfg, params, pi, x, platform=None):
        return x if pi == cfg.n_periods - 1 else period(cfg, params, pi, x,
                                                        platform)
    monkeypatch.setattr(model, "_period", skip_last)
    assert not correct(rehearse(workload)["check"])


def test_capacity_picks_matter():
    """The reference has to replay a chunk at the capacity the program
    picked: replayed at a quarter of the chunk instead, where the
    program's random prompts kept more rows, it reads a gap."""
    from perfbench.harness import serve
    from perfbench.tests._tiny import tiny
    orig = serve.reference_gaps
    quarter = tiny("qwen3-0.6b.spls_prefill_heavy")[1]["engine"][
        "prefill_chunk"] // 4

    def starved(cfg, params, replays, *a, **k):
        return orig(cfg, params, [(p, s, [(quarter, quarter)] * len(c))
                                  for p, s, c in replays], *a, **k)
    serve.reference_gaps = starved
    try:
        rec = rehearse("qwen3-0.6b.spls_prefill_heavy",
                       check_limits={"served_gap": 1.0})
    finally:
        serve.reference_gaps = orig
    assert rec["check"]["served_gap"]["value"] > 1e-3


def test_pick_off_the_controllers_rule(monkeypatch):
    """A capacity pick that the controller's rule would not make is
    caught by the replay of the picks."""
    from repro_torch.sparse_compute import CapacityController
    cap = CapacityController.capacity

    def stuck(self):
        cap(self)
        return self.buckets[0]
    monkeypatch.setattr(CapacityController, "capacity", stuck)
    chk = rehearse("qwen3-0.6b.spls_prefill_heavy")["check"]
    assert chk["capacity_picks_off_rule"]["value"] > 0
