"""The SPLS plan block kernel (``kernels/spls_plan.py``, ``csrc/spls_plan.cu``).

On the CPU: the wrappers take their plain versions (``plan_chunk`` and
``plan_chunk_votes`` move no launch counter), the plain version equals the
per-head chain it was moved from, and the wrappers refuse what the kernels
do not take, on either device.

On a card only (``cuda`` marker: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_spls_plan_kernel.py``): the kernels against the plain
versions on the same CUDA tensors, at the serving cell's shape (1, 8, 2,
256, 2176) at a first, a middle and a last chunk and two k, at w 16, at
8192 column slots (the long-sequence plan's shape), causal and not, votes
only.  ``mask``, ``kv_any`` and the MFI outputs are equal; ``is_critical``
and ``leader`` are equal except in windows whose first differing row has
an earlier critical row at a float64 distance within 1e-6 x max(1, s) of
``s`` (the kernel sums distances in float64 and rounds once, the plain
chain in float32); the count of such rows is printed.  The launch
counters advance by the number of layers a chunk step of a paged engine.
This file imports without JAX: the card's machine has none.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core.mfi import mfi_ffn_sparsity
from repro_torch.core.predict import head_scores
from repro_torch.core.similarity import local_similarity
from repro_torch.core.spls_chunked import (CAUSAL_FILL, bisect_topk_mask,
                                           plan_chunk, plan_chunk_votes,
                                           spls_plan_block_plain)


def _pre_move_chain(scores, *, scale, k, row0, n_valid_rows, n_cols, causal,
                    w, s_threshold):
    """``core/spls_chunked.py``'s per-head chain before the plan kernel:
    ``_block_pam_mask`` on the scores, the SPA, ``local_similarity``, the
    column OR."""
    C, S = scores.shape[-2:]
    pam = (scores * scale).to(torch.bfloat16)
    qi = row0 + torch.arange(C)
    kj = torch.arange(S)
    cmask = (kj[None, :] < n_cols).expand(C, S)
    if causal:
        cmask = cmask & (kj[None, :] <= qi[:, None])
    pam = pam.masked_fill(~cmask, CAUSAL_FILL)
    pam32 = pam.to(torch.float32)
    valid_rows = torch.arange(C) < n_valid_rows
    mask = bisect_topk_mask(pam32, k)
    mask = mask & cmask & valid_rows[:, None]
    spa = torch.where(mask, pam32, torch.zeros_like(pam32))
    sim = local_similarity(spa, w, s_threshold, valid_len=n_valid_rows)
    return mask, sim.is_critical, sim.leader, mask.any(dim=-2)


def _window_scores(shape, w, seed, device="cpu"):
    """Scores whose rows are a window's base row plus noise that grows
    down the window, so windows hold both critical and similar rows."""
    *lead, C, S = shape
    g = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((*lead, C // w, 1, S), generator=g, device=device)
    noise = torch.randn((*lead, C // w, w, S), generator=g, device=device)
    grow = torch.linspace(0.0, 1.5, w, device=device)[:, None]
    return ((base + grow * noise) * 8.0).reshape(shape).contiguous()


def _heads(seed, B=1, KV=2, G=2, C=16, S=40, Dh=8):
    g = torch.Generator().manual_seed(seed)
    qh = torch.round(torch.randn((B, KV, G, C, Dh), generator=g) * 4)
    kh = torch.round(torch.randn((B, KV, S, Dh), generator=g) * 4)
    return qh, kh


# ---------------------------------------------------------------- on the CPU

@pytest.mark.parametrize("causal,w,row0,valid,n_cols", [
    (True, 8, 0, 32, 32), (True, 8, 32, 21, 53), (False, 4, 0, 32, 48),
    (False, 16, 16, 32, 40)])
def test_plain_equals_the_pre_move_chain(causal, w, row0, valid, n_cols):
    scores = _window_scores((1, 2, 2, 32, 48), w, seed=w + row0)
    kw = dict(scale=0.125, k=7, row0=row0, n_valid_rows=valid,
              n_cols=n_cols, causal=causal, w=w, s_threshold=0.6)
    got = spls_plan_block_plain(scores, **kw)
    want = _pre_move_chain(scores, **kw)
    for g, h in zip(got, want):
        assert torch.equal(g, h)
    assert got[1].any() and not got[1][..., :valid].all()   # both kinds
    *_, votes = spls_plan_block_plain(scores, votes_only=True, **kw)
    assert torch.equal(votes, want[3])


@pytest.mark.parametrize("causal", [True, False])
def test_plan_chunk_on_the_cpu_takes_the_plain_version(causal):
    K.reset_launch_counts()
    qh, kh = _heads(3)
    kw = dict(k=5, row0=8, n_valid_rows=13, n_cols=21, causal=causal)
    pb = plan_chunk(qh, kh, s_threshold=0.6, window=8, f_threshold=2, **kw)
    mask, crit, lead, kv_any = _pre_move_chain(
        head_scores(qh, kh), scale=8 ** -0.5, w=8, s_threshold=0.6, **kw)
    ffn = mfi_ffn_sparsity(lead.reshape(1, 4, 16), 8, 2)
    assert torch.equal(pb.mask, mask) and torch.equal(pb.q_critical, crit)
    assert torch.equal(pb.q_leader, lead + 8)
    assert torch.equal(pb.kv_any, kv_any)
    assert torch.equal(pb.ffn_critical, ffn.is_critical)
    assert torch.equal(pb.ffn_leader, ffn.leader + 8)
    assert torch.equal(plan_chunk_votes(qh, kh, **kw), kv_any)
    assert K.launch_counts()["spls_plan_block"] == 0
    assert K.launch_counts()["spls_mfi"] == 0


def test_mfi_on_the_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(5)
    t = torch.arange(24)
    lead = ((t // 8) * 8 + torch.randint(0, 8, (2, 6, 24), generator=g))
    lead = torch.minimum(lead, t).to(torch.int32)
    got, want = K.spls_mfi(lead, 8, 3), mfi_ffn_sparsity(lead, 8, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _refusals():
    s = _window_scores((1, 1, 2, 16, 24), 8, seed=1)
    kw = dict(scale=1.0, k=3, row0=0, n_valid_rows=16, n_cols=24,
              causal=True, w=8, s_threshold=0.6)
    lead = torch.zeros((1, 2, 16), dtype=torch.int32)
    plan, mfi = K.spls_plan_block, K.spls_mfi
    return {
        "w_17": (lambda: plan(s, **dict(kw, w=17)), ValueError),
        "C_not_a_multiple_of_w": (lambda: plan(s, **dict(kw, w=6)),
                                  ValueError),
        "no_threshold": (lambda: plan(s, **dict(kw, s_threshold=None)),
                         ValueError),
        "float16": (lambda: plan(s.half(), **kw), TypeError),
        "float64": (lambda: plan(s.double(), **kw), TypeError),
        "4d": (lambda: plan(s[0], **kw), ValueError),
        "grad": (lambda: plan(s.clone().requires_grad_(), **kw),
                 RuntimeError),
        "mfi_int64": (lambda: mfi(lead.long(), 8, 3), TypeError),
        "mfi_w_17": (lambda: mfi(lead, 17, 3), ValueError),
        "mfi_2d": (lambda: mfi(lead[0], 8, 3), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrappers_refuse(case):
    """What the kernels do not take raises on either device, before any
    plain version runs; a gradient raises as for the other wrappers."""
    call, exc = _refusals()[case]
    with pytest.raises(exc):
        call()


@pytest.mark.parametrize("layout", ["replicated", "batch_kv", "batch_g"])
def test_plan_chunk_on_dtensors_equals_plain_tensors(layout):
    """On ``DTensor``s (one-rank ``gloo`` mesh) ``plan_chunk`` and
    ``plan_chunk_votes`` run the wrappers on the local shards (the MFI on
    leaders gathered over the head axes) and give the plain tensors'
    plan; on the CPU no launch counter moves."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_cpu_mesh

    qh, kh = _heads(4, B=2, KV=2, G=2, C=16, S=40)
    kw = dict(k=5, row0=8, n_valid_rows=13, n_cols=21)
    plan = dict(s_threshold=0.6, window=8, f_threshold=2, **kw)
    want = plan_chunk(qh, kh, **plan)
    want_votes = plan_chunk_votes(qh, kh, **kw)
    q_pl, k_pl = {"replicated": ((Replicate(),) * 2,) * 2,
                  "batch_kv": ((Shard(0), Shard(1)),) * 2,
                  "batch_g": ((Shard(0), Shard(2)),
                              (Shard(0), Replicate()))}[layout]
    K.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_cpu_mesh(1, 1)
            dq = distribute_tensor(qh, mesh, q_pl)
            dk = distribute_tensor(kh, mesh, k_pl)
            got = [t.full_tensor() for t in plan_chunk(dq, dk, **plan)]
            votes = plan_chunk_votes(dq, dk, **kw).full_tensor()
        finally:
            dist.destroy_process_group()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(votes, want_votes)
    assert K.launch_counts()["spls_plan_block"] == 0
    assert K.launch_counts()["spls_mfi"] == 0


def test_plan_block_runs_under_no_grad():
    s = _window_scores((1, 1, 2, 16, 24), 8, seed=2).requires_grad_()
    with torch.no_grad():
        mask, *_ = K.spls_plan_block(s, scale=1.0, k=3, row0=0,
                                     n_valid_rows=16, n_cols=24, causal=True,
                                     w=8, s_threshold=0.6)
    assert mask.shape == s.shape


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# name: (shape, w, k, row0, n_valid_rows, n_cols, causal, votes_only)
CARD_CASES = {
    "cell_a_first_k123": ((1, 8, 2, 256, 2176), 8, 123, 0, 256, 256, True,
                          False),
    "cell_a_first_k16": ((1, 8, 2, 256, 2176), 8, 16, 0, 256, 256, True,
                         False),
    "cell_a_middle": ((1, 8, 2, 256, 2176), 8, 123, 512, 256, 768, True,
                      False),
    "cell_a_last": ((1, 8, 2, 256, 2176), 8, 205, 1536, 172, 1708, True,
                    False),
    "cell_a_votes": ((1, 8, 2, 256, 2176), 8, 123, 512, 200, 712, True,
                     True),
    "w16": ((1, 4, 2, 128, 2176), 16, 64, 256, 128, 384, True, False),
    "noncausal": ((2, 4, 3, 128, 384), 8, 46, 0, 128, 384, False, False),
    "s8192": ((1, 8, 4, 512, 8192), 8, 984, 4096, 512, 8192, True, False),
    "s8192_w16_streamed": ((1, 2, 2, 64, 8192), 16, 984, 8128, 64, 8192,
                           True, False),
}


def _near_tie_rows(scores, scale, w, s, plain, got):
    """Rows where the kernel's ``is_critical`` / ``leader`` differ from the
    plain chain's; raises unless each window's first differing row has an
    earlier critical row at a float64 distance within 1e-6 x max(1, s) of
    ``s`` (later rows of that window are its consequence)."""
    mask, crit_p, lead_p, _ = plain
    _, crit_k, lead_k, _ = got
    C, S = scores.shape[-2:]
    diff = ((crit_p != crit_k) | (lead_p != lead_k)).reshape(-1, C // w, w)
    bad = diff.any(-1).nonzero().tolist()
    if not bad:
        return 0
    pam = (scores * scale).to(torch.bfloat16).to(torch.float64)
    spa = torch.where(mask, pam, 0.0).reshape(-1, C // w, w, S)
    crit = crit_p.reshape(-1, C // w, w)
    tie = 1e-6 * max(1.0, s)
    rows = 0
    for h, win in bad:
        x = spa[h, win]
        j = int(diff[h, win].nonzero()[0])
        norm = x.abs().sum(-1)
        d = [float((x[i] - x[j]).abs().sum() / (norm[i] + norm[j] + 1e-6))
             for i in range(j) if crit[h, win, i]]
        assert any(abs(v - s) <= tie for v in d), (h, win, j, d)
        rows += int(diff[h, win, j:].sum())
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_plan_block_kernel_vs_plain(cuda_device, case):
    shape, w, k, row0, valid, n_cols, causal, votes = CARD_CASES[case]
    scores = _window_scores(shape, w, seed=len(case), device=cuda_device)
    kw = dict(scale=128 ** -0.5, k=k, row0=row0, n_valid_rows=valid,
              n_cols=n_cols, causal=causal, w=w, s_threshold=0.6,
              votes_only=votes)
    n0 = K.spls_plan_block.launches
    got = K.spls_plan_block(scores, **kw)
    torch.cuda.synchronize()
    assert K.spls_plan_block.launches == n0 + 1
    plain = spls_plan_block_plain(scores, **kw)
    assert torch.equal(got[3], plain[3])                      # kv_any
    if votes:
        assert got[:3] == (None, None, None)
        return
    assert torch.equal(got[0], plain[0])                      # mask
    rows = _near_tie_rows(scores, kw["scale"], w, 0.6, plain, got)
    print(f"{case}: {rows} near-tie rows of {plain[1].numel()}; "
          f"critical {int(plain[1].sum())}")
    assert plain[1].any() and not plain[1][..., :valid].all()
    lead = got[2].reshape(shape[0], -1, shape[3])
    ffn_k, ffn_p = K.spls_mfi(lead, w, 3), mfi_ffn_sparsity(lead, w, 3)
    for a, b in zip(ffn_k, ffn_p):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("w,f", [(8, 6), (16, 3), (5, 1)])
def test_mfi_kernel_vs_plain(cuda_device, w, f):
    g = torch.Generator(device="cuda").manual_seed(w)
    L = 5 * w * 7
    t = torch.arange(L, device=cuda_device)
    lead = (t // w) * w + torch.randint(0, w, (3, 16, L), generator=g,
                                        device=cuda_device)
    lead = torch.minimum(lead, t).to(torch.int32)
    got, want = K.spls_mfi(lead, w, f), mfi_ffn_sparsity(lead, w, f)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_launch_counters_per_chunk_step(cuda_device):
    """A paged SPLS engine on the card launches each kernel once a layer
    of every chunk step."""
    from repro_torch.models import init_params
    from repro_torch.serve_batch import demo_config, demo_prompts
    from repro_torch.serving import (PagedServingEngine, Request,
                                     ServeConfig)

    cfg = demo_config(True, 0.25, 0.6)
    params = init_params(cfg, seed=0, device=cuda_device)
    eng = PagedServingEngine(cfg, params, ServeConfig(
        n_slots=2, max_len=96, page_size=8, prefill_chunk=16,
        compute_backend="packed_torch",
        attn_backend="torch_paged_decode"), device=cuda_device)
    K.reset_launch_counts()
    for i, p in enumerate(demo_prompts(3, 40, cfg.vocab_size)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    eng.run_until_drained(max_ticks=500)
    steps = eng.sched.stats["prefill_chunks"]
    assert steps == 9
    assert K.launch_counts()["spls_plan_block"] == cfg.n_layers * steps
    assert K.launch_counts()["spls_mfi"] == cfg.n_layers * steps
