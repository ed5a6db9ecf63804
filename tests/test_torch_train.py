"""Training of the port against the reference on bridged weights and the
same numpy batches: ``loss_fn`` and every gradient leaf for every
architecture of the registry at its smoke form (float32), with SPLS on
(also at q capacity 0.5, through ``torch_packed``), remat on against
remat off, one ``make_train_step`` step at ``n_micro`` 1
and 2, the training routes, and the kernel wrappers' refusal of inputs
that need a gradient.

Tolerances: loss rtol 1e-5; each gradient leaf max |port - reference| <=
1e-4 x max |reference leaf| (XLA and torch order float32 sums
differently; measured <= 9e-6); remat on equals remat off exactly on the
CPU (the same ops run again).  After a train step: params within 1e-6 +
2 x lr per step (Adam normalizes each element, so where a gradient is near
zero its sign -- a last-bit matter -- can flip the step: at most 2 x lr),
``mu`` within 1e-4 x max |mu|, ``nu`` within 1e-4 x max |nu|, ``count``
exact.

With SPLS on, the plans differ between the packages at near-ties of the
predicted scores (the parity rules: a float32 product breaks the quantized
PAM's exact ties by an ulp, differently in XLA and torch), and a gradient
under another plan is another function.  So the SPLS cases feed the
port's plans to both packages -- the reference's period scan unrolled (a
Python loop, traced once per layer) and its block planner returning the
port's plan of that layer -- and check that plans carry no gradient in
either package (every field is integer or boolean).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import BlockCfg as JBlockCfg
from repro.configs.registry import ARCH_IDS
from repro.core.spls import SPLSConfig as JSPLSConfig
from repro.launch import steps as jsteps
from repro.models import model as jm
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jadamw_init
from repro.optim.schedules import constant as jconstant
from repro_torch import kernels as K
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.configs.base import BlockCfg as TBlockCfg
from repro_torch.core.spls import SPLSConfig as TSPLSConfig
from repro_torch.launch import steps as tsteps
from repro_torch.models import blocks as tblocks
from repro_torch.models import loss_fn
from repro_torch.models.attn_backend import resolve_backend
from repro_torch.optim import AdamWConfig, constant
from repro_torch.sparse_compute.backend import resolve_compute_backend
from repro_torch.tree import leaf_id, leaves_with_path
from repro_torch.weights import opt_state_from_jax, params_from_jax

from _torch_parity import (arch_pair, feed_reference_plans, n, params_pair,
                           record_port_plans, t)

GRAD_TOL = 1e-4
# the reference launcher's ``--spls`` knobs (repro/launch/train.py)
LAUNCH_SPLS = dict(enabled=True, k_ratio=0.2, s_threshold=0.6,
                   f_threshold=2, window=4, causal=True)


def jax_leaves(tree) -> dict:
    """``{leaf id: numpy array}`` of a reference tree (its paths)."""
    def part(k):
        for a in ("key", "idx", "name"):
            if hasattr(k, a):
                return str(getattr(k, a))
        return str(k)
    return {".".join(part(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_grads_match(tgrads, jgrads) -> None:
    ref = jax_leaves(jgrads)
    got = {leaf_id(p): n(g) for p, g in leaves_with_path(tgrads)}
    assert sorted(got) == sorted(ref)
    for lid, r in ref.items():
        assert got[lid].shape == r.shape, lid
        err = np.abs(got[lid] - r).max()
        assert err <= GRAD_TOL * np.abs(r).max(), (lid, err,
                                                   np.abs(r).max())


def batch_np(cfg, B=2, L=16, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        x = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    else:
        x = rng.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    y = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    return {"inputs": x, "labels": y}


_VG = {}


def jax_value_and_grad(jc):
    """One jitted ``value_and_grad(loss_fn)`` per reference config, shared
    across tests."""
    key = repr(jc)
    if key not in _VG:
        _VG[key] = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss_fn(jc, p, b), has_aux=True))
    return _VG[key]


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: t(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# loss and gradients, every architecture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_loss_and_grads_match_reference(arch_id):
    jc, tc = arch_pair(arch_id)
    jp, tp = params_pair(jc, jit=True)
    b = batch_np(jc)
    (jloss, jmet), jg = jax_value_and_grad(jc)(jp, as_jax(b))
    tg, tmet = tsteps.make_loss_grad(tc)(tp, as_torch(b))
    for k in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5)
    assert_grads_match(tg, jg)
    # the caller's weights never require grad
    assert not any(leaf.requires_grad for _, leaf in leaves_with_path(tp))


def test_loss_fn_mask_and_metrics():
    """The mask weights the loss and the accuracy; an all-zero mask
    divides by 1 (the reference's ``max(mask.sum(), 1)``)."""
    jc, tc = arch_pair("qwen3-0.6b")
    jp, tp = params_pair(jc, jit=True)
    b = batch_np(jc)
    for mask in (np.r_[np.zeros(8), np.ones(8)][None].repeat(2, 0),
                 np.zeros((2, 16))):
        b["mask"] = mask.astype(np.float32)
        jl, jmet = jm.loss_fn(jc, jp, as_jax(b))
        tl, tmet = loss_fn(tc, tp, as_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   atol=1e-6)
        for k in ("accuracy", "tokens"):
            assert float(tmet[k]) == pytest.approx(float(jmet[k]))


# ---------------------------------------------------------------------------
# SPLS: the port's plans fed to both packages
# ---------------------------------------------------------------------------

def _tiny_pair(spls):
    """The reference's ``tests/test_runtime.py`` tiny config, both
    packages."""
    base = dict(name="tiny", n_layers=2, d_model=32, n_heads=2,
                n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
                remat=False)
    return (JArchConfig(period=(JBlockCfg(),), spls=JSPLSConfig(**spls),
                        **base),
            TArchConfig(period=(TBlockCfg(),), spls=TSPLSConfig(**spls),
                        **base))


def _shared_plan_grads(jc, tc, jp, tp, b, monkeypatch):
    """Port and reference gradients under the port's plans."""
    plans = record_port_plans(monkeypatch)
    tg, tmet = tsteps.make_loss_grad(tc)(tp, as_torch(b))
    assert len(plans) == tc.n_layers
    for plan in plans:
        for f in plan:
            assert not f.is_floating_point() and not f.requires_grad
    feed_reference_plans(monkeypatch, plans)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(jc, p, as_jax(b)), has_aux=True))(jp)
    return tg, tmet, jg, jloss


def test_spls_grads_match_reference(monkeypatch):
    """The reference's ``test_spls_trains`` config (k 0.3, s 0.6, f 1,
    window 4) on its data shape (4 x 31 tokens)."""
    jc, tc = _tiny_pair(dict(enabled=True, k_ratio=0.3, s_threshold=0.6,
                             f_threshold=1, window=4))
    jp, tp = params_pair(jc)
    toks = np.random.default_rng(0).integers(0, 64, (4, 32)).astype(
        np.int32)
    b = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    tg, tmet, jg, jloss = _shared_plan_grads(jc, tc, jp, tp, b, monkeypatch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jloss), rtol=1e-5)
    assert_grads_match(tg, jg)


@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "olmoe-1b-7b"])
def test_launcher_spls_grads_match_reference(arch_id, monkeypatch):
    """The training launcher's ``--spls`` knobs on the smoke forms (GQA
    with qk-norm; MoE, which keeps its routing under SPLS)."""
    jc, tc = arch_pair(arch_id, spls=LAUNCH_SPLS)
    jp, tp = params_pair(jc, jit=True)
    b = batch_np(jc, L=32, seed=1)
    tg, tmet, jg, jloss = _shared_plan_grads(jc, tc, jp, tp, b, monkeypatch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jloss), rtol=1e-5)
    assert_grads_match(tg, jg)


@pytest.mark.parametrize("arch_id,spls", [
    ("qwen3-0.6b", True), ("olmoe-1b-7b", True), ("jamba-v0.1-52b", False),
    ("mamba2-370m", False), ("gemma2-27b", True)])
def test_remat_equals_no_remat(arch_id, spls):
    """``cfg.remat`` recomputes each period in backward: the same loss and
    gradients (the plan rebuilt in the recompute is the forward's)."""
    _, tc = arch_pair(arch_id, spls=LAUNCH_SPLS if spls else None)
    jc, _ = arch_pair(arch_id, spls=LAUNCH_SPLS if spls else None)
    _, tp = params_pair(jc, jit=True)
    b = as_torch(batch_np(tc, L=32, seed=2))
    g0, m0 = tsteps.make_loss_grad(tc)(tp, b)
    recomputed = []
    orig = tblocks.block_forward

    def counted(*a, **kw):
        recomputed.append(1)
        return orig(*a, **kw)

    import repro_torch.models.model as tmodel
    tmodel.block_forward, saved = counted, tmodel.block_forward
    try:
        g1, m1 = tsteps.make_loss_grad(
            dataclasses.replace(tc, remat=True))(tp, b)
    finally:
        tmodel.block_forward = saved
    # every block ran twice: the forward and its recompute in backward
    assert len(recomputed) == 2 * tc.n_layers
    assert float(m0["loss"]) == float(m1["loss"])
    for (p, a), (_, c) in zip(leaves_with_path(g0), leaves_with_path(g1)):
        assert torch.equal(a, c), leaf_id(p)


def test_remat_only_while_recording():
    """Serving (no grad) runs no checkpoint: the blocks run once."""
    _, tc = arch_pair("qwen3-0.6b")
    jc, _ = arch_pair("qwen3-0.6b")
    _, tp = params_pair(jc, jit=True)
    import repro_torch.models.model as tmodel
    calls = []
    saved = tmodel.checkpoint
    tmodel.checkpoint = lambda *a, **kw: calls.append(1) or saved(*a, **kw)
    try:
        x = t(batch_np(tc)["inputs"])
        tmodel.forward(dataclasses.replace(tc, remat=True), tp, x)
        with torch.no_grad():
            tmodel.forward(dataclasses.replace(tc, remat=True), tp,
                           x)
        assert calls == []
    finally:
        tmodel.checkpoint = saved


# ---------------------------------------------------------------------------
# one train step, n_micro 1 and 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    """Two ``make_train_step`` steps from one AdamW state (bridged), on
    the tiny config, lr 1e-3."""
    jc, tc = _tiny_pair(dict(enabled=False))
    jp, _ = params_pair(jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jst = jadamw_init(JAdamW(), jp)
    tst = opt_state_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    lr = 1e-3
    jstep = jax.jit(jsteps.make_train_step(jc, JAdamW(), jconstant(lr),
                                           n_micro))
    tstep = tsteps.make_train_step(tc, AdamWConfig(), constant(lr), n_micro)
    for s in range(2):
        toks = np.random.default_rng(s).integers(0, 64, (4, 32)).astype(
            np.int32)
        b = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        jp, jst, jmet = jstep(jp, jst, as_jax(b))
        tp, tst, tmet = tstep(tp, tst, as_torch(b))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
        assert set(tmet) == set(jmet)
    assert int(tst.count) == int(jst.count) == 2
    ref = jax_leaves({"params": jp, "mu": jst.mu, "nu": jst.nu})
    got = {leaf_id(p): n(v) for p, v in leaves_with_path(
        {"params": tp, "mu": tst.mu, "nu": tst.nu})}
    for lid, r in ref.items():
        if lid.startswith("params"):
            tol = 1e-6 + 2 * lr * 2
        else:
            tol = 1e-4 * np.abs(r).max()
        assert np.abs(got[lid] - r).max() <= tol, lid


# ---------------------------------------------------------------------------
# routes and refusals
# ---------------------------------------------------------------------------

def test_training_routes_as_reference_cpu():
    """``platform="cpu"``: the reference's CPU choices, on either
    device; ``"tpu"`` / ``"cuda"`` the kernels; None by device."""
    from repro_torch.core.spls_chunked import ChunkedPlan
    chunked = ChunkedPlan(*(torch.zeros(1),) * len(ChunkedPlan._fields))
    plan = object()
    for dev in ("cpu", "cuda"):
        r = lambda **kw: resolve_backend("auto", dev, "forward",
                                         platform="cpu", **kw)
        assert r(plan=chunked, L=64) == "torch_chunked"
        assert r(plan=plan, L=64, q_capacity=32) == "torch_packed"
        assert r(plan=plan, L=64, q_capacity=64) == "torch_dense"
        assert r(plan=plan, L=64) == "torch_dense"
        assert r(L=8193) == "torch_chunked"
        assert r(L=8192) == "torch_dense"
        assert resolve_backend(None, dev, "decode", platform="cpu") == \
            "torch_dense_decode"
        assert resolve_backend(None, dev, "paged_decode",
                               platform="cpu") == "torch_paged_decode"
        assert resolve_backend("auto", dev, "forward",
                               platform="cuda") == "cuda_flash"
        assert resolve_compute_backend("auto", sparse=True, device=dev,
                                       platform="cpu") == "packed_torch"
        assert resolve_compute_backend("packed_xla", sparse=True, device=dev,
                                       platform="cpu") == "packed_torch"
        assert resolve_compute_backend("auto", sparse=True, device=dev,
                                       platform="tpu") == "packed_cuda"
    assert resolve_backend("auto", "cuda", "forward") == "cuda_flash"
    assert resolve_backend("auto", "cpu", "forward") == "torch_flash"
    # a kernel named explicitly stays the kernel
    assert resolve_backend("pallas_flash", "cpu", "forward",
                           platform="cpu") == "cuda_flash"


def test_loss_grad_routes_through_torch_dense(monkeypatch):
    """``make_loss_grad`` resolves "auto" to ``torch_dense`` (not the
    flash route "auto" takes outside training), and no kernel wrapper is
    called."""
    from repro_torch.models import attn_backend as ab
    seen = []
    orig = ab.get_backend
    monkeypatch.setattr("repro_torch.models.attention.get_backend",
                        lambda name: seen.append(name) or orig(name))
    jc, tc = arch_pair("qwen3-0.6b")
    _, tp = params_pair(jc, jit=True)
    K.reset_launch_counts()
    tsteps.make_loss_grad(tc)(tp, as_torch(batch_np(tc)))
    assert set(seen) == {"torch_dense"}
    assert not any(K.launch_counts().values())


def _grad_inputs():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    q = r(1, 2, 4, 8)
    return {
        "flash_attention": (K.flash_attention, (q, r(1, 1, 4, 8),
                                                r(1, 1, 4, 8)), 0),
        "flash_decode": (K.flash_decode, (
            r(1, 1, 2, 8), r(1, 1, 4, 8), r(1, 1, 4, 8),
            torch.tensor([3], dtype=torch.int32)), 0),
        "paged_flash_decode": (K.paged_flash_decode, (
            r(1, 1, 2, 8), r(1, 2, 4, 8), r(1, 2, 4, 8),
            torch.arange(8, dtype=torch.int32).view(2, 4),
            torch.tensor([[0, 1]], dtype=torch.int32),
            torch.tensor([8], dtype=torch.int32),
            torch.tensor([7], dtype=torch.int32)), 0),
        "gathered_matmul": (K.gathered_matmul, (
            r(6, 8), r(8, 4), torch.tensor([0, 2, 5], dtype=torch.int32)),
            1),
        "gather_rows": (K.gather_rows, (
            r(6, 8), torch.tensor([0, 2, 5], dtype=torch.int32)), 0),
        "local_similarity_dist": (K.local_similarity_dist,
                                  (r(1, 1, 8, 8), 4), 0),
        "hlog_qmatmul": (K.hlog_qmatmul, (torch.round(r(4, 8) * 9),
                                          torch.round(r(8, 4) * 9)), 1),
    }


_PLAIN = {"flash_attention": "flash_attention_plain",
          "flash_decode": "flash_decode_plain",
          "paged_flash_decode": "paged_decode_plain",
          "gathered_matmul": "gathered_matmul_plain",
          "gather_rows": "gather_rows_plain",
          "local_similarity_dist": "local_similarity_plain"}


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode",
                                  "paged_flash_decode", "gathered_matmul",
                                  "gather_rows", "local_similarity_dist",
                                  "hlog_qmatmul"])
def test_kernel_wrappers_refuse_grad(name):
    """A wrapper raises when autograd would need its gradient (on the
    CPU too: nothing swaps the plain version in), and runs under
    ``no_grad``; the plain versions stay differentiable (``hlog_qmatmul``'s
    projects onto levels: a step function)."""
    fn, args, which = _grad_inputs()[name]
    args = list(args)
    args[which] = args[which].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward kernel"):
        fn(*args)
    with torch.no_grad():
        fn(*args)
    if name in _PLAIN:
        assert getattr(K, _PLAIN[name])(*args).requires_grad


@pytest.mark.parametrize("over", [
    dict(attn_backend="pallas_flash"), dict(attn_backend="cuda_flash"),
    dict(attn_backend="torch_dense", compute_backend="packed_pallas")])
def test_training_a_kernel_backend_raises(over):
    """A config that names a kernel backend trains into its wrapper, which
    raises -- no fall back to a plain version.  (Packed compute runs the
    FFN at reduced q capacity.)"""
    spls = dict(LAUNCH_SPLS, q_capacity_ratio=0.5)
    jc, tc = arch_pair("qwen3-0.6b", spls=spls, **over)
    _, tp = params_pair(jc, jit=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        tsteps.make_loss_grad(tc)(tp, as_torch(batch_np(tc, L=32)))


# the reference's SPLS training configuration (repro/launch/dryrun.py)
PACKED_SPLS = dict(q_capacity_ratio=0.5, kv_capacity_ratio=0.75)


@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "mha_causal"])
def test_reduced_q_capacity_grads_match_reference(arch_id, monkeypatch):
    """At ``q_capacity_ratio`` 0.5 "auto" trains through ``torch_packed``
    (the reference's ``xla_packed``): loss and every gradient leaf under
    shared plans, on qwen3's smoke form (GQA G 2, qk-norm) and a causal
    MHA model; every attention weight gets a nonzero gradient."""
    from repro_torch.models import attn_backend as ab
    if arch_id == "mha_causal":
        jc, tc = _tiny_pair(dict(LAUNCH_SPLS, **PACKED_SPLS))
        jp, tp = params_pair(jc)
    else:
        jc, tc = arch_pair(arch_id, spls=dict(LAUNCH_SPLS, **PACKED_SPLS))
        jp, tp = params_pair(jc, jit=True)
    seen = []
    orig = ab.get_backend
    monkeypatch.setattr("repro_torch.models.attention.get_backend",
                        lambda name: seen.append(name) or orig(name))
    b = batch_np(jc, L=32, seed=3)
    tg, tmet, jg, jloss = _shared_plan_grads(jc, tc, jp, tp, b, monkeypatch)
    assert seen == ["torch_packed"] * tc.n_layers
    np.testing.assert_allclose(float(tmet["loss"]), float(jloss), rtol=1e-5)
    assert_grads_match(tg, jg)
    for w in ("wq", "wk", "wv", "wo"):
        g = tg["periods"][0]["attn"][w]
        assert all(float(g[i].abs().max()) > 0 for i in range(g.shape[0]))
