"""The dry run's trip count (``repro_torch.loops.scan`` under a
trip-counting ``OpAnalysis``), the predictor's per-device layout on
``DTensor``s, and ``DTensor``'s own index arithmetic in ``OpAnalysis``.

Tolerances: dot FLOPs, collective bytes by type and argument / output /
alias bytes exact; traffic and temp within 1 % of the unrolled run (the
differences measured are stated per test); loops without an analysis
bit-equal to the plain loops they replace; the predictor's ``DTensor``
form within 1e-6 x max of the plain one (the same products, laid out by
head).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun

_spls = dryrun.spls_config


@contextlib.contextmanager
def _mesh(data: int, model: int):
    from repro_torch.launch.mesh import make_cpu_mesh

    with dryrun.fake_group(data * model):
        yield make_cpu_mesh(data, model)


@pytest.mark.parametrize("kind,B,L", [("prefill", 4, 8192),
                                      ("train", 8, 256)])
def test_trip_count_equals_unrolled(kind, B, L):
    """qwen3-0.6b's smoke form with SPLS on a 2 x 2 ``fake`` mesh: a
    prefill past the chunked threshold (16 row blocks of 512, 12
    bisection steps each, 3 KV chunks) and a train step of 2 microbatches,
    counted by trip count and unrolled.  Measured on this repo's CPU host
    (torch 2.13): prefill traffic 9.5e-6 and temp 2.7e-4 below the
    unrolled run's (the skipped blocks' plan rows are stood in at once,
    so the last block runs with fewer of them live); train traffic 2.1e-3
    below, temp equal -- ``DTensor`` plans each layout once a process and
    its planning's own ops on plain tensors are counted: the unrolled run
    here comes first and plans them, the trip-counted one finds them
    planned."""
    cfg = _spls(dataclasses.replace(get_config("qwen3-0.6b").smoke(),
                                    remat=False))
    shape = ShapeCfg("t", L, B, kind)
    got = {}
    for trip in (False, True):
        with _mesh(2, 2) as mesh:
            got[trip] = dryrun.analyze_step(
                cfg, shape, mesh, n_micro=B // 4 if kind == "train" else None,
                trip_count=trip)
    one, full = got[True], got[False]
    if kind == "train":
        assert one["n_micro"] == full["n_micro"] == 2
    for k, v in full["stats"].items():
        if k == "traffic_bytes":
            assert one["stats"][k] == pytest.approx(v, rel=0.01)
        else:
            assert one["stats"][k] == v, k
    assert one["stats"]["dot_flops"] > 0 and one["stats"]["coll:all-reduce"]
    mem, mem_full = one["memory"], full["memory"]
    for k in ("argument_bytes_per_device", "output_bytes_per_device",
              "alias_bytes_per_device"):
        assert mem[k] == mem_full[k], k
    assert mem["temp_bytes_per_device"] == pytest.approx(
        mem_full["temp_bytes_per_device"], rel=0.01)
    assert one["flop_counter_global"] == full["flop_counter_global"]


# -- the loops without an analysis: the plain loops they replace -----------

def _old_bisect(pam32, k, n_iters=12):
    hi = pam32.amax(-1, keepdim=True)
    lo = torch.where(pam32 < -1e29, hi, pam32).amin(-1, keepdim=True)
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        cnt = (pam32 >= mid).sum(-1, keepdim=True)
        lo = torch.where(cnt >= k, mid, lo)
        hi = torch.where(cnt >= k, hi, mid)
    return pam32 >= lo


def _old_plan_scan(qh, kh, k_ratio, s_threshold, window, f_threshold,
                   row_block):
    from repro_torch.core.spls_chunked import ChunkedPlan, plan_chunk
    from repro_torch.core.topk import topk_count

    L = qh.shape[-2]
    k = topk_count(L, k_ratio)
    kv_keep = torch.zeros_like(qh[..., 0], dtype=torch.bool)
    crit, lead, fcrit, flead = [], [], [], []
    for r0 in range(0, L, row_block):
        pb = plan_chunk(qh[..., r0:r0 + row_block, :], kh, k=k, row0=r0,
                        n_valid_rows=row_block, n_cols=L,
                        s_threshold=s_threshold, window=window,
                        f_threshold=f_threshold, causal=True)
        kv_keep = kv_keep | pb.kv_any
        crit.append(pb.q_critical)
        lead.append(pb.q_leader)
        fcrit.append(pb.ffn_critical)
        flead.append(pb.ffn_leader)
    return ChunkedPlan(q_critical=torch.cat(crit, -1),
                       q_leader=torch.cat(lead, -1), kv_keep=kv_keep,
                       ffn_critical=torch.cat(fcrit, -1),
                       ffn_leader=torch.cat(flead, -1))


def _old_chunked_attention(q, k, v, plan, q_capacity, kv_capacity,
                           kv_chunk):
    import torch.nn.functional as F

    from repro_torch.core.sparse_exec import (_NEG, gather_rows,
                                              pack_by_mask, unpack_by_leader)

    B, KVp, Gp, L, Dh = q.shape
    scale = Dh ** -0.5
    Cq, Ck = min(q_capacity, L), min(kv_capacity, L)
    kv_chunk = min(kv_chunk, Ck)
    q_perm, q_slot = pack_by_mask(plan.q_critical, Cq)
    kv_perm, _ = pack_by_mask(plan.kv_keep, Ck)
    qp = gather_rows(q, q_perm)
    kp = gather_rows(k[:, :, None].expand(B, KVp, Gp, L, Dh), kv_perm)
    vp = gather_rows(v[:, :, None].expand(B, KVp, Gp, L, Dh), kv_perm)
    kv_alive = torch.gather(plan.kv_keep, -1, kv_perm.long())
    pad = (-Ck) % kv_chunk
    if pad:
        kp, vp = F.pad(kp, (0, 0, 0, pad)), F.pad(vp, (0, 0, 0, pad))
        kv_perm, kv_alive = F.pad(kv_perm, (0, pad)), F.pad(kv_alive,
                                                             (0, pad))
        Ck += pad
    qi = q_perm[..., :, None]
    m_run = torch.full_like(qp[..., 0], _NEG, dtype=torch.float32)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros_like(qp, dtype=torch.float32)
    for c0 in range(0, Ck, kv_chunk):
        k_c, v_c = kp[..., c0:c0 + kv_chunk, :], vp[..., c0:c0 + kv_chunk, :]
        id_c = kv_perm[..., None, c0:c0 + kv_chunk]
        s = torch.matmul(qp, k_c.transpose(-1, -2)).float() * scale
        mask = kv_alive[..., None, c0:c0 + kv_chunk] & (id_c <= qi)
        s = s.masked_fill(~mask, _NEG)
        m_new = torch.maximum(m_run, s.amax(-1))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None]) * mask.float()
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p.to(v_c.dtype),
                                                   v_c).float()
        m_run = m_new
    op = (acc / l_run.clamp(min=1e-9)[..., None]).to(q.dtype)
    return unpack_by_leader(op, q_slot, plan.q_leader)


def _old_loss_grad(cfg, params, batch, n_micro):
    from repro_torch.launch.steps import _microbatch, _value_and_grad
    from repro_torch.tree import leaves, tree_map

    acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params)
    loss_acc = torch.zeros((), dtype=torch.float32)
    for i in range(n_micro):
        mb = {k: _microbatch(v, n_micro, i) for k, v in batch.items()}
        loss, _, grads = _value_and_grad(cfg, params, mb)
        with torch.no_grad():
            for a, g in zip(leaves(acc), leaves(grads)):
                a.add_(g.float() / n_micro)
            loss_acc = loss_acc + loss / n_micro
    return acc, loss_acc


def _bit_equal(a, b) -> bool:
    from repro_torch.tree import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("ctx", ["none", "flop_counter", "analysis"])
def test_loops_without_trip_count_are_the_plain_loops(ctx):
    """With no trip-counting analysis active -- none at all, a
    ``FlopCounterMode``, an ``OpAnalysis`` without ``trip_count`` -- the
    planner's row blocks, its bisection steps, the chunked attention's KV
    chunks and the microbatches run every iteration and give the plain
    loops' tensors bit for bit (under the same mode)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.spls_chunked import (bisect_topk_mask,
                                               chunked_plan_scan)
    from repro_torch.core.sparse_exec import spls_attention_chunked
    from repro_torch.device import route_as
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.launch.steps import make_loss_grad
    from repro_torch.models import init_params

    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    qh, kh = f32(1, 2, 2, 64, 8), f32(1, 2, 64, 8)
    pam = f32(2, 3, 16, 64)
    v = f32(1, 2, 64, 8)
    cfg = _spls(dataclasses.replace(get_config("qwen3-0.6b").smoke(),
                                    remat=False))
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 17),
                                         dtype=np.int64).astype(np.int32))
    batch = {"inputs": toks[:, :16], "labels": toks[:, 1:]}
    kw = dict(k_ratio=0.12, s_threshold=0.6, window=8, f_threshold=6,
              row_block=16)

    def run():
        plan = chunked_plan_scan(qh, kh, causal=True, **kw)
        with route_as("cpu"):
            lg = make_loss_grad(cfg, n_micro=2)(params, batch)
        return (bisect_topk_mask(pam, 7), plan,
                spls_attention_chunked(qh, kh, v, plan, 40, 44, kv_chunk=16),
                lg[0], lg[1]["loss"])

    def old():
        plan = _old_plan_scan(qh, kh, **kw)
        with route_as("cpu"):
            grads, loss = _old_loss_grad(cfg, params, batch, 2)
        return (_old_bisect(pam, 7), plan,
                _old_chunked_attention(qh, kh, v, plan, 40, 44, 16), grads,
                loss)

    # a mode decomposes some ops (as FlopCounterMode does): both loops run
    # under the same one
    mode = {"none": contextlib.nullcontext,
            "flop_counter": lambda: FlopCounterMode(display=False),
            "analysis": OpAnalysis}[ctx]
    with mode():
        got = run()
    with mode():
        want = old()
    for g, w in zip(got, want):
        assert _bit_equal(g, w)


def test_scan_counts_a_body_by_trip_count():
    """Under a trip-counting ``OpAnalysis`` :func:`repro_torch.loops.scan`
    runs its body once and counts its products ``n`` times; the skipped
    iterations' outputs are stood in, of their shapes and dtypes, and held
    live; a loop whose outputs need a gradient runs every iteration."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.loops import scan

    fm = FakeTensorMode()
    with fm:
        a, b = torch.empty(64, 32), torch.empty(32, 16)
    calls = []

    def body(c, i):
        calls.append(i)
        return c + 1, (a @ b, i)

    with OpAnalysis(fm, trip_count=True) as oa:
        carry, ys = scan(body, torch.zeros(()), 5)
        assert oa.stats["dot_flops"] == 5 * 2 * 64 * 32 * 16
        assert calls == [0]
        assert [tuple(y[0].shape) for y in ys] == [(64, 16)] * 5
        assert [y[1] for y in ys] == [0] * 5
        assert oa.live_bytes >= 5 * 64 * 16 * 4
        calls.clear()
        w = torch.ones(3, requires_grad=True)
        carry, ys = scan(lambda c, i: (c * w, None), torch.ones(3), 4)
        assert carry.requires_grad
    with OpAnalysis(fm) as plain:
        scan(body, torch.zeros(()), 3)
    assert calls == [0, 1, 2]
    assert plain.stats["dot_flops"] == 3 * 2 * 64 * 32 * 16


# -- the predictor on DTensors ----------------------------------------------

def _predictor_products(monkeypatch, cfg, L: int = 256) -> list:
    """(M, K, N) of every product of ``cfg``'s (one period, narrow) SPLS
    prefill of 16 rows on the 16 x 16 ``fake`` mesh, per device."""
    from repro_torch.launch import op_analysis
    from repro_torch.launch.mesh import make_production_mesh

    seen = []
    prods = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)

    class Record(op_analysis.OpAnalysis):
        def _record(self, f, args, kwargs, ins, outs, out):
            if f in prods:
                a, b = ins[0].shape, ins[1].shape
                seen.append((math.prod(a[:-1]), a[-1], b[-1]))
            return super()._record(f, args, kwargs, ins, outs, out)

    monkeypatch.setattr(op_analysis, "OpAnalysis", Record)
    with dryrun.fake_group(256):
        dryrun.analyze_step(_spls(cfg), ShapeCfg("t", L, 16, "prefill"),
                            make_production_mesh(device_type="cpu"))
    return seen


@pytest.mark.parametrize("arch,q_cols,k_cols", [
    # flat: qwen3 (H 16, one head a device; wk repeated per head)
    ("qwen3-0.6b", 128, 128),
    # flat: h2o-danube3 (2 heads a device in one KV group: one KV head)
    ("h2o-danube3-4b", 240, 120),
    # structured, KV on the model axis: gemma2 (KV 16, G 2)
    ("gemma2-27b", 256, 128),
    # structured, query groups on the model axis: llama3 (KV 8, G 16);
    # its KV heads (8) do not divide 16 and k stays whole, as XLA's
    ("llama3-405b", 8 * 128, 8 * 128)])
def test_predictor_projects_each_devices_heads(monkeypatch, arch, q_cols,
                                               k_cols):
    """The SPLS predictor's q / k products on the 16 x 16 ``fake`` mesh (a
    narrow one-layer prefill, 16 rows of 256, one per data rank): each
    device projects its own heads' ``wq`` / ``wk`` columns, as the
    attention's projections do and as XLA runs the reference's -- not all
    of ``wq`` (H x Dh columns) as before the layout moved ahead of the
    product."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.period), vocab_size=512,
                              d_model=1024, d_ff=512)
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    prods = _predictor_products(monkeypatch, cfg)
    assert prods[:2] == [(256, 1024, q_cols), (256, 1024, k_cols)]
    assert q_cols < H * Dh


@pytest.mark.parametrize("mode", ["flat", "structured"])
@pytest.mark.parametrize("act_axis", [None, -1])
def test_predictor_by_head_equals_plain(mode, act_axis):
    """The predictor's ``DTensor`` form (one-rank ``gloo`` mesh, no rules)
    gives the plain prediction laid out in ``mode``: per-tensor and
    per-token scales alike."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.core.planner import PlanContext
    from repro_torch.launch.mesh import make_cpu_mesh

    cfg = _spls(dataclasses.replace(get_config("h2o-danube3-4b").smoke()))
    ctx = dataclasses.replace(PlanContext.for_config(cfg), mode=mode)
    KV, G, Dh, D = ctx.KV, ctx.G, ctx.Dh, ctx.D
    rng = np.random.default_rng(1)
    p = {"wq": torch.from_numpy(rng.standard_normal(
             (D, KV, G, Dh)).astype(np.float32)),
         "wk": torch.from_numpy(rng.standard_normal(
             (D, KV, Dh)).astype(np.float32))}
    xn = torch.from_numpy(rng.standard_normal((2, 24, D)).astype(np.float32))
    plain = dataclasses.replace(ctx, mode="structured")
    qh, kh = plain.predict_heads(p, xn, act_axis=act_axis)
    if mode == "flat":
        qh = qh.reshape(2, KV * G, 1, 24, Dh)
        kh = kh.repeat_interleave(G, 1)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_cpu_mesh(1, 1)
            dt = lambda t: distribute_tensor(t, mesh, (Replicate(),) * 2)
            gq, gk = ctx.predict_heads({k: dt(w) for k, w in p.items()},
                                       dt(xn), act_axis=act_axis)
            gq, gk = gq.full_tensor(), gk.full_tensor()
        finally:
            dist.destroy_process_group()
    for g, w in ((gq, qh), (gk, kh)):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())


# -- DTensor's index arithmetic ---------------------------------------------

def test_dtensor_index_ops_skip_the_meta_check(monkeypatch):
    """Integer ops that ``DTensor``'s own code issues (here
    ``Shard._split_tensor`` padding an index tensor, as its redistribution
    planner does) are counted as without the check but not rerun on
    ``meta``: under a bound that every such op exceeds nothing raises,
    and with the frames not recognized the rerun raises.  A plain float
    tensor, or an integer one that the step makes itself, over
    ``max_plain_bytes`` still raises."""
    from torch.distributed.tensor import Shard

    from repro_torch.launch import op_analysis
    from repro_torch.launch.op_analysis import OpAnalysis

    idx = torch.arange(30000 - 1)

    def split(bound):
        with OpAnalysis(max_plain_bytes=bound) as oa:
            parts, pads = Shard(0)._split_tensor(idx, 3, with_padding=True)
        assert sum(pads) == 1 and len(parts) == 3
        return dict(oa.stats)

    counted = split(16)
    assert counted == split(None) and counted["traffic_bytes"] > 0
    monkeypatch.setattr(op_analysis, "_issued_by_dtensor", lambda: False)
    with pytest.raises(MemoryError, match="plain tensor"):
        split(16)
    monkeypatch.undo()
    with pytest.raises(MemoryError, match="plain tensor"):
        with OpAnalysis(max_plain_bytes=1 << 16):
            torch.zeros(1 << 15) + 1
    with pytest.raises(MemoryError, match="plain tensor"):
        with OpAnalysis(max_plain_bytes=1 << 16):
            torch.arange(1 << 15) * 2


# -- DTensor's redistribution planner, memoized ------------------------------

def test_memoized_planner_gives_the_same_plans(monkeypatch):
    """One product on the 2 x 16 x 16 ``fake`` mesh (a batch and sequence
    sharded over pod and data, heads over model) planned under
    ``_memoized_redistribute_planner``: the memo is installed inside the
    block and gone after it, and the last redistributions it planned --
    the ones that reused the most memoized expansions -- replanned by
    the unmemoized planner give the same plans."""
    import torch.distributed.tensor._redistribute as R
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    Planner = R.DTensorRedistributePlanner
    expand = Planner.__dict__["get_next_state"]
    calls = []
    plan = R._gen_transform_infos_non_cached

    def recording(*args, **kwargs):
        out = plan(*args, **kwargs)
        calls.append((args, kwargs, str(out)))
        return out

    monkeypatch.setattr(R, "_gen_transform_infos_non_cached", recording)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with dryrun.fake_group(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")

        def dt(shape, placements):
            with fake:
                t = torch.empty(shape, dtype=torch.bfloat16)
            return distribute_tensor(t, mesh, placements, src_data_rank=None)

        x = dt((64, 256, 64), (Shard(0), Shard(1), Replicate()))
        w = dt((64, 16, 16), (Replicate(), Replicate(), Shard(1)))
        with dryrun._memoized_redistribute_planner():
            assert Planner.get_next_state is not expand
            torch.einsum("bld,dhe->bhle", x, w)
        assert Planner.get_next_state is expand
        expanded = [0]

        def counting(self, *args):
            expanded[0] += 1
            return expand(self, *args)

        monkeypatch.setattr(Planner, "get_next_state", counting)
        searched = 0
        for args, kwargs, memoized in reversed(calls):
            before = expanded[0]
            assert str(plan(*args, **kwargs)) == memoized
            searched += expanded[0] > before
            if searched == 8:
                break
    assert searched == 8
