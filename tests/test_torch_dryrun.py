"""The port's dry run (``repro_torch.launch.dryrun``, ``dryrun_all``,
``op_analysis``) against hand counts, ``FlopCounterMode``, the plain
steps and the reference's ``repro.launch.dryrun``; and the deprecated
``repro_torch.runtime.serve`` shim.

Tolerances: counts and bytes are exact.  The steps on ``DTensor`` inputs
over a one-rank ``gloo`` mesh give the plain steps' outputs within 1e-6 x
max |plain| (prefill, decode) and, for the train step, 1e-5 x max per
leaf: a ``DTensor`` loss sums the vocabulary in two reductions
(``amax``, then ``exp`` / ``sum``) where the plain one calls
``logsumexp``, and a ``DTensor`` batch takes every ``n_micro``-th row per
microbatch, so float32 sums run in another order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun, dryrun_all
from repro_torch.launch.op_analysis import OpAnalysis, op_collectives

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    return dataclasses.replace(get_config("qwen3-0.6b").smoke(),
                               remat=False)


@contextlib.contextmanager
def _mesh(data: int, model: int):
    from repro_torch.launch.mesh import make_cpu_mesh

    with dryrun.fake_group(data * model):
        yield make_cpu_mesh(data, model)


def _fake_dt(fm, mesh, shape, placements):
    from torch.distributed.tensor import distribute_tensor

    with fm:
        t = torch.empty(shape)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def test_op_analysis_hand_counts():
    """Per-device FLOPs of a row-sharded product, the all-reduce of a
    contraction-sharded one, an all-gather, and a shard-to-shard
    all-to-all counted as one on the ``fake`` CPU group."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    M, K, N = 64, 256, 512
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with _mesh(2, 2) as mesh:
        a = _fake_dt(fm, mesh, (M, K), (Shard(0), Replicate()))
        b = _fake_dt(fm, mesh, (K, N), (Replicate(), Shard(1)))
        with OpAnalysis(fm) as oa:
            a @ b
        assert oa.result()["dot_flops"] == 2 * (M // 2) * K * (N // 2)
        assert oa.result()["collective_bytes"] == 0

        a = _fake_dt(fm, mesh, (M, K), (Replicate(), Shard(1)))
        b = _fake_dt(fm, mesh, (K, N), (Replicate(), Shard(0)))
        with OpAnalysis(fm) as oa:
            (a @ b).redistribute(mesh, (Replicate(), Replicate()))
        r = oa.result()
        assert r["dot_flops"] == 2 * M * (K // 2) * N
        assert r["coll:all-reduce"] == M * N * 4 == r["collective_bytes"]

        a = _fake_dt(fm, mesh, (M, K), (Shard(0), Replicate()))
        with OpAnalysis(fm) as oa:
            a.redistribute(mesh, (Replicate(), Replicate()))
        assert op_collectives(oa.stats) == {"all-gather": M * K * 4,
                                            "total": M * K * 4}

        a = _fake_dt(fm, mesh, (M, K), (Replicate(), Shard(0)))
        with OpAnalysis(fm) as oa:
            a.redistribute(mesh, (Replicate(), Shard(1)))
        assert op_collectives(oa.stats) == {"all-to-all": M * K * 4 // 2,
                                            "total": M * K * 4 // 2}


def test_cpu_alltoall_fallback_is_found_by_name():
    """``OpAnalysis`` tells ``DTensor``'s CPU all-to-all (an all-gather and
    a chunk) from an all-gather by the name of the function that issues
    it: a torch release that renames or moves it fails here, before the
    counts go silently wrong."""
    import inspect

    from torch.distributed.tensor import _collective_utils

    from repro_torch.launch import op_analysis

    fn = getattr(_collective_utils, op_analysis._CPU_ALLTOALL)
    assert fn.__code__.co_name == op_analysis._CPU_ALLTOALL
    assert "all_gather" in inspect.getsource(fn)


def _plain_fake_flops(cfg, shape) -> float:
    """``FlopCounterMode`` over the same step on plain fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.device import route_as
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, make_train_step)
    from repro_torch.models import abstract_cache, abstract_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.tree import tree_map

    B, L = shape.global_batch, shape.seq_len
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    fake = lambda t: torch.zeros((), dtype=t.dtype) if t.dim() == 0 \
        else fm.from_tensor(torch.empty(t.shape, dtype=t.dtype))
    params = tree_map(fake, abstract_params(cfg))
    tok = lambda n: fake(torch.empty((B, n), dtype=torch.int32))
    with FlopCounterMode(display=False) as fc, route_as("cpu"):
        if shape.kind == "prefill":
            make_prefill_step(cfg)(params, tok(L))
        elif shape.kind == "decode":
            cache = tree_map(fake, abstract_cache(cfg, B, L))
            make_serve_step(cfg)(params, cache, tok(1),
                                 fake(torch.empty((B,), dtype=torch.int32)))
        else:
            opt = tree_map(fake, adamw_init(AdamWConfig(),
                                            abstract_params(cfg)))
            make_train_step(cfg, AdamWConfig(), warmup_cosine(3e-4, 100,
                                                              10000),
                            n_micro=2)(params, opt, {"inputs": tok(L),
                                                     "labels": tok(L)})
    return float(fc.get_total_flops())


@pytest.mark.parametrize("kind,B,L", [("prefill", 4, 32), ("decode", 4, 32),
                                      ("train", 4, 16)])
def test_one_rank_dot_flops_equal_flop_counter(kind, B, L):
    """On one rank the dry run's products are ``FlopCounterMode``'s on
    plain fake tensors; on a data-only 4 x 1 mesh each device computes a
    quarter of them (a batch that 4 divides)."""
    cfg = _smoke()
    shape = ShapeCfg("t", L, B, kind)
    with _mesh(1, 1) as mesh:
        got = dryrun.analyze_step(cfg, shape, mesh, n_micro=B // 2)
    assert got["stats"]["dot_flops"] == _plain_fake_flops(cfg, shape) > 0
    assert got["flop_counter_global"] == got["stats"]["dot_flops"]
    if kind == "prefill":
        with _mesh(4, 1) as mesh:
            four = dryrun.analyze_step(cfg, shape, mesh)
        assert four["stats"]["dot_flops"] * 4 == got["stats"]["dot_flops"]
        assert four["chips"] == 4


@contextlib.contextmanager
def _gloo_one_rank():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_cpu_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            yield make_cpu_mesh(1, 1)
        finally:
            dist.destroy_process_group()


def _max_err(got, ref) -> float:
    from torch.distributed.tensor import DTensor

    got = got.full_tensor() if isinstance(got, DTensor) else got
    return float((got.float() - ref.float()).abs().max())


def test_steps_on_dtensors_match_plain_steps():
    """The qwen3 smoke form's prefill, serve and train steps on ``DTensor``
    inputs over a one-rank ``gloo`` mesh give the plain steps' outputs
    (module docstring's tolerances)."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.device import route_as
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, make_train_step)
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.sharding.logical import axis_rules
    from repro_torch.sharding.rules import activation_rules
    from repro_torch.tree import leaves, tree_map

    cfg = _smoke()
    B, L = 4, 16
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (B, L + 1), generator=gen,
                         dtype=torch.int32)
    fresh = lambda: init_params(cfg, seed=0, device="cpu")

    def run(dt: bool, mesh=None):
        params = fresh()
        opt = adamw_init(AdamWConfig(), params)
        if dt:
            wrap = lambda t: distribute_tensor(t, mesh, (
                torch.distributed.tensor.Replicate(),) * 2)
            params, opt = tree_map(wrap, params), tree_map(wrap, opt)
        pre = make_prefill_step(cfg)
        dec = make_serve_step(cfg)
        train = make_train_step(cfg, AdamWConfig(),
                                warmup_cosine(3e-4, 100, 10000), n_micro=2)
        x = lambda t: wrap(t) if dt else t
        ctx = (axis_rules(activation_rules(mesh), mesh) if dt
               else contextlib.nullcontext())
        with route_as("cpu"), ctx, implicit_replication():
            logits, cache = pre(params, x(toks[:, :L]), L + 1)
            step, cache = dec(params, cache, x(toks[:, L:]),
                              x(torch.full((B,), L, dtype=torch.int32)))
            batch = {"inputs": x(toks[:, :L]), "labels": x(toks[:, 1:])}
            p2, _, metrics = train(params, opt, batch)
        return logits, step, leaves(p2), metrics["loss"]

    ref = run(False)
    with _gloo_one_rank() as mesh:
        got = run(True, mesh)
    for g, r in zip(got[:2], ref[:2]):
        assert _max_err(g, r) <= 1e-6 * float(r.abs().max())
    for g, r in zip(got[2], ref[2]):
        assert _max_err(g, r) <= 1e-5 * max(float(r.abs().max()), 1e-30)
    assert _max_err(got[3], ref[3]) <= 1e-5 * float(ref[3].abs())


def test_run_cell_matches_reference():
    """qwen3-0.6b ``decode_32k`` on 16 x 16: argument and alias bytes, model
    FLOPs, chips, mesh and kind equal to the reference's dry run (run in a
    subprocess, where it gets its 512 placeholder devices); the
    ``long_500k`` skip dicts equal letter for letter."""
    code = ("import json; from repro.launch.dryrun import run_cell; "
            "print(json.dumps([run_cell('qwen3-0.6b', 'decode_32k'), "
            "run_cell('qwen3-0.6b', 'long_500k')]))")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=600)
    ref, ref_skip = json.loads(out.stdout.strip().splitlines()[-1])
    got = dryrun.run_cell("qwen3-0.6b", "decode_32k")
    for k in ("argument_bytes_per_device", "alias_bytes_per_device"):
        assert got["memory"][k] == ref["memory"][k], k
    assert got["memory"]["argument_bytes_per_device"] == 2688909376
    for k in ("model_flops_total", "chips", "mesh", "kind"):
        assert got[k] == ref[k], k
    assert dryrun.run_cell("qwen3-0.6b", "long_500k") == ref_skip


def test_dryrun_all_resumes_and_filters(tmp_path, monkeypatch):
    calls = []

    def stub(arch, shape, multi_pod, spls, timeout):
        calls.append((arch, shape, multi_pod))
        return {"arch": arch, "shape": shape,
                "mesh": "2x16x16" if multi_pod else "16x16", "spls": spls,
                "trace_s": 0.1, "roofline": {"dominant": "memory_s"}}

    monkeypatch.setattr(dryrun_all, "run_one", stub)
    out = tmp_path / "sweep.jsonl"
    out.write_text(json.dumps({"arch": "qwen3-0.6b", "shape": "decode_32k",
                               "mesh": "16x16", "spls": False}) + "\nnot json\n")
    assert dryrun_all._done_keys(out) == {
        ("qwen3-0.6b", "decode_32k", "16x16", False)}
    dryrun_all.main(["--out", str(out), "--meshes", "16x16",
                     "--only", "qwen3-0.6b:decode_32k",
                     "qwen3-0.6b:prefill_32k"])
    assert calls == [("qwen3-0.6b", "prefill_32k", False)]
    dryrun_all.main(["--out", str(out), "--meshes", "16x16",
                     "--only", "qwen3-0.6b:prefill_32k"])
    assert len(calls) == 1                      # resumed: nothing left
    assert len(dryrun_all._done_keys(out)) == 2


def test_runtime_serve_shim_warns_and_forwards():
    import importlib

    import repro_torch.runtime.serve as shim
    from repro_torch import serving

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        importlib.reload(shim)
        got = {name: getattr(shim, name) for name in shim.__all__}
    assert got == {name: getattr(serving, name) for name in shim.__all__}
    assert sorted(got) == ["PagedServingEngine", "Request", "ServeConfig",
                           "ServingEngine"]
    assert sum(issubclass(x.category, DeprecationWarning) for x in w) == 5
    with pytest.raises(AttributeError):
        shim.no_such_name
