"""Dry-run cells of the single-pod sweep beyond qwen3-0.6b's
(``repro_torch.launch.dryrun.run_cell`` against the reference's
``repro.launch.dryrun.run_cell``), and the structured decode's output
projection on ``DTensor``s at h2o-danube3's head width.

Tolerances: counts and bytes are exact; the plain output projection is
bit-equal to the structured einsum.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]

# (arch, shape, argument bytes per device in the reference's dry run)
CELLS = (("h2o-danube3-4b", "decode_32k", 3664412224),
         ("mamba2-370m", "long_500k", 288566276))


@pytest.fixture(scope="module")
def reference():
    """The reference's results of :data:`CELLS`, from one subprocess (where
    it gets its 512 placeholder devices)."""
    cells = [(a, s) for a, s, _ in CELLS]
    code = ("import json, sys; from repro.launch.dryrun import run_cell; "
            f"print(json.dumps([run_cell(a, s) for a, s in {cells!r}]))")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=600)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {(r["arch"], r["shape"]): r for r in res}


@pytest.mark.parametrize("arch,shape,arg_bytes", CELLS)
def test_cell_matches_reference(reference, arch, shape, arg_bytes):
    """Argument and alias bytes (the decode cache or the Mamba state,
    updated in place), model FLOPs, chips, mesh and kind equal to the
    reference's dry run of the same cell on 16 x 16."""
    ref = reference[(arch, shape)]
    got = dryrun.run_cell(arch, shape)
    for k in ("argument_bytes_per_device", "alias_bytes_per_device"):
        assert got["memory"][k] == ref["memory"][k], k
    assert got["memory"]["argument_bytes_per_device"] == arg_bytes
    for k in ("model_flops_total", "chips", "mesh", "kind"):
        assert got[k] == ref[k], k


def _narrow(Dh: int):
    """h2o-danube3's heads (KV 8, G 4) at a narrow width, head width
    ``Dh``."""
    return dataclasses.replace(get_config("h2o-danube3-4b"), d_model=256,
                               head_dim=Dh)


def _products(monkeypatch, cfg, shape, op: str = "bmm", **kw) -> list:
    """The (first, second) operand shapes of every ``aten.<op>`` that each
    device runs in ``cfg``'s step of ``shape`` on the 16 x 16 ``fake``
    mesh (:func:`~repro_torch.launch.dryrun.analyze_step`)."""
    from repro_torch.launch import op_analysis
    from repro_torch.launch.mesh import make_production_mesh

    func, seen = getattr(torch.ops.aten, op).default, []

    class Record(op_analysis.OpAnalysis):
        def _record(self, f, args, kwargs, ins, outs, out):
            if f is func:
                seen.append((tuple(ins[0].shape), tuple(ins[1].shape)))
            return super()._record(f, args, kwargs, ins, outs, out)

    monkeypatch.setattr(op_analysis, "OpAnalysis", Record)
    with dryrun.fake_group(256):
        dryrun.analyze_step(cfg, shape, make_production_mesh(
            device_type="cpu"), **kw)
    return seen


@pytest.mark.parametrize("Dh", [120, 128])
def test_structured_output_proj_on_dtensors(Dh):
    """The decode's attention output -- batch over the data axis, a partial
    sum over the model axis (the cache's sequence is split there) -- goes
    through ``output_proj`` on the 16 x 16 ``fake`` mesh.  At Dh 120, which
    16 does not divide, it is one product over (KV, G, Dh) on each device
    (the whole of its batch rows) and one all-reduce of the output; at Dh
    128 ``DTensor``'s einsum lays the partial sum out on Dh (a
    reduce-scatter) and each device multiplies a sixteenth."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models.attention import output_proj
    from repro_torch.sharding.logical import axis_rules
    from repro_torch.sharding.rules import activation_rules

    cfg = _narrow(Dh)
    B, KV, G, D = 32, 8, 4, cfg.d_model
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with fm:
            o_loc = torch.empty(B // 16, KV, G, 1, Dh, dtype=torch.bfloat16)
            wo = torch.empty(KV, G, Dh, D, dtype=torch.bfloat16)
        o = DTensor.from_local(o_loc, mesh, (Shard(0), Partial()),
                               shape=(B, KV, G, 1, Dh),
                               stride=(KV * G * Dh, G * Dh, Dh, Dh, 1))
        w = distribute_tensor(wo, mesh, (Replicate(), Replicate()),
                              src_data_rank=None)
        with axis_rules(activation_rules(mesh), mesh), OpAnalysis(fm) as oa:
            out = output_proj(cfg, {"wo": w}, o)
        assert out.shape == (B, 1, D)
        assert tuple(out.placements) == (Shard(0), Replicate())
    out_bytes = B // 16 * D * 2
    if Dh == 120:
        assert oa.stats["dot_flops"] == 2 * (B // 16) * KV * G * Dh * D
        assert dict(oa.result(), traffic_bytes=0) == {
            "dot_flops": 2 * (B // 16) * KV * G * Dh * D, "traffic_bytes": 0,
            "coll:all-reduce": out_bytes, "collective_bytes": out_bytes}
    else:
        assert oa.stats["dot_flops"] == 2 * (B // 16) * KV * G * Dh * D // 16
        assert oa.stats["coll:reduce-scatter"] == out_bytes
        assert oa.stats["coll:all-reduce"] == out_bytes


@pytest.mark.parametrize("Dh", [120, 128])
def test_structured_output_proj_plain_is_the_einsum(Dh):
    """On plain tensors the structured output projection is the einsum
    over (KV, G, Dh), bit for bit, at either head width (the ``DTensor``
    form does not reach plain tensors)."""
    import numpy as np

    from repro_torch.models.attention import output_proj

    cfg = _narrow(Dh)
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.standard_normal((3, 8, 4, 5, Dh),
                                             dtype=np.float32))
    wo = torch.from_numpy(rng.standard_normal((8, 4, Dh, cfg.d_model),
                                              dtype=np.float32))
    got = output_proj(cfg, {"wo": wo}, o)
    assert torch.equal(got, torch.einsum("bkgld,kgdm->blm", o, wo))


def test_reference_count_misses_fused_dots():
    """The reference's ``parse_hlo_stats`` does not walk into fusions:
    XLA's CPU backend fuses a one-row product with its bf16 weight's
    convert, and the reference counts that dot 0 (its ``long_500k`` cells'
    projections); ``_dryrun_ops.fused_dot_flops`` counts it, as the
    port's dry run does."""
    import jax
    import jax.numpy as jnp
    from _dryrun_ops import fused_dot_flops

    from repro.launch.hlo_analysis import parse_hlo_stats

    D, F = 256, 512
    f = jax.jit(lambda x, w: jnp.einsum("bld,df->blf", x,
                                        w.astype(jnp.float32)))
    hlo = f.lower(jax.ShapeDtypeStruct((1, 1, D), jnp.float32),
                  jax.ShapeDtypeStruct((D, F), jnp.bfloat16)
                  ).compile().as_text()
    assert " fusion(" in hlo
    assert parse_hlo_stats(hlo)["dot_flops"] == 0.0
    assert fused_dot_flops(hlo) == 2.0 * D * F


def test_mamba_ssd_runs_each_devices_heads(monkeypatch):
    """A Mamba2 prefill on the 16 x 16 ``fake`` mesh (narrow: 16 heads of
    64, one per device; 16 rows, one per data rank; 2 chunks of 256): every
    product of the chunked SSD runs on its device's own heads and rows --
    a batch of 1 row x 2 chunks x 1 head -- as XLA runs the reference's,
    not on all 16 heads."""
    cfg = dataclasses.replace(get_config("mamba2-370m"), d_model=512,
                              n_layers=1, vocab_size=512)
    assert cfg.mamba_nheads == 16
    bmm = _products(monkeypatch, cfg, ShapeCfg("t", 512, 16, "prefill"))
    # C.B, the intra-chunk term, the chunk states, the inter-chunk term
    assert bmm == [((2, 256, 128), (2, 128, 256)),
                   ((2, 256, 256), (2, 256, 64)),
                   ((2, 64, 256), (2, 256, 128)),
                   ((2, 256, 128), (2, 128, 64))]


def test_zero_shards_kept_for_a_batch_of_one():
    """``gathers_zero``: a plain tensor, or rows over the data axis, gather
    the weights' ZeRO shards; a ``DTensor`` batch of one (rows not bound to
    the data axis) keeps them, and ``period_params(gather=False)`` hands
    the shards on as laid out."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import gathers_zero, period_params

    fm = FakeTensorMode(allow_non_fake_inputs=True)
    assert gathers_zero(torch.zeros(1, 1, 8))
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        dt = lambda shape, pl: distribute_tensor(
            fm.from_tensor(torch.empty(shape)), mesh, pl, src_data_rank=None)
        assert gathers_zero(dt((16, 1, 64), (Shard(0), Replicate())))
        assert not gathers_zero(dt((1, 1, 64), (Replicate(), Replicate())))
        w = dt((2, 64, 32), (Shard(1), Shard(2)))       # (periods, D, F)
        params = {"periods": ({"mlp": {"w_up": w}},)}
        kept, = period_params(params, 1, torch.float32, gather=False)
        gathered, = period_params(params, 1, torch.float32)
        assert tuple(kept["mlp"]["w_up"].placements) == (Shard(0), Shard(1))
        assert tuple(gathered["mlp"]["w_up"].placements) == (Replicate(),
                                                              Shard(1))


@pytest.mark.parametrize("B", [1, 16])
def test_decode_ffn_on_zero_shards(monkeypatch, B):
    """A narrow gemma2 (``fsdp``: D 512 over the 16 data ranks, d_ff 1024
    over the 16 model ranks) decode step on 16 x 16: with one row per data
    rank (B 16) every FFN product takes its weight gathered (D 512); with a
    batch of one (B 1, as ``long_500k``) each data rank multiplies its
    shard, D 32, as XLA splits the reference's."""
    cfg = dataclasses.replace(get_config("gemma2-27b"), d_model=512,
                              n_layers=2, vocab_size=512, d_ff=1024)
    assert cfg.fsdp
    mm = _products(monkeypatch, cfg, ShapeCfg("t", 256, B, "decode"), "mm")
    D = 512 if B == 16 else 512 // 16
    ffn = [((1, D), (D, 64)), ((1, D), (D, 64)), ((1, 64), (64, D))]
    # two blocks' up, gate and down products, then the (tied) LM head
    assert mm == ffn * 2 + [((1, D), (D, 32))]


def test_query_groups_projected_per_device(monkeypatch):
    """llama3's heads (KV 8, G 16: the query groups on the model axis) in
    a narrow train step (D 2048, Dh 16, 16 rows of 256, the layer's input
    split over the model axis by its sequence) on 16 x 16: each device
    projects q for its own group only (KV x Dh = 128 columns of ``wq``),
    forward and backward, as XLA does the reference's -- never all 2048
    columns."""
    cfg = dataclasses.replace(get_config("llama3-405b"), n_layers=1,
                              vocab_size=1024, d_model=2048, head_dim=16,
                              d_ff=512)
    bmm = _products(monkeypatch, cfg, ShapeCfg("t", 256, 16, "train"),
                    n_micro=1)
    assert bmm[0] == ((1, 256, 2048), (1, 2048, 128))     # q, forward
    assert len(bmm) == 24
    # (M, K, N) of each product: none spans all of wq's (D, H x Dh)
    mkn = [(a[1], a[2], b[2]) for a, b in bmm]
    assert not [d for d in mkn if d.count(2048) >= 2]


def test_flat_kv_heads_projected_once_per_device(monkeypatch):
    """h2o-danube3's flat heads (32 over 16: 2 a device, both in one KV
    group of G 4) in a narrow prefill (D 512, Dh 120) on 16 x 16: each
    device projects its group's k and v once (120 columns) and widens them
    to its 2 heads, as XLA computes the reference's -- not once per head.
    The widening is the per-head product's layout: on plain tensors, the
    group's copies widened equal ``wk`` repeated per head, bit for bit."""
    cfg = dataclasses.replace(get_config("h2o-danube3-4b"), n_layers=1,
                              vocab_size=512, d_model=512)
    bmm = _products(monkeypatch, cfg, ShapeCfg("t", 256, 16, "prefill"))
    # q (2 heads), k, v (one KV head each)
    assert bmm[:3] == [((1, 256, 512), (1, 512, 240)),
                       ((1, 256, 512), (1, 512, 120)),
                       ((1, 256, 512), (1, 512, 120))]

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 512, generator=gen)
    wk = torch.randn(512, 8, 120, generator=gen)
    per_head = torch.einsum("bld,dkh->bklh", x, wk.repeat_interleave(4, 1))
    shared = torch.einsum("bld,dkh->bklh", x, wk.repeat_interleave(2, 1))
    widened = shared[:, :, None].expand(2, 16, 2, 5, 120).reshape(
        2, 32, 5, 120)
    assert torch.equal(widened, per_head)
