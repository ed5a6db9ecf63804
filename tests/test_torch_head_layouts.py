"""The flat and padded head layouts against the reference's under a 16-wide
model axis, on the CPU.

The reference picks these layouts only under a mesh whose model axis is
longer than 1, so its side runs in one subprocess with 16 host devices
(``tests/_ref_mesh_worker.py``) under ``axis_rules(activation_rules(m),
m)``, ``m = make_cpu_mesh(1, 16)``; the port's under the same rules on a
``DeviceMesh`` (1, 16) over the ``fake`` process group.  Cases at small
widths: flat (H 16, KV 8: neither KV nor G divides 16, H does) and padded
(H 24, KV 8: nothing divides; H' 32), each with and without SPLS.

Tolerances (PERF.md's table): single modules (``attention_forward``)
rtol = atol = 1e-5; blocks, logits, prefill caches 1e-4; the flat SPLS
plans (exact and progressive) equal exactly, on bit-identical normalized
inputs (both blocks normalize with the reference's ``rms_norm``).  The
padded block's output is held against the structured block's (no mesh)
at 1e-4, and the padded SPLS block equals the padded dense block (no plan
in padded mode).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro.models.common import rms_norm as jrms
from repro_torch.core import planner as tplanner
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as tm
from repro_torch.sharding import axis_rules
from repro_torch.sharding.rules import activation_rules

from _torch_parity import cfg_pair, fake_world, n, params_pair, t

MODEL_AXIS = 16
BLOCK = dict(rtol=1e-4, atol=1e-4)
MODULE = dict(rtol=1e-5, atol=1e-5)
FLAT = dict(n_heads=16, n_kv_heads=8, head_dim=16, qk_norm=True)
PADDED = dict(n_heads=24, n_kv_heads=8, head_dim=16)
OFF = dict(enabled=False)
# name, layout, config, SPLS, reference backend, port backend, plans, model
CASES = [
    ("flat_dense", "flat", FLAT, OFF, "xla_dense", "torch_dense", False,
     True),
    ("flat_spls", "flat", FLAT, {}, "xla_dense", "torch_dense", True,
     False),
    ("flat_spls_flash", "flat", FLAT, {}, "pallas_flash", "torch_flash",
     False, False),
    ("padded_dense", "padded", PADDED, OFF, "xla_dense", "torch_dense",
     False, True),
    ("padded_spls", "padded", PADDED, {}, "xla_dense", "torch_dense",
     False, False),
]
B, L = 2, 16


def _inputs(name, jc, jp) -> dict:
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    pj = jax.tree.map(lambda a: a[0], jp["periods"][0])
    x = rng.normal(size=(B, L, jc.d_model)).astype(np.float32)
    return {"x": x,
            "xn": np.asarray(jrms(jnp.asarray(x), pj["ln1"], jc.norm_eps)),
            "tokens": rng.integers(0, jc.vocab_size, (B, L)).astype(
                np.int32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's inputs, and the reference's outputs from one
    subprocess with 16 host devices."""
    tmp = tmp_path_factory.mktemp("head_layouts")
    arrays, spec, pairs = {}, [], {}
    for name, _, kw, spls, jbe, _, plans, model in CASES:
        jc, tc = cfg_pair("mha", spls=spls, **kw)
        jp, tp = params_pair(jc)
        pairs[name] = (jc, tc, jp, tp)
        for i, leaf in enumerate(jax.tree.leaves(jp)):
            arrays[f"{name}/p{i}"] = np.asarray(leaf)
        for k, v in _inputs(name, jc, jp).items():
            arrays[f"{name}/{k}"] = v
        spec.append(dict(name=name, kind="mha", spls=spls, cfg=kw,
                         backend=jbe, plans=plans, model=model))
    np.savez(tmp / "in.npz", spec=np.asarray(json.dumps(spec)), **arrays)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{MODEL_AXIS}",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           str(root / "tests")]))
    subprocess.run([sys.executable, str(root / "tests" /
                                        "_ref_mesh_worker.py"),
                    "head_layouts", str(tmp / "in.npz"),
                    str(tmp / "out.npz")], env=env, check=True,
                   timeout=600)
    with np.load(tmp / "out.npz") as f:
        out = dict(f)
    return arrays, out, pairs


def _reference_norm(monkeypatch) -> None:
    """The port's blocks normalize with the reference's ``rms_norm``, so
    both plans see bit-identical inputs (a last-bit difference can flip a
    near-tie of the quantized PAM)."""
    def norm(x, scale, eps):
        return t(np.asarray(jrms(jnp.asarray(n(x)), jnp.asarray(n(scale)),
                                 eps)))
    monkeypatch.setattr(tblocks, "rms_norm", norm)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layout_equals_reference(reference, case, monkeypatch):
    arrays, out, pairs = reference
    name, mode, _, _, _, tbe, plans, model = case
    jc, tc, jp, tp = pairs[name]
    a = lambda k: arrays[f"{name}/{k}"]
    pt = tm.period_params(tp, 0, torch.float32)[0]
    _reference_norm(monkeypatch)
    with fake_world(MODEL_AXIS):
        mesh = make_cpu_mesh(1, MODEL_AXIS)
        with axis_rules(activation_rules(mesh), mesh):
            assert tattn.head_shard_mode(tc) == mode == str(
                out[f"{name}/mode"])
            got = tattn.attention_forward(tc, pt["attn"], t(a("xn")),
                                          backend=tbe)
            np.testing.assert_allclose(n(got), out[f"{name}/attn"],
                                       **MODULE)
            blk = tblocks.block_forward(tc, tc.period[0], pt, t(a("x")),
                                        attn_backend=tbe)
            np.testing.assert_allclose(n(blk), out[f"{name}/block"],
                                       **BLOCK)
            if plans:
                for tag, fn in (("exact", tplanner.build_block_plan),
                                ("progressive",
                                 tplanner.build_block_plan_progressive)):
                    plan = fn(tc, pt, t(a("xn")))
                    assert plan.attn_mask.shape[1:3] == (16, 1)
                    for f in plan._fields:
                        np.testing.assert_array_equal(
                            n(getattr(plan, f)), out[f"{name}/{tag}/{f}"],
                            err_msg=f"{tag} {f}")
            if model:
                cfg = dataclasses.replace(tc, attn_backend=tbe)
                toks = torch.from_numpy(a("tokens"))
                np.testing.assert_allclose(
                    n(tm.forward(cfg, tp, toks)), out[f"{name}/logits"],
                    **BLOCK)
                logits, cache = tm.prefill(cfg, tp, toks, max_len=24)
                np.testing.assert_allclose(
                    n(logits), out[f"{name}/prefill_logits"], **BLOCK)
                for f in ("k", "v"):
                    np.testing.assert_allclose(
                        n(getattr(cache[0], f)), out[f"{name}/cache_{f}"],
                        **BLOCK)
            if mode == "padded":
                # no plan in padded mode: SPLS on runs the dense block
                dense = tblocks.block_forward(
                    dataclasses.replace(tc, spls=dataclasses.replace(
                        tc.spls, enabled=False)), tc.period[0], pt,
                    t(a("x")), attn_backend=tbe)
                assert torch.equal(blk, dense)
    # the padded heads add nothing: padded vs the structured layout (no
    # mesh), in both packages
    if mode == "padded":
        jdense = dataclasses.replace(jc, spls=dataclasses.replace(
            jc.spls, enabled=False))
        tdense = dataclasses.replace(tc, spls=dataclasses.replace(
            tc.spls, enabled=False))
        pj = jax.tree.map(lambda a_: a_[0], jp["periods"][0])
        ref_structured = jblocks.block_forward(
            jdense, jc.period[0], pj, jnp.asarray(a("x")),
            attn_backend="xla_dense")
        np.testing.assert_allclose(out[f"{name}/block"],
                                   np.asarray(ref_structured), **BLOCK)
        structured = tblocks.block_forward(tdense, tc.period[0], pt,
                                           t(a("x")), attn_backend=tbe)
        assert tattn.head_shard_mode(tc) == "structured"
        np.testing.assert_allclose(n(blk), n(structured), **BLOCK)


def test_decode_keeps_structured_layout(reference):
    """``attention_decode`` under the flat layout's mesh projects in the
    structured layout, as the reference's; the prefill cache is the
    structured ``(B, KV, S, Dh)``."""
    _, out, pairs = reference
    jc, tc, jp, tp = pairs["flat_dense"]
    assert out["flat_dense/cache_k"].shape[2] == tc.n_kv_heads
    pt = tm.period_params(tp, 0, torch.float32)[0]
    cache = tattn.init_kv_cache(tc, B, 8, torch.float32, "cpu")
    x = torch.randn((B, 1, tc.d_model), generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.tensor([0, 3], dtype=torch.int32)
    want, _ = tattn.attention_decode(tc, pt["attn"], x, tattn.KVCache(
        cache.k.clone(), cache.v.clone()), pos)
    with fake_world(MODEL_AXIS):
        mesh = make_cpu_mesh(1, MODEL_AXIS)
        with axis_rules(activation_rules(mesh), mesh):
            assert tattn.head_shard_mode(tc) == "flat"
            got, _ = tattn.attention_decode(tc, pt["attn"], x, cache, pos)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["structured", "flat"])
def test_plan_context_head_names_equal_reference(mode):
    """``PlanContext.head_names``, the logical axes of a plan's two head
    dims, names them as the reference's does in each layout."""
    from repro.core.planner import PlanContext as JPlanContext

    jc, tc = cfg_pair("mha", **FLAT)
    assert tplanner.PlanContext.for_config(tc, mode).head_names == \
        JPlanContext.for_config(jc, mode).head_names
