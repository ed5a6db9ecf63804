"""The reference's side of the port's mesh-bound parity tests, run in a
process of its own: jax fixes its device count at its first import, and
these cases need a mesh of several host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=16 \\
        python tests/_ref_mesh_worker.py head_layouts IN.npz OUT.npz

(``compressed_mean`` with 4 devices likewise.)

``IN.npz`` holds a JSON ``spec`` and the numpy inputs; ``OUT.npz`` gets
the reference's outputs under the names the spec gives.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np


def _params(jc, arrays, prefix):
    from repro.models import init_params
    shapes = jax.eval_shape(lambda: init_params(jc, jax.random.PRNGKey(0)))
    leaves, tree = jax.tree.flatten(shapes)
    return jax.tree.unflatten(tree, [jnp.asarray(arrays[f"{prefix}{i}"])
                                     for i in range(len(leaves))])


def head_layouts(spec, arrays) -> dict:
    """Every case under ``axis_rules(activation_rules(m), m)`` with ``m =
    make_cpu_mesh(1, 16)``: blocks, plans, attention, forward, prefill."""
    from _torch_parity import cfg_pair
    from repro.core.planner import (build_block_plan,
                                    build_block_plan_progressive)
    from repro.launch.mesh import make_cpu_mesh
    from repro.models import attention as jattn
    from repro.models import blocks as jblocks
    from repro.models import model as jm
    from repro.sharding.logical import axis_rules
    from repro.sharding.rules import activation_rules

    m = make_cpu_mesh(1, jax.device_count())
    out = {}
    with axis_rules(activation_rules(m), m):
        for case in spec:
            name = case["name"]
            jc, _ = cfg_pair(case["kind"], spls=case["spls"], **case["cfg"])
            jp = _params(jc, arrays, f"{name}/p")
            pj = jax.tree.map(lambda a: a[0], jp["periods"][0])
            out[f"{name}/mode"] = np.asarray(jattn.head_shard_mode(jc))
            x = jnp.asarray(arrays[f"{name}/x"])
            xn = jnp.asarray(arrays[f"{name}/xn"])
            be = case["backend"]
            # jitted: eager ops over 16 devices cost seconds each case
            out[f"{name}/attn"] = np.asarray(jax.jit(
                lambda pa, xn: jattn.attention_forward(
                    jc, pa, xn, backend=be))(pj["attn"], xn))
            out[f"{name}/block"] = np.asarray(jax.jit(
                lambda pb, x: jblocks.block_forward(
                    jc, jc.period[0], pb, x, attn_backend=be))(pj, x))
            if jc.spls.enabled and case["plans"]:
                for tag, fn in (("exact", build_block_plan),
                                ("progressive",
                                 build_block_plan_progressive)):
                    plan = jax.jit(lambda pb, xn: fn(jc, pb, xn))(pj, xn)
                    for f in plan._fields:
                        out[f"{name}/{tag}/{f}"] = np.asarray(
                            getattr(plan, f))
            if case["model"]:
                cfg = dataclasses.replace(jc, attn_backend=be)
                toks = jnp.asarray(arrays[f"{name}/tokens"])
                out[f"{name}/logits"] = np.asarray(jm.forward(cfg, jp, toks))
                logits, cache = jm.prefill(cfg, jp, toks, max_len=24)
                out[f"{name}/prefill_logits"] = np.asarray(logits)
                out[f"{name}/cache_k"] = np.asarray(cache[0].k)
                out[f"{name}/cache_v"] = np.asarray(cache[0].v)
    return out


def compressed_mean(spec, arrays) -> dict:
    """Two steps of the reference's ``compressed_mean`` under
    ``shard_map`` over a ``data`` axis of all host devices, rank r's
    gradients ``g0[r]``, ``g1[r]``."""
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.optim.grad_compress import compressed_mean as cm

    mesh = Mesh(np.array(jax.devices()), ("data",))
    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:  # jax < 0.6
        from jax.experimental.shard_map import shard_map

    def two_steps(g0, g1):
        m0, r0 = cm(g0[0], "data")
        m1, r1 = cm(g1[0], "data", residual=r0)
        return m0[None], r0[None], m1[None], r1[None]

    f = shard_map(two_steps, mesh=mesh, in_specs=(P("data"), P("data")),
                  out_specs=(P("data"),) * 4)
    m0, r0, m1, r1 = f(jnp.asarray(arrays["g0"]), jnp.asarray(arrays["g1"]))
    return {"m0": np.asarray(m0), "r0": np.asarray(r0),
            "m1": np.asarray(m1), "r1": np.asarray(r1)}


def main(argv) -> int:
    task, src, dst = argv
    with np.load(src) as f:
        arrays = dict(f)
    spec = json.loads(str(arrays.pop("spec")))
    out = {"head_layouts": head_layouts,
           "compressed_mean": compressed_mean}[task](spec, arrays)
    np.savez(dst, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
