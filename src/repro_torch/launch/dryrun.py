"""Dry run: one (arch x shape) step on the production mesh, per-device
memory, FLOPs and collective traffic -- the reference's
``repro.launch.dryrun`` on ``DTensor``s.

The reference lowers and compiles the step on 512 placeholder CPU devices
and reads XLA's analyses.  Here one process joins a ``fake`` process group
of 256 ranks (512 with ``--multi-pod``), builds the 16 x 16 (2 x 16 x 16)
mesh, turns the cell's inputs (:func:`repro_torch.launch.specs.
input_specs`) into ``DTensor``s whose local shards are fake tensors, and
runs the step once under the activation rules, through
:class:`~repro_torch.launch.op_analysis.OpAnalysis`.  Nothing is
allocated on any device and no step computes a number: like the
reference's, this is a placeholder run, not a CPU fallback.  Steps route
as the reference's dry run on its CPU devices (``route_as("cpu")``, the
plain backends): no kernel is reached.

Result keys are the reference's, so one reader takes both packages' files;
``lower_s`` / ``compile_s`` give way to ``trace_s`` (the step's one run)
and ``xla_cost_analysis_raw`` to ``flop_counter_global``
(``FlopCounterMode`` over the global view: every product counted at its
global size once).  The memory columns, per device:

  * ``argument_bytes_per_device``: the local bytes of the step's inputs
    that it reads (as ``jit`` prunes an unused argument: an embeddings-
    input model's token table, a Mamba decode's positions);
  * ``output_bytes_per_device``: the local bytes of its outputs;
  * ``alias_bytes_per_device``: outputs that share storage with an input
    (the port updates the cache, the parameters and the moments in place
    where the reference donates them);
  * ``temp_bytes_per_device``: the peak of live local bytes the step
    allocated beyond its arguments.

The roofline uses one H100 SXM's published peaks: dense bf16 989e12
FLOP/s, HBM 3.35e12 B/s, NVLink 450e9 B/s a direction.  256 ranks span 32
nodes of 8 cards, and collectives between nodes run slower than NVLink, so
``collective_s`` is a lower bound.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape decode_32k [--multi-pod] [--spls] [--n-micro N] [--out f.json]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
from typing import Optional

import torch

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "run_cell", "analyze_step",
           "spls_config", "fake_group", "main"]

# one H100 SXM (NVIDIA's data sheet; dense, at its 700 W limit)
PEAK_FLOPS = 989e12          # bf16 FLOP/s
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction
# a plain tensor of more than this is a global one the step made outside
# the shards (a device would hold every byte of it): the run stops there
_MAX_PLAIN_BYTES = 1 << 30


@contextlib.contextmanager
def fake_group(world: int):
    """The default process group on the ``fake`` backend (one process,
    ``world`` ranks), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


# what ``DTensor``'s planner's ``get_next_state`` may read of its planner
# for :func:`_memoized_redistribute_planner` to memoize it: the state in
# the memo's key, and the class's stateless helpers
_PLANNER_STATE = ("tensor_dimension", "cost_function",
                  "strided_shard_placements_in_target",
                  "partial_reduce_ops_in_target")
_PLANNER_HELPERS = ("DistState", "_to_tuple")


def _self_reads(fn) -> Optional[set]:
    """The attributes that ``fn`` reads of its first argument, ``self``;
    None where it may do more with ``self`` than read an attribute of it
    (store one, hand it to a closure, pass it on)."""
    import dis

    code = fn.__code__
    if "self" in code.co_cellvars:
        return None
    reads, prev = set(), None
    for ins in dis.get_instructions(fn):
        if prev is not None and prev.opname.startswith("LOAD_FAST") \
                and prev.argval == "self":
            if ins.opname != "LOAD_ATTR":
                return None
            reads.add(ins.argval)
        prev = ins
    return reads


@contextlib.contextmanager
def _memoized_redistribute_planner():
    """Inside the block, each expansion of ``DTensor``'s redistribution
    planner is memoized; on exit the planner is as it was.

    To cost an op's candidate layouts ``DTensor`` plans the redistribution
    from an input's layout to each candidate's; where a layout holds a
    strided shard it searches the graph of layouts (Dijkstra, one search a
    pair).  On the 3-axis multi-pod mesh the graph is large and each
    search expands the same states again: one train step's planning took
    hours of host time.  Here a planner expands each state once, keyed by
    the planner and everything the expansion reads of it
    (:data:`_PLANNER_STATE`: the target's strided shards and partial
    reductions it has seen among them), and hands the same dict back: the
    same states, costs and order, so the same plans
    (``test_memoized_planner_gives_the_same_plans``).  A torch whose
    ``get_next_state`` reads anything else of its planner is left as it
    is."""
    try:
        from torch.distributed.tensor._redistribute import (
            DTensorRedistributePlanner as Planner)
    except ImportError:
        yield
        return
    expand = Planner.__dict__.get("get_next_state")
    reads = None if expand is None else _self_reads(expand)
    if reads is None or not reads <= {*_PLANNER_STATE, *_PLANNER_HELPERS}:
        yield
        return
    memo = {}

    def get_next_state(self, placements, shard_order):
        key = (self, tuple(placements), shard_order,
               *(frozenset(v) if isinstance(v, set) else v
                 for v in (getattr(self, k) for k in _PLANNER_STATE)))
        got = memo.get(key)
        if got is None:
            got = memo[key] = expand(self, placements, shard_order)
        return got

    Planner.get_next_state = get_next_state
    try:
        yield
    finally:
        Planner.get_next_state = expand


def _sharded(tree, fake_mode, unit: frozenset):
    """:class:`~repro_torch.launch.specs.ShardedMeta` leaves -> ``DTensor``s
    over fake local shards, replicated on the ``unit`` mesh axes
    (:func:`_unit_axes`).  A 0-d leaf (the optimizer's step count) is a
    real zero, since the learning-rate schedule reads it."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.specs import ShardedMeta
    from repro_torch.tree import tree_map

    def one(s):
        if not isinstance(s, ShardedMeta):
            return s
        meta = s.tensor
        if meta.dim() == 0:
            t = torch.zeros((), dtype=meta.dtype)
        else:
            with fake_mode:
                t = torch.empty(meta.shape, dtype=meta.dtype)
        mesh = s.sharding.mesh
        pl = tuple(Replicate() if a in unit else p
                   for a, p in zip(mesh.mesh_dim_names, s.placements))
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return tree_map(one, tree)


def _unit_axes(mesh) -> frozenset:
    """The mesh axes of size 1 (a one-rank or data-only mesh).  The dry run
    binds nothing to them, in its inputs and its activation rules alike: a
    dimension there stays replicated -- the same layout, whose views
    ``DTensor`` never has to move."""
    from repro_torch.sharding import mesh_axis_sizes

    return frozenset(a for a, n in mesh_axis_sizes(mesh).items() if n == 1)


def _locals(tree) -> list:
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import leaves

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(ts) -> int:
    seen, n = set(), 0
    for t in ts:
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            n += t.numel() * t.element_size()
    return n


def _train_args(cfg, specs, fake_mode, unit):
    from repro_torch.launch.specs import ShardedMeta
    from repro_torch.models import abstract_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding.rules import opt_state_sharding
    from repro_torch.tree import tree_map

    opt = adamw_init(AdamWConfig(), abstract_params(cfg))
    oshd = opt_state_sharding(specs["param_sharding"], opt)
    opt = tree_map(ShardedMeta, opt, oshd)
    return _sharded((specs["params"], opt, specs["batch"]), fake_mode, unit)


def analyze_step(cfg, shape, mesh, n_micro: Optional[int] = None,
                 donate: bool = True, trip_count: bool = True) -> dict:
    """Run ``cfg``'s step of ``shape`` (a :class:`~repro_torch.configs.
    base.ShapeCfg`) once on ``DTensor`` inputs over ``mesh`` (a process
    group must span it) and return the counts: ``kind``, ``chips``,
    ``trace_s``, ``n_micro`` (train), ``memory``, ``stats`` (the keys of
    :func:`~repro_torch.launch.op_analysis.parse_op_stats`) and
    ``flop_counter_global``.  ``n_micro`` fixes the microbatch size of a
    train step (default the config's, as the reference's).  Without
    ``donate`` the step updates copies of the donated inputs (cache;
    parameters and moments), so no output aliases an input.  With
    ``trip_count`` (the default) a loop of like iterations
    (:func:`repro_torch.loops.scan`: the microbatches, the planner's row
    blocks and bisection steps, the chunked attention's KV chunks) runs
    its first iteration only, counted once per iteration, as the
    reference counts a ``while`` body; without, every iteration runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.device import route_as
    from repro_torch.launch.op_analysis import OpAnalysis, parse_op_stats
    from repro_torch.launch.specs import input_specs
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, make_train_step)
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.sharding import mesh_axis_sizes
    from repro_torch.sharding.logical import axis_rules
    from repro_torch.sharding.rules import activation_rules
    from repro_torch.tree import tree_map

    sizes = mesh_axis_sizes(mesh)
    n_chips = math.prod(sizes.values())
    unit = _unit_axes(mesh)
    rules = {name: ax for name, ax in activation_rules(mesh).items()
             if ax is None or not unit.issuperset(
                 (ax,) if isinstance(ax, str) else ax)}
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    specs = input_specs(cfg, shape, mesh)
    kind = specs["kind"]
    out = {"kind": kind, "chips": n_chips}
    if kind == "train":
        mb = n_micro or (cfg.microbatch or {}).get(shape.name, 1)
        data_par = n_chips // sizes.get("model", 1)
        per_shard = max(shape.global_batch // data_par, 1)
        n_acc = max(per_shard // mb, 1)
        out["n_micro"] = n_acc
        step = make_train_step(cfg, AdamWConfig(moment_dtype=None),
                               warmup_cosine(3e-4, 100, 10000),
                               n_micro=n_acc)
        args = _train_args(cfg, specs, fake_mode, unit)
        donated = (0, 1)
    elif kind == "prefill":
        step = make_prefill_step(cfg)
        args = _sharded((specs["params"], specs["inputs"]), fake_mode,
                        unit)
        donated = ()
    else:
        step = make_serve_step(cfg)
        args = _sharded((specs["params"], specs["cache"], specs["tokens"],
                         specs["pos"]), fake_mode, unit)
        donated = (1,)
    arg_locals = _locals(args)

    glob = FlopCounterMode(display=False)
    oa = OpAnalysis(fake_mode, max_plain_bytes=_MAX_PLAIN_BYTES,
                    trip_count=trip_count, global_counter=glob)
    oa.add_arguments(arg_locals)
    t0 = time.perf_counter()
    with _memoized_redistribute_planner(), route_as("cpu"), \
            axis_rules(rules, mesh), implicit_replication(), oa, glob:
        # ``glob`` innermost sees each DTensor op whole; ``oa`` the local
        # ops that DTensor then issues
        if not donate:
            args = tuple(tree_map(torch.clone, a) if i in donated else a
                         for i, a in enumerate(args))
        res = step(*args)
        del args
    trace_s = time.perf_counter() - t0

    res_locals = _locals(res)
    arg_keys = {t.untyped_storage()._cdata for t in arg_locals}
    alias = [t for t in res_locals if t.untyped_storage()._cdata in arg_keys]
    out.update({
        "trace_s": round(trace_s, 1),
        "memory": {
            "argument_bytes_per_device": oa.read_bytes(arg_locals),
            "output_bytes_per_device": _bytes(res_locals),
            "temp_bytes_per_device": oa.peak_bytes,
            "alias_bytes_per_device": _bytes(alias),
        },
        "stats": parse_op_stats(oa.stats),
        "flop_counter_global": float(glob.get_total_flops()),
    })
    return out


def spls_config(cfg):
    """``cfg`` with the dry run's SPLS configuration (the reference's
    ``--spls``: the paper's thresholds, q / kv capacities 0.5 / 0.75), if
    it has attention to plan."""
    if not cfg.has_attn:
        return cfg
    from repro_torch.core.spls import SPLSConfig
    return dataclasses.replace(cfg, spls=SPLSConfig(
        enabled=True, k_ratio=0.12, s_threshold=0.6, f_threshold=6,
        window=8, causal=cfg.causal,
        q_capacity_ratio=0.5, kv_capacity_ratio=0.75))


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             spls: bool = False, n_micro: Optional[int] = None,
             donate: bool = True) -> dict:
    from repro_torch.configs.registry import get_config, get_shape
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = f"{'2x' if multi_pod else ''}16x16"
    if shape_name not in cfg.supported_shapes:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "spls": spls, "skipped": True,
                "reason": "unsupported shape (see DESIGN.md)"}
    if spls:
        cfg = spls_config(cfg)

    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        a = analyze_step(cfg, shape, mesh, n_micro, donate)

    stats = a["stats"]
    flops_dev = stats["dot_flops"]
    bytes_dev = stats["traffic_bytes"]
    coll_dev = stats["collective_bytes"]
    model_flops = _model_flops(cfg, shape)
    result = {
        "arch": arch, "shape": shape_name, "kind": a["kind"],
        "mesh": mesh_name, "chips": a["chips"], "spls": spls,
        "skipped": False, "trace_s": a["trace_s"],
        "memory": a["memory"],
        "hlo_flops_per_device": flops_dev,
        "hlo_bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collective_breakdown": {k[5:]: v for k, v in stats.items()
                                 if k.startswith("coll:")},
        "flop_counter_global": a["flop_counter_global"],
        "model_flops_total": model_flops,
        "roofline": {
            "compute_s": flops_dev / PEAK_FLOPS,
            "memory_s": bytes_dev / HBM_BW,
            "collective_s": coll_dev / NVLINK_BW,
        },
    }
    if "n_micro" in a:
        result["n_micro"] = a["n_micro"]
    terms = result["roofline"]
    result["roofline"]["dominant"] = max(terms, key=terms.get)
    total = flops_dev * a["chips"]
    result["model_flops_ratio"] = model_flops / total if total else None
    return result


def _model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D for MoE; decode: D=B
    tokens (the reference's formula)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--spls", action="store_true",
                    help="enable the paper's SPLS sparsity in the step")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    res = run_cell(args.arch, args.shape, args.multi_pod, args.spls,
                   args.n_micro)
    js = json.dumps(res, indent=2, default=str)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)
    return 0 if (res.get("skipped") or res.get("trace_s") is not None) else 1


if __name__ == "__main__":
    sys.exit(main())
