"""Mesh-aware sharding rules for parameters, optimizer state, activations,
KV caches and input batches (the reference's ``repro.sharding.rules``).

Parallelism layout:
  * ``data`` (x ``pod``) -- data parallelism over the batch; gradients
    all-reduce over it.  ``pod`` is an outer data axis (cross-pod
    gradient reduction).
  * ``model`` -- Megatron-style tensor parallelism: attention heads, FFN
    hidden, MoE experts, Mamba inner channels, vocab.

Every binding is divisibility-guarded: a dimension that does not divide by
the mesh-axis size replicates (``kv_heads=8`` on a 16-way model axis,
``vocab=50280`` on mamba2).  For decode shapes whose batch is too small to
shard, the KV cache's sequence axis takes the mesh axes (sequence
parallelism, as flash decode splits a row's cache).

Everything works on meta tensors (:func:`repro_torch.models.
abstract_params`, :func:`repro_torch.models.abstract_cache`) and returns
:class:`~repro_torch.sharding.logical.NamedSharding` trees.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.tree import tree_map, tree_map_with_path
from .logical import NamedSharding, PartitionSpec as P, is_dtensor, \
    logical_to_mesh, mesh_axis_sizes

__all__ = ["activation_rules", "param_sharding", "cache_sharding",
           "batch_sharding", "opt_state_sharding", "DATA_AXES",
           "unshard_fsdp"]


def DATA_AXES(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def activation_rules(mesh) -> Dict[str, Any]:
    """Logical -> mesh rules installed around model code."""
    return {
        "batch": DATA_AXES(mesh),
        "seq": None,
        # residual-stream activations saved at layer boundaries shard their
        # sequence over the model axis (Megatron sequence parallelism)
        "act_seq": "model",
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "qgroups": "model",  # shards when kv_heads cannot (GQA, kv < |model|)
        "ffn": "model",
        "experts": "model",
        "vocab": "model",
        "inner": "model",
    }


def _param_logical(path_str: str, ndim: int, fsdp: bool):
    """Logical axes of one parameter leaf, by its trailing name and rank.
    With ``fsdp`` every large weight also binds one non-TP dimension to
    the "fsdp" logical axis (the in-pod data axis, ZeRO-3 style)."""
    name = path_str.split("/")[-1]
    F = "fsdp" if fsdp else None
    table = {
        "embed": ("vocab", F),
        "lm_head": (F, "vocab"),
        "wq": (F, "kv_heads", "qgroups", None),
        "wk": (F, "kv_heads", None),
        "wv": (F, "kv_heads", None),
        "wo": ("kv_heads", "qgroups", None, F),
        "w_up": ("experts", F, "ffn") if ndim >= 4 else (F, "ffn"),
        "w_gate": ("experts", F, "ffn") if ndim >= 4 else (F, "ffn"),
        "w_down": ("experts", "ffn", F) if ndim >= 4 else ("ffn", F),
        "router": (None, None),
        "in_proj": (F, "inner"),
        "out_proj": ("inner", F),
        "conv_w": ("inner", None),
        "conv_b": ("inner",),
        "gate_norm": ("inner",),
    }
    names = table.get(name)
    if names is None:
        return (None,) * ndim  # norms, A_log, D, dt_bias, ... replicate
    # left-pad with None for the stacked period axis
    return (None,) * (ndim - len(names)) + tuple(names)


def param_sharding(cfg, mesh, abstract_params: Any) -> Any:
    """:class:`NamedSharding` tree matching ``abstract_params``."""
    rules = activation_rules(mesh)
    rules["fsdp"] = "data"  # ZeRO shards stay inside a pod

    def assign(path, leaf):
        names = _param_logical("/".join(str(k) for k in path), leaf.ndim,
                               cfg.fsdp)
        return NamedSharding(mesh, logical_to_mesh(names, leaf.shape, rules,
                                                   mesh))

    return tree_map_with_path(assign, abstract_params)


def unshard_fsdp(t):
    """A parameter as a step computes with it: a ``DTensor``'s ZeRO shards
    over the in-pod data axis (the ``fsdp`` binding above) gathered, its
    model-axis shards kept -- the all-gather XLA places before each use.
    A plain tensor comes back unchanged."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    names = t.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if names[i] == "data" and p.is_shard() else p
               for i, p in enumerate(t.placements))
    if pl == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def opt_state_sharding(param_shardings: Any, opt_state_abstract: Any) -> Any:
    """Moments share their parameter's sharding; the count replicates."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.tree import leaves

    mesh = leaves(param_shardings)[0].mesh
    return OptState(count=NamedSharding(mesh, P()), mu=param_shardings,
                    nu=param_shardings)


def _n_data(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in DATA_AXES(mesh):
        n *= sizes[a]
    return n


def batch_sharding(mesh, global_batch: int) -> NamedSharding:
    """Batch axis over (pod, data) when divisible, else replicated."""
    if global_batch % _n_data(mesh) == 0:
        return NamedSharding(mesh, P(DATA_AXES(mesh)))
    return NamedSharding(mesh, P())


def _shard_batch_or_seq(mesh, batch: int, seq: int, head_div: bool,
                        batch_pos: int, head_pos: int, seq_pos: int,
                        ndim: int) -> P:
    """Decode-cache layout: batch over the data axes when it divides;
    otherwise (and for the model axis when the heads do not divide) the
    sequence takes those axes."""
    sizes = mesh_axis_sizes(mesh)
    data_axes = DATA_AXES(mesh)
    n_data = _n_data(mesh)
    spec: list = [None] * ndim
    seq_axes = []
    if batch % n_data == 0 and batch >= n_data:
        spec[batch_pos] = data_axes if len(data_axes) > 1 else data_axes[0]
    else:
        seq_axes.extend(data_axes)  # tiny batch: give data axes to seq
    if head_div:
        spec[head_pos] = "model"
    else:
        seq_axes.append("model")
    if seq_axes:
        n_seq = 1
        for a in seq_axes:
            n_seq *= sizes[a]
        if seq % n_seq == 0:
            spec[seq_pos] = (tuple(seq_axes) if len(seq_axes) > 1
                             else seq_axes[0])
    return P(*spec)


def cache_sharding(cfg, mesh, abstract_cache: Any, batch: int,
                   max_len: int) -> Any:
    """Shardings of the stacked decode cache: KV ``(periods, B, KV, S,
    Dh)``, Mamba conv ``(periods, B, Ch, W)``, Mamba SSD state ``(periods,
    B, H, Pd, N)``."""
    n_model = mesh_axis_sizes(mesh).get("model", 1)

    def assign(leaf):
        if leaf.ndim == 5 and leaf.shape[3] == max_len:      # KV cache
            kv_div = (cfg.n_kv_heads % n_model == 0
                      and cfg.n_kv_heads >= n_model)
            spec = _shard_batch_or_seq(mesh, batch, max_len, kv_div,
                                       batch_pos=1, head_pos=2, seq_pos=3,
                                       ndim=5)
        elif leaf.ndim == 4 and \
                leaf.shape[2] == cfg.d_inner + 2 * cfg.ssm_state:
            # conv state: channels over model when divisible
            spec = P(None, None,
                     "model" if leaf.shape[2] % n_model == 0 else None, None)
        elif leaf.ndim == 5:                                  # SSD state
            spec = P(None, None,
                     "model" if leaf.shape[2] % n_model == 0 else None, None,
                     None)
        else:
            spec = P()
        return NamedSharding(mesh, spec)

    return tree_map(assign, abstract_cache)
